#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nas_3d_unet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed as JSON lines:
  1. device: CUDA must be present (else exit 2); the card's name and power
     limit from nvidia-smi.
  2. build: compiles nas_3d_unet_tpu_torch/csrc/*.cu from scratch (one
     nvcc per source, in parallel, sm_90a) and times it.
  3. kernels: the serving kernels in fp32 against their plain PyTorch twins
     at every geometry the flagship net gives them (batch 2): K1
     conv3x3x3_stats (the FMA conv tile with its moments epilogue; plus a
     dilation-2 case, and off the path K1_EXTRA's ragged and odd-channel
     rows), K2 gemm_stats (the voxel-row FMA tile with its per-tile
     moments; with `device_ms` and `host_ms`, and those of the matmul)
     and K5a moments; and K1-dx conv3x3x3 in fp32 (on no path: serving
     runs no backward) at K1DX_TRAIN's and K1DX_EXTRA's geometries, batch
     2.
  4. slice: the flagship derived net (default_genotype(3), base 16, depth
     3, fp32, random weights from --seed through the flax bridge) serves
     synthetic 160x192x152x4 patients through SlidingWindowPredictor +
     predict_records (128^3 windows, overlap 0.5, patch batch 2).  Checks:
     labels uint8 in {0,1,2,4}, finite Dice, launch counts equal to
     (launches per forward, counted from the modules) x (forwards), one
     patch's logits against the same net forced onto the twins, and that
     the shapes the net hands the kernels are exactly phase 3's.
  5. train_kernels: the training kernels against their twins at every
     geometry one flagship train step gives them (bf16, microbatch 1): K1
     bf16 (the tensor-core conv with its moments epilogue; also off the
     path at dilation 2 at 64^3, at a ragged 19x24x21 volume at 32 -> 32
     and dilation 1 and 2, and at Cin 4 -> Cout 12 ragged), K1-dx (the
     no-moments conv, on the tensor cores, checked against the twin conv
     with the flip-transposed kernel; also off the path at the ragged
     volume and at Cin 4 -> Cout 12), K2 bf16 (the tensor-core GEMM with
     its moments epilogue; also off the path at the ragged volume's V =
     9576 rows at 32 -> 32, K 40 -> N 24, and K 12 -> N 7, the scalar
     copies), K5a moments and K5b weighted_sums in bf16 and fp32.  bf16
     K1/K2 moments are also held against float64 sums of the y the kernel
     stored.
  6. train: the flagship in bf16 trained as bench.py's bench_train does
     (batch 2 of 128^3, microbatch 1, AdamW 3e-4 / 1e-4, flips and
     intensity jitter), synthetic x and y from --seed.  One step's
     gradients on the kernel path against the twin path (per leaf: the
     relative L2 distance and the cosine; grad_parity.py holds the
     readings behind the limits),
     the shapes the step hands the kernels against phase 5's geometries,
     then 3 warm-up and 5 timed steps: patches/s, the loss per step (all
     finite), peak device memory, and launches equal to (per step, counted
     from the modules) x 5.
  7. pallas_kernels: the `use_pallas` configuration's kernels against their
     twins at every geometry it gives them: K6 conv3d (stride 1 and 2) in
     fp32 at batch 2 (the FMA conv tile) and in bf16 at batch 1 (the
     tensor-core conv), plus off the path a
     dilation-2 and a bias+ReLU case, the ragged volume at stride 1 and
     2, Cin 4 -> Cout 12 at stride 1 and at stride 2 with dilation 2, and
     stride 2 with dilation 2; K7 pointwise_conv (bf16 on the tensor
     cores; also off the path at the ragged volume, K 12 -> N 7 (the
     scalar copies), and bias+ReLU with a bias of scale 0.5 and one of
     scale 37, whose bf16 rounding matters); K4 conv_transpose2x (bf16 on
     the tensor cores, depth-to-space store; also off the path at the
     ragged volume at 16 -> 16, 16 -> 24 (N = 192 > 128) with ReLU and
     12 -> 5 (scalar), and 64 -> 64 with ReLU); K7 in fp32 runs the
     voxel-row FMA tile, K4 in fp32 the FMA template; K7's and K4's
     records, as K2's, also hold their device ms and host ms
     (`device_ms`: the calls queued behind a spin kernel, so the device's
     time and the host's are each timed alone; the call's `ms` holds
     both), and their library call's, summed per unit with K2's in the
     line "pallas_device_split";
     K3's apply (fp32 and bf16) and dx (bf16); K5b masked by y > 0 (K3's
     backward sums, bf16); K5a at the configuration's own geometries; and
     off the path every K5 form in both dtypes at K5_EXTRA (the ragged
     volume at C 12 and 7, the scalar loads, and inputs one element into
     their buffers, not 16-byte aligned).  Every K5 record (phases 3, 5
     and 7) holds the float64 check, the same bits twice, the plan, the
     partials' share of one input's bytes, and the call's and the library
     call's device ms and host ms, summed per unit in the line
     "stats_device_split";
  8. pallas_slice: phase 4 with `DerivedNet(use_pallas=True)` (edge convs
     on K6/K7/K4, every GroupNorm on K3), the same patients and checks,
     against the twin path of that configuration.
  9. pallas_train: phase 6 with the bf16 `use_pallas` net: gradient
     parity with its twin path (limits from `grad_parity.py --use-pallas`),
     3 warm-up and 5 timed steps, patches/s, losses, peak memory, launch
     counts.
 10. probes: E1 `copy_rows` (a 64 MiB bf16 copy) at every rows-per-block
     of the probe, bit-equal to its twin, GB/s and share of 3.35 TB/s
     (library: `dst.copy_`, and the `x + 1` pass); E2's five variants of
     K1's shifted-GEMM conv at the level-0 geometry (NB = 128), nodot
     bit-equal and the others within 2 bf16 ulps of the fp32-accumulated
     twin, TFLOP/s against the bound; the HMMA instructions in each E2
     kernel's SASS (none in nodot, some in every other); then the two
     probes' entry points (`main()`), with the launch counts read.
 11. sass: the kernels K1, K1-dx and K6 in bf16 launch (read from a
     `torch.profiler` trace) are the tensor-core conv's
     (`conv_mma_kernel`), K2's, K7's and K4's in bf16 the tensor-core
     GEMM's (`gemm_mma_kernel`), each instantiation of both with HMMA in
     its SASS; K1, K1-dx and K6 (stride 1 and 2) in fp32 launch the FMA
     conv tile (`conv_fma_kernel`), every instantiation of which has FFMA
     and no HMMA in its SASS; K2 and K7 in fp32 launch the voxel-row FMA
     tile (`gemm_fma_kernel`), every instantiation of which has FFMA and
     no HMMA; K4 in fp32, alone, launches the FMA template
     (`gemm_moments_kernel`), none of whose instantiations has HMMA and
     none of which is bf16; the conv tiles' plans and brick counts equal
     `ops/conv_mma.py`'s and `ops/conv_fma.py`'s mirrors at every K1,
     K1-dx and K6 geometry checked, the GEMM tiles' plans
     `ops/gemm_mma.py`'s at every K2, K7 and K4 geometry and
     `ops/gemm_fma.py`'s at every K2 and K7 geometry; and one call of each
     K5 form in both dtypes, aligned and not, in one trace, launches
     exactly one kernel, `stats_sums_kernel` with the planned loads, and
     `stats.cu` refuses a plan with any field one off `ops/stats.py`'s.
Then the nvidia-smi line, the kernels summary line and, last,
`{"ok": true, "device": {...}}`.  In the kernels line a serving kernel's
`ms`, `plain_ms`, `library_ms` and `bound_ms` are one flagship forward's
worth at batch 2, a training kernel's one train step's worth: the sum over
geometries of launches per unit x time per launch; E1's one sweep (a copy
at each rows-per-block), an E2 variant's one call.  `plain_ms` is the twin,
`library_ms` one PyTorch call computing the same function (F.conv3d, a
matmul, F.conv_transpose3d, F.group_norm with its statistics,
native_group_norm_backward for K3 dx and K5b, var_mean for K5a,
`dst.copy_` for E1, the gather for E2 nodot, for the other E2 variants
the matmul of a pre-built concat of their slices; null where none does),
`bound_ms` the larger of bytes / 3.35 TB/s and flops / peak (67 TFLOP/s
fp32, 989 bf16; an H100 SXM at 700 W;
`nas_3d_unet_tpu_torch/utils/bounds.py`).  Any failed check raises: the script never exits 0 after a failure.  Imports
nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from nas_3d_unet_tpu_torch.utils.bounds import bound_ms

SRC_PGEMM = "nas_3d_unet_tpu_torch/csrc/pgemm.cu"
SRC_STATS = "nas_3d_unet_tpu_torch/csrc/stats.cu"
SRC_CONV = "nas_3d_unet_tpu_torch/csrc/conv3d.cu"
SRC_GN = "nas_3d_unet_tpu_torch/csrc/groupnorm.cu"
SRC_PROBES = "nas_3d_unet_tpu_torch/csrc/probes.cu"
SRC_MMA = "nas_3d_unet_tpu_torch/csrc/conv_mma.cuh"   # in pgemm.cu, conv3d.cu
SRC_GMMA = "nas_3d_unet_tpu_torch/csrc/gemm_mma.cuh"  # in pgemm.cu, conv3d.cu
SRC_FMA = "nas_3d_unet_tpu_torch/csrc/conv_fma.cuh"   # in pgemm.cu, conv3d.cu
SRC_GFMA = "nas_3d_unet_tpu_torch/csrc/gemm_fma.cuh"  # in pgemm.cu, conv3d.cu
PG_VARIANTS = ("nodot", "c6", "full", "mt4", "fold1536")
SOURCES = {"moments": SRC_STATS, "weighted_sums": SRC_STATS,
           "weighted_sums_masked": SRC_STATS, "group_norm_apply": SRC_GN,
           "group_norm_dx": SRC_GN, "conv3d": SRC_CONV,
           "pointwise_conv": SRC_CONV, "conv_transpose2x": SRC_CONV,
           "copy_rows": SRC_PROBES,
           **{f"pg_{v}": SRC_PROBES for v in PG_VARIANTS},
           "conv3x3x3_bf16": SRC_MMA, "conv3d_bf16": SRC_MMA,
           "conv3x3x3_stats_bf16": SRC_MMA, "gemm_stats_bf16": SRC_GMMA,
           "pointwise_conv_bf16": SRC_GMMA, "conv_transpose2x_bf16": SRC_GMMA,
           "conv3x3x3_f32": SRC_FMA, "conv3d_f32": SRC_FMA,
           "conv3x3x3_stats_f32": SRC_FMA, "gemm_stats_f32": SRC_GFMA,
           "pointwise_conv_f32": SRC_GFMA}
# the rest: SRC_PGEMM (by kernel name, else by its name without the dtype)
REPLACES = {
    "conv3x3x3_stats": "nas_3d_unet_tpu/ops/pallas/pgemm.py:174",  # conv_pgemm
    "conv3x3x3": "nas_3d_unet_tpu/ops/packed.py:497",      # its dx use
    "gemm_stats": "nas_3d_unet_tpu/ops/pallas/pgemm.py:311",
    "moments": "nas_3d_unet_tpu/ops/pallas/stats.py:65",
    "weighted_sums": "nas_3d_unet_tpu/ops/pallas/stats.py:87",
    # K3 (groupnorm.py:184 group_norm): its apply, dx and backward sums
    "group_norm_apply": "nas_3d_unet_tpu/ops/pallas/groupnorm.py:124",
    "group_norm_dx": "nas_3d_unet_tpu/ops/pallas/groupnorm.py:144",
    "weighted_sums_masked": "nas_3d_unet_tpu/ops/pallas/groupnorm.py:109",
    "conv3d": "nas_3d_unet_tpu/ops/pallas/conv3d.py:201",             # K6
    "pointwise_conv": "nas_3d_unet_tpu/ops/pallas/conv3d.py:279",     # K7
    "conv_transpose2x": "nas_3d_unet_tpu/ops/pallas/conv3d.py:356",   # K4
    "copy_rows": "experiments/r3_dma_probe.py:28",                    # E1
    **{f"pg_{v}": "experiments/r3_pg_variants.py:129"                 # E2
       for v in PG_VARIANTS},
}

# Serving, fp32, batch 2, launches per flagship forward.
# K1: (Cin, Cout, volume edge, dilation, launches)
K1_GEOMS = [(4, 48, 128, 1, 1),      # stem
            (32, 32, 64, 1, 5),      # down cell 1 (2), up cell level 1 (3)
            (64, 64, 32, 1, 5),      # down cell 2 (2), up cell level 2 (3)
            (128, 128, 16, 1, 2),    # down cell 3
            (16, 16, 128, 1, 3),     # up cell level 0
            (32, 32, 64, 2, 0)]      # dil_conv3: off the flagship path
# K2: (K, N, volume edge, launches)
K2_GEOMS = [(48, 32, 128, 2),        # down cell 1: both inputs (the stem)
            (96, 64, 64, 1),         # down cell 2: s1
            (192, 128, 32, 1),       # down cell 3: s1
            (192, 64, 32, 1), (384, 64, 16, 1),    # up cell level 2
            (96, 32, 64, 1), (192, 32, 32, 1),     # up cell level 1
            (48, 16, 128, 1), (96, 16, 64, 1)]     # up cell level 0
# K5a: (C, volume edge, launches) -- the GroupNorms of the plain producers
# (stride-2 convs, SepConv, UpTranspose)
K5A_GEOMS = [(16, 128, 3), (32, 64, 5), (64, 32, 5), (64, 64, 2),
             (128, 16, 2), (128, 32, 2), (256, 16, 1)]
BATCH = 2

# Training, bf16, microbatch 1 (batch 1 per kernel call), launches per
# train step (2 microbatches): the forward counts twice, dx skips the stem.
K1_TRAIN = [(ci, co, v, d, 2 * n) for ci, co, v, d, n in K1_GEOMS]
K1DX_TRAIN = [(co, ci, v, d, 2 * n) for ci, co, v, d, n in K1_GEOMS
              if ci != 4]            # dy (Cout) -> dx (Cin); no stem dx
# off the path (the tensor-core conv's masking): a ragged, non-cubic
# volume (D, H, W), and odd channel counts
RAGGED = (19, 24, 21)
K1DX_EXTRA = [(32, 32, RAGGED, 1, 0), (4, 12, RAGGED, 1, 0)]
# K1's moments masking at the ragged edge (dilation 2 at 64^3 is K1_TRAIN's
# dil_conv3 row)
K1_EXTRA = [(32, 32, RAGGED, 1, 0), (32, 32, RAGGED, 2, 0),
            (4, 12, RAGGED, 1, 0)]
K2_TRAIN = [(k, n, v, 2 * c) for k, n, v, c in K2_GEOMS]
# V = 9576 rows (not a multiple of the 128-row block); K and N multiples
# of 8 (16-byte copies) and not (scalar copies)
K2_EXTRA = [(32, 32, RAGGED, 0), (40, 24, RAGGED, 0), (12, 7, RAGGED, 0)]
K5A_TRAIN = [(c, v, 2 * n) for c, v, n in K5A_GEOMS]
# K5 off the path, every form in both dtypes at batch 2: (C, volume,
# element offset of the inputs).  C 12 and 7 at the ragged volume take the
# scalar instantiation (bf16 rows of 24 and 14 bytes; fp32 C 12 is three
# 16-byte loads a row), and the views 1 element into their buffers
# (contiguous, not 16-byte aligned) take it at C 16 and 48
K5_EXTRA = [(12, RAGGED, 0), (7, RAGGED, 0), (16, 32, 1), (48, RAGGED, 1)]
# K5b: every GroupNorm's backward, (C, volume edge, launches per step)
K5B_TRAIN = [(16, 64, 2), (16, 128, 14), (32, 32, 2), (32, 64, 22),
             (32, 128, 4), (48, 128, 2), (64, 16, 2), (64, 32, 22),
             (64, 64, 6), (128, 16, 8), (128, 32, 6), (256, 16, 2)]
MICRO = 1

# The use_pallas configuration (phases 7-9), launches per forward at batch
# 2; a train step runs each twice at batch 1.  K1 runs for the stem alone
# (its input needs no dx), K2 at K2_GEOMS.
# K6: (Cin, Cout, input edge, stride, dilation, launches)
P_K6 = [(32, 32, 64, 1, 1, 5), (64, 64, 32, 1, 1, 5), (128, 128, 16, 1, 1, 2),
        (16, 16, 128, 1, 1, 3),
        (32, 32, 128, 2, 1, 1), (32, 64, 128, 2, 1, 1), (64, 64, 64, 2, 1, 1),
        (64, 128, 64, 2, 1, 1), (128, 128, 32, 2, 1, 1),
        (128, 256, 32, 2, 1, 1),
        (32, 32, 64, 1, 2, 0)]               # dil_conv3: off the path
P_K6_BIAS_RELU = (32, 32, 64, 1, 1)          # the fused epilogue, off the path
P_K6_EXTRA = [(32, 32, RAGGED, 1, 1, 0), (32, 32, RAGGED, 2, 1, 0),
              (4, 12, RAGGED, 1, 1, 0), (4, 12, RAGGED, 2, 2, 0),
              (32, 32, 64, 2, 2, 0)]         # ragged, odd channels, s2 d2
# K7: (C, volume edge, launches); K4: (C, input edge, launches)
P_K7 = [(32, 64, 3), (64, 32, 3), (128, 16, 1), (16, 128, 2)]
P_K4 = [(64, 16, 1), (32, 32, 1), (16, 64, 1)]
# off the path.  K7: (Cin, Cout, volume, bias scale or None: with a bias,
# also ReLU), the ragged volume, K 12 -> N 7 (scalar copies) and biases
# whose bf16 rounding matters (scale 37: a bf16 ulp of 0.25 against y of
# scale 1).  K4: (Cin, Cout, input volume, ReLU), the ragged volume, Cout
# 24 (N = 192: two column blocks), Cin 12 -> Cout 5 (scalar copies)
P_K7_EXTRA = [(32, 32, RAGGED, None), (12, 7, RAGGED, None),
              (32, 32, 64, 0.5), (32, 32, 32, 37.0)]
P_K4_EXTRA = [(16, 16, RAGGED, False), (16, 24, RAGGED, True),
              (12, 5, RAGGED, False), (64, 64, 16, True)]
# K3: (C, volume edge, GroupNorms): the 33 edge ops' and the 13 of the stem
# and the 1³ projections (on K1/K2/cuDNN moments); each is one apply
# forward, one masked K5b and one dx backward
P_K3 = [(16, 64, 1), (16, 128, 7), (32, 32, 1), (32, 64, 11), (32, 128, 2),
        (48, 128, 1), (64, 16, 1), (64, 32, 11), (64, 64, 3), (128, 16, 4),
        (128, 32, 3), (256, 16, 1)]
# K5a: the moments of the 35 GroupNorms whose producer emits none
P_K5A = [(16, 128, 6), (32, 64, 10), (64, 32, 10), (64, 64, 2), (128, 16, 4),
         (128, 32, 2), (256, 16, 1)]
P_K1 = [K1_GEOMS[0]]                         # the stem

# limits
Y_RTOL = Y_ATOL = 1e-4       # fp32 y: |k - t| <= atol + rtol·|t|
Y_ULPS = 2                   # bf16 y: 2 ulps of max(|t|, 2^-8)
Y_ULP_FLOOR = 2.0 ** -8
MOM_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}   # Σy², Σy/Σ|y|
STATS_RTOL = 1e-5            # K5a/K5b against float64, over Σ|terms|
LOGIT_ATOL = 1e-3
LABEL_AGREE = 0.999
# Set from grad_parity.py and phase 5 readings (H100, seeds 0-3): the
# sound kernels' worst against a planted fault's least, see PERF.md.
MOM_STORED_RTOL = 1e-6       # bf16 moments vs Σ stored y: 7.2e-8 / 8.2e-6
GRAD_REL_L2 = 0.35           # per leaf ‖g_k − g_t‖/‖g_t‖, max: 0.22 / 0.43
GRAD_REL_L2_MEDIAN = 0.08    # its median over the leaves: 0.042 / 0.16
GRAD_COS = 0.95              # per leaf cosine of g_k and g_t: 0.978 / 0.908
# use_pallas (grad_parity.py --use-pallas, H100, seeds 0-3 and a planted
# K3-dx fault), see PERF.md
P_GRAD_REL_L2 = 0.35
P_GRAD_REL_L2_MEDIAN = 0.08
P_GRAD_COS = 0.95
N_PATIENTS = 3               # timed patients, after one warm-up patient
SHAPE = (160, 192, 152)      # a cropped BraTS volume, as bench.py serves
PATCH, OVERLAP, PATCH_BATCH = (128, 128, 128), 0.5, 2
TRAIN_PATCH, TRAIN_BATCH = 128, 2
WARMUP_STEPS, TIMED_STEPS = 3, 5
AUGMENT = dict(flip_prob=0.5, intensity_shift=0.1, intensity_scale=0.1)

SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _y_check(yk, yt):
    """Kernel y against twin y: fp32 abs/rel limits, or bf16 ulps."""
    dy = (yk.float() - yt.float()).abs()
    ref = yt.float().abs()
    if yt.dtype == torch.bfloat16:
        e = torch.frexp(ref.clamp_min(Y_ULP_FLOOR))[1]
        ulp = torch.ldexp(torch.ones_like(ref), e - 8)
        return {"y_max_abs": dy.max().item(),
                "y_max_ulps": (dy / ulp).max().item(),
                "y_ok": bool((dy <= Y_ULPS * ulp).all())}
    return {"y_max_abs": dy.max().item(),
            "y_max_rel": (dy / ref.clamp_min(1e-30)).max().item(),
            "y_ok": bool((dy <= Y_ATOL + Y_RTOL * ref).all())}


def _moments_err(s1, s2, y):
    """Largest error of (Σy, Σy²) against float64 sums of y: Σy over its
    rounding scale Σ|y|, Σy² relative."""
    dims = tuple(range(1, y.dim() - 1))
    yd = y.double()
    t1, t2 = yd.sum(dims), (yd * yd).sum(dims)
    return max(((s1.double() - t1).abs() / yd.abs().sum(dims)).max().item(),
               ((s2.double() - t2).abs() / t2).max().item())


def _moments_check(s1k, s2k, s1t, s2t, yt, dtype, yk=None, y_unrounded=None):
    """The kernel's moments against the twin's (whose y rounds apart by up
    to an ulp).  In bf16 also against float64 sums of the kernel's own
    stored y, which isolates where the kernel rounds: a kernel that summed
    its fp32 accumulator would sit as far from them as sums of the
    unrounded y do (`moments_unrounded_y`, printed beside)."""
    dims = tuple(range(1, yt.dim() - 1))
    scale = yt.float().abs().sum(dims)
    rec = {"s1_max_over_scale": ((s1k - s1t).abs() / scale).max().item(),
           "s2_max_rel": ((s2k - s2t).abs() / s2t.abs()).max().item()}
    ok = max(rec.values()) <= MOM_RTOL[dtype]
    if yk is not None:
        rec["moments_stored_y"] = _moments_err(s1k, s2k, yk)
        rec["moments_unrounded_y"] = _moments_err(s1k, s2k, y_unrounded)
        rec["moments_stored_limit"] = MOM_STORED_RTOL
        ok = ok and rec["moments_stored_y"] <= MOM_STORED_RTOL
    rec["moments_ok"] = ok
    return rec


def _repeatable(fn, args, first):
    again = fn(*args)
    again = again if isinstance(again, tuple) else (again,)
    first = first if isinstance(first, tuple) else (first,)
    return all(torch.equal(a, b) for a, b in zip(first, again))


def _timings(kernel, twin, library, args):
    from nas_3d_unet_tpu_torch.utils.timing import cuda_ms

    return {"ms": cuda_ms(kernel, *args, iters=5, warmup=1),
            "plain_ms": cuda_ms(twin, *args, iters=5, warmup=1),
            "library_ms": (cuda_ms(library, *args, iters=5, warmup=1)
                           if library else None)}


def device_ms(fn, args, iters=20, spin_cycles=20_000_000):
    """(device ms, host ms) per call of `fn` (all the kernels it launches):
    the calls are queued behind a spin kernel (`torch.cuda._sleep`, ~10 ms
    at the H100's clock) that outlasts their launch on the host, so the
    events around them time the device alone, where the call's `ms` also
    holds the host's time; the host's wall clock over the same queued loop
    times the host alone (the launch path: wrapper, checks, allocation,
    ctypes).  Raises if the device caught up with the host (the spin too
    short to hide it)."""
    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    ahead = not start.query()       # still spinning: the host was ahead
    torch.cuda.synchronize()
    if not ahead:
        raise AssertionError("device_ms: the host did not stay ahead")
    return start.elapsed_time(end) / iters, host


def split_ms(kernel, library, args):
    """device_ms of the kernel's call and of its library call: their
    device and host ms per call."""
    out = dict(zip(("device_ms", "host_ms"), device_ms(kernel, args)))
    out.update(zip(("library_device_ms", "library_host_ms"),
                   device_ms(library, args)))
    return out


def _conv_library(x, w, dilation=1):
    """One cuDNN call computing the conv: F.conv3d on the NDHWC tensor
    viewed channels-last (no explicit pad)."""
    return torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3),
                                      w.permute(4, 3, 0, 1, 2),
                                      padding=dilation, dilation=dilation)


def _volume(v):
    """A geometry's volume: an edge (a cube) or (D, H, W)."""
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def check_conv(dev, gen, cin, cout, v, dil, batch, dtype, stats):
    """K1 (stats) or K1-dx (no stats) against its twin at one geometry."""
    from nas_3d_unet_tpu_torch.ops import pgemm

    x = torch.randn((batch, *_volume(v), cin), generator=gen, device=dev)
    w = torch.randn((3, 3, 3, cin, cout), generator=gen,
                    device=dev) * (27 * cin) ** -0.5
    args = (x.to(dtype), w.to(dtype).contiguous(), dil)
    if stats:
        kernel, twin = pgemm.conv3x3x3_stats, pgemm.conv3x3x3_stats_twin
    else:
        kernel, twin = pgemm.conv3x3x3, pgemm.conv3x3x3_twin
    with torch.no_grad():
        out_k = kernel(*args)
        out_t = twin(*args)
        rep = _repeatable(kernel, args, out_k)
    torch.cuda.synchronize()
    yk, yt = (out_k[0], out_t[0]) if stats else (out_k, out_t)
    rec = {"cin": cin, "cout": cout, "volume": v, "dilation": dil,
           "batch": batch, "bitwise_repeatable": rep, **_y_check(yk, yt)}
    ok = rec["y_ok"] and rep
    if stats:
        extra = ()
        if dtype == torch.bfloat16:
            with torch.no_grad():
                extra = (yk, pgemm.conv3x3x3_twin(args[0].float(),
                                                  args[1].float(), dil))
        rec.update(_moments_check(*out_k[1:], *out_t[1:], yt, dtype, *extra))
        ok = ok and rec["moments_ok"]
        del extra
    with torch.no_grad():
        rec.update(_timings(kernel, twin, _conv_library, args))
    e = args[0].element_size()
    rows = batch * math.prod(_volume(v))
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (rows * (cin + cout) + 27 * cin * cout) * e
        + (8 * batch * cout if stats else 0),
        2.0 * rows * 27 * cin * cout, dtype)
    rec["ok"] = ok
    return rec


def check_gemm(dev, gen, k, n, v, batch, dtype):
    """K2 against its twin at one geometry."""
    from nas_3d_unet_tpu_torch.ops import pgemm

    rows = math.prod(_volume(v))
    x = torch.randn((batch, rows, k), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dtype)
    args = (x, w)
    with torch.no_grad():
        out_k = pgemm.gemm_stats(*args)
        out_t = pgemm.gemm_stats_twin(*args)
        rep = _repeatable(pgemm.gemm_stats, args, out_k)
        extra = ((out_k[0], x.float() @ w.float())
                 if dtype == torch.bfloat16 else ())
    torch.cuda.synchronize()
    rec = {"k": k, "n": n, "volume": v, "batch": batch, "rows": batch * rows,
           "bitwise_repeatable": rep, **_y_check(out_k[0], out_t[0]),
           **_moments_check(*out_k[1:], *out_t[1:], out_t[0], dtype, *extra)}
    del extra
    with torch.no_grad():
        rec.update(_timings(pgemm.gemm_stats, pgemm.gemm_stats_twin,
                            torch.matmul, args))
        rec.update(split_ms(pgemm.gemm_stats, torch.matmul, args))
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (batch * rows * (k + n) + k * n) * x.element_size() + 8 * batch * n,
        2.0 * batch * rows * k * n, dtype)
    rec["ok"] = rec["y_ok"] and rec["moments_ok"] and rep
    return rec


def _ncdhw(t):
    """An NDHWC tensor as a contiguous NCDHW copy: PyTorch's GroupNorm
    layout (its CPU backward crashes on the channels-last view)."""
    return t.permute(0, 4, 1, 2, 3).contiguous()


def _gn_backward(g, x, mean, rstd, gamma, groups, mask):
    """`native_group_norm_backward` on NCDHW tensors: (dx, dgamma, dbeta),
    those of `mask` computed."""
    b, c, *vol = x.shape
    return torch.ops.aten.native_group_norm_backward(
        g, x, mean, rstd, gamma, b, c, math.prod(vol), groups, mask)


def _stats_library(name, args):
    """One PyTorch call computing the same sums: K5a's moments as
    `torch.var_mean` per (batch, channel); K5b's Σg·x and Σg as the
    dgamma and dbeta of `native_group_norm_backward` with one group per
    channel, mean 0 and rstd 1 (summed over the batch: the same sums at
    batch 1 only, else None), on NCDHW copies made beforehand; masked K5b
    the same after `torch.where` masks g by y > 0."""
    if name == "moments":
        return lambda t: torch.var_mean(t, dim=(1, 2, 3), correction=0)
    x = args[1]
    b, c = x.shape[0], x.shape[-1]
    if b != 1:
        return None
    g, x, *y = map(_ncdhw, args)
    mean = torch.zeros((b, c), dtype=x.dtype, device=x.device)
    rstd = torch.ones_like(mean)
    gamma = torch.ones((c,), dtype=x.dtype, device=x.device)

    def library(*_):
        gm = torch.where(y[0] > 0, g, 0.0) if y else g
        return _gn_backward(gm, x, mean, rstd, gamma, c,
                            [False, True, True])[1:]

    return library


def _offset_view(t, offset):
    """t's values in a contiguous view `offset` elements into a buffer of
    its own (offset 0: t itself)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def check_stats(dev, gen, name, c, v, batch, dtype, offset=0):
    """K5a (moments), K5b (weighted_sums) or K5b masked by y > 0
    (weighted_sums_masked, K3's backward sums) against the twin, and
    against float64 sums of the same input; the inputs `offset` elements
    into their buffers.  Also the call's device and host ms and its
    library call's (`split_ms`), and the plan (VEC, rows a block, blocks
    along V) with the partials' bytes as a share of one input's."""
    from nas_3d_unet_tpu_torch.ops import stats

    shape = (batch, *_volume(v), c)
    rand = lambda: torch.randn(shape, generator=gen, device=dev)
    x = _offset_view((rand() + 0.5).to(dtype), offset)
    if name == "moments":
        args = (x,)
        xd = x.double()
        terms = (xd, xd * xd)
    else:
        g = _offset_view(rand().to(dtype), offset)
        args = (g, x)
        gd = g.double()
        if name == "weighted_sums_masked":
            y = _offset_view(rand().relu().to(dtype), offset)
            args = (g, x, y)
            gd = torch.where(y > 0, gd, 0.0)
        terms = (gd, gd * x.double())
    kernel = getattr(stats, name.replace("_masked", ""))
    twin = getattr(stats, name.replace("_masked", "") + "_twin")
    out = kernel(*args)
    rep = _repeatable(kernel, args, out)
    dims = (1, 2, 3)
    errs = [((o.double() - t.sum(dims)).abs()
             / t.abs().sum(dims).clamp_min(1e-300)).max().item()
            for o, t in zip(out, terms)]
    del terms
    torch.cuda.synchronize()
    library = _stats_library(name, args)
    vox = x.numel() // (batch * c)
    p = stats.plan(batch, vox, c, x.element_size(), len(args),
                   not any(a.data_ptr() % 16 for a in args))
    rec = {"c": c, "volume": v, "batch": batch, "offset": offset,
           "bitwise_repeatable": rep,
           "max_err_over_sum_abs": errs, "limit": STATS_RTOL,
           "plan": [p.vec, p.rows, p.nspan],
           "partial_share": 16 * p.nspan / (vox * x.element_size()),
           **_timings(kernel, twin, library, args)}
    rec.update(zip(("device_ms", "host_ms"), device_ms(kernel, args)))
    if library is not None:
        rec.update(zip(("library_device_ms", "library_host_ms"),
                       device_ms(library, args)))
    n_in = len(args)
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        n_in * x.numel() * x.element_size() + 8 * batch * c,
        3.0 * x.numel(), dtype)
    rec["max_abs_err"] = max(
        (o - t).abs().max().item() for o, t in zip(out, twin(*args)))
    rec["ok"] = rep and max(errs) <= STATS_RTOL
    return rec


def _conv_library_strided(x, w, b, stride, dilation, relu):
    """One cuDNN call doing a 3³ conv's work (the ReLU aside): F.conv3d
    with symmetric padding (at stride 2 lax's pad is one-sided, so this
    one's output is shifted by a voxel: the same shape and work, not the
    same values)."""
    return torch.nn.functional.conv3d(
        x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
        None if b is None else b.to(x.dtype), stride=stride,
        padding=dilation, dilation=dilation)


def check_conv3d(dev, gen, cin, cout, v, stride, dil, batch, dtype,
                 bias_relu=False):
    """K6 against its twin at one geometry."""
    from nas_3d_unet_tpu_torch.ops import conv3d

    x = torch.randn((batch, *_volume(v), cin), generator=gen, device=dev)
    w = torch.randn((3, 3, 3, cin, cout), generator=gen,
                    device=dev) * (27 * cin) ** -0.5
    b = (torch.randn((cout,), generator=gen, device=dev) * 0.5
         if bias_relu else None)
    args = (x.to(dtype), w.to(dtype).contiguous(), b, stride, dil, bias_relu)
    with torch.no_grad():
        yk = conv3d.conv3d(*args)
        yt = conv3d.conv3d_twin(*args)
        rep = _repeatable(conv3d.conv3d, args, yk)
        times = _timings(conv3d.conv3d, conv3d.conv3d_twin,
                         _conv_library_strided, args)
    torch.cuda.synchronize()
    rec = {"cin": cin, "cout": cout, "volume": v, "stride": stride,
           "dilation": dil, "bias_relu": bias_relu, "batch": batch,
           "bitwise_repeatable": rep, **_y_check(yk, yt), **times}
    e = args[0].element_size()
    rows = batch * math.prod(-(-s // stride) for s in _volume(v))
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (batch * math.prod(_volume(v)) * cin + rows * cout
         + 27 * cin * cout) * e,
        2.0 * rows * 27 * cin * cout, dtype)
    rec["ok"] = rec["y_ok"] and rep
    return rec


def check_pointwise(dev, gen, cin, cout, v, batch, dtype, bias_scale=None):
    """K7 against its twin at one geometry; with a bias (of `bias_scale`)
    also the ReLU."""
    from nas_3d_unet_tpu_torch.ops import conv3d

    x = torch.randn((batch, *_volume(v), cin), generator=gen,
                    device=dev).to(dtype)
    w = (torch.randn((cin, cout), generator=gen, device=dev)
         * cin ** -0.5).to(dtype)
    b = (torch.randn((cout,), generator=gen, device=dev) * bias_scale
         if bias_scale else None)
    args = (x, w, b, b is not None)

    def library(x, w, *_):
        return torch.matmul(x, w)

    with torch.no_grad():
        yk = conv3d.pointwise_conv(*args)
        yt = conv3d.pointwise_conv_twin(*args)
        rep = _repeatable(conv3d.pointwise_conv, args, yk)
        times = _timings(conv3d.pointwise_conv, conv3d.pointwise_conv_twin,
                         library, args)
        times.update(split_ms(conv3d.pointwise_conv, library, args))
    torch.cuda.synchronize()
    rows = batch * math.prod(_volume(v))
    rec = {"cin": cin, "cout": cout, "volume": v, "batch": batch,
           "bias_scale": bias_scale, "bitwise_repeatable": rep,
           **_y_check(yk, yt), **times}
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (rows * (cin + cout) + cin * cout) * x.element_size(),
        2.0 * rows * cin * cout, dtype)
    rec["ok"] = rec["y_ok"] and rep
    return rec


def check_transpose(dev, gen, cin, cout, v, batch, dtype, relu=False):
    """K4 against its twin at one geometry (input volume v)."""
    from nas_3d_unet_tpu_torch.ops import conv3d

    x = torch.randn((batch, *_volume(v), cin), generator=gen,
                    device=dev).to(dtype)
    w = (torch.randn((2, 2, 2, cin, cout), generator=gen, device=dev)
         * cin ** -0.5).to(dtype)
    args = (x, w, relu)

    def library(x, w, _relu):
        return torch.nn.functional.conv_transpose3d(
            x.permute(0, 4, 1, 2, 3), w.permute(3, 4, 0, 1, 2), stride=2)

    with torch.no_grad():
        yk = conv3d.conv_transpose2x(*args)
        yt = conv3d.conv_transpose2x_twin(*args)
        rep = _repeatable(conv3d.conv_transpose2x, args, yk)
        times = _timings(conv3d.conv_transpose2x,
                         conv3d.conv_transpose2x_twin, library, args)
        times.update(split_ms(conv3d.conv_transpose2x, library, args))
    torch.cuda.synchronize()
    rows = batch * math.prod(_volume(v))
    rec = {"cin": cin, "cout": cout, "volume": v, "batch": batch,
           "relu": relu, "bitwise_repeatable": rep, **_y_check(yk, yt),
           **times}
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        (rows * (cin + 8 * cout) + 8 * cin * cout) * x.element_size(),
        2.0 * rows * cin * 8 * cout, dtype)
    rec["ok"] = rec["y_ok"] and rep
    return rec


def check_gn(dev, gen, name, c, v, batch, dtype):
    """K3's apply (`y = relu(x·s + t)`, library: F.group_norm with its
    statistics, on the permuted tensor) or dx (`a·g + b·x + c`, g masked
    by y > 0) against its twin at one geometry, as the flagship calls
    them (ReLU fused)."""
    from nas_3d_unet_tpu_torch.ops import groupnorm

    shape = (batch, v, v, v, c)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vec = lambda: torch.randn((batch, c), generator=gen, device=dev)
    n = x.numel()
    e = x.element_size()
    if name == "group_norm_apply":
        args = (x, vec() * 0.5 + 1, vec() * 0.5, True)
        kernel = groupnorm.group_norm_apply
        twin = groupnorm.group_norm_apply_twin
        groups = min(8, c)
        gamma, beta = args[1][0], args[2][0]

        def library(x, *_):
            return torch.nn.functional.group_norm(
                x.permute(0, 4, 1, 2, 3), groups, gamma.to(x.dtype),
                beta.to(x.dtype))

        nbytes, flops = 2 * n * e + 8 * batch * c, 3.0 * n
    else:
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        y = torch.randn(shape, generator=gen, device=dev).relu().to(dtype)
        args = (g, x, y, vec(), vec(), vec())
        kernel, twin = groupnorm.group_norm_dx, groupnorm.group_norm_dx_twin
        # library: the whole GroupNorm backward's dx (which also takes its
        # own sums), with the ReLU mask applied to g, on NCDHW copies and
        # the statistics and γ of x from native_group_norm
        groups = min(8, c)
        gamma = (vec()[0] * 0.5 + 1).to(dtype)
        gc, xc, yc = map(_ncdhw, args[:3])
        _, mean, rstd = torch.ops.aten.native_group_norm(
            xc, gamma, None, batch, c, v ** 3, groups, 1e-6)

        def library(*_):
            return _gn_backward(torch.where(yc > 0, gc, 0.0), xc, mean, rstd,
                                gamma, groups, [True, False, False])[0]

        nbytes, flops = 4 * n * e + 12 * batch * c, 6.0 * n
    with torch.no_grad():
        yk = kernel(*args)
        yt = twin(*args)
        rep = _repeatable(kernel, args, yk)
        times = _timings(kernel, twin, library, args)
    torch.cuda.synchronize()
    rec = {"c": c, "volume": v, "batch": batch, "bitwise_repeatable": rep,
           **_y_check(yk, yt), **times}
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, dtype)
    rec["ok"] = rec["y_ok"] and rep
    return rec


SPLIT_KEYS = ("device_ms", "host_ms", "library_device_ms", "library_host_ms")


class Summary:
    """Per kernel name: launches-weighted sums of the phase records."""

    def __init__(self):
        self.rows = collections.defaultdict(
            lambda: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bound_ms": 0.0, "bound_by": collections.Counter(),
                     "max_abs_err": 0.0})
        # device_ms, host_ms and the library call's, per unit
        self.split_rows = collections.defaultdict(collections.Counter)

    def add(self, name, rec, per_unit):
        row = self.rows[name]
        for key in ("ms", "plain_ms", "bound_ms"):
            row[key] += per_unit * rec[key]
        if rec["library_ms"] is None:
            if per_unit:     # off the path (0), it adds nothing either way
                row["library_ms"] = None
        elif row["library_ms"] is not None:
            row["library_ms"] += per_unit * rec["library_ms"]
        row["bound_by"][rec["bound_by"]] += per_unit * rec["bound_ms"]
        row["max_abs_err"] = max(row["max_abs_err"],
                                 rec.get("y_max_abs", rec.get("max_abs_err")))
        for key in SPLIT_KEYS:
            if key in rec:
                self.split_rows[name][key] += per_unit * rec[key]

    def entry(self, name):
        row = dict(self.rows[name])
        row["bound_by"] = row["bound_by"].most_common(1)[0][0]
        return row

    def split(self, name):
        """A kernel's call ms (host and device) beside its device ms and
        host ms, the bound, and the library call's ms, device ms and host
        ms, per unit."""
        row = self.rows[name]
        return {"ms": row["ms"], "bound_ms": row["bound_ms"],
                "library_ms": row["library_ms"],
                **{k: self.split_rows[name][k] for k in SPLIT_KEYS}}


def _run_check(phase, kernel, fn, summary, per_unit, *args):
    rec = fn(*args)
    emit({"phase": phase, "kernel": kernel, "per_unit": per_unit, **rec})
    if not rec["ok"]:
        raise AssertionError(f"{kernel} disagrees with its twin: {rec}")
    summary.add(kernel, rec, per_unit)


def phase_kernels(dev, gen, summary):
    """Serving kernels, fp32, batch 2; per_unit = launches per forward (0
    off the path, and for K1-dx, which serving never runs)."""
    f32 = torch.float32
    for cin, cout, v, dil, n in K1_GEOMS + K1_EXTRA:
        _run_check("kernel", "conv3x3x3_stats_f32", check_conv, summary, n,
                   dev, gen, cin, cout, v, dil, BATCH, f32, True)
    for cin, cout, v, dil, _ in K1DX_TRAIN + K1DX_EXTRA:
        _run_check("kernel", "conv3x3x3_f32", check_conv, summary, 0,
                   dev, gen, cin, cout, v, dil, BATCH, f32, False)
    for k, nn, v, n in K2_GEOMS:
        _run_check("kernel", "gemm_stats_f32", check_gemm, summary, n,
                   dev, gen, k, nn, v, BATCH, f32)
    for c, v, n in K5A_GEOMS:
        _run_check("kernel", "moments_f32", check_stats, summary, n,
                   dev, gen, "moments", c, v, BATCH, f32)


def phase_train_kernels(dev, gen, summary):
    """Training kernels at one train step's geometries (bf16, microbatch
    1); per_unit = launches per step.  K5b also in fp32 (per_unit 0)."""
    bf16, f32 = torch.bfloat16, torch.float32
    for cin, cout, v, dil, n in K1_TRAIN + K1_EXTRA:
        _run_check("train_kernel", "conv3x3x3_stats_bf16", check_conv,
                   summary, n, dev, gen, cin, cout, v, dil, MICRO, bf16, True)
    for cin, cout, v, dil, n in K1DX_TRAIN + K1DX_EXTRA:
        _run_check("train_kernel", "conv3x3x3_bf16", check_conv, summary, n,
                   dev, gen, cin, cout, v, dil, MICRO, bf16, False)
    for k, nn, v, n in K2_TRAIN + K2_EXTRA:
        _run_check("train_kernel", "gemm_stats_bf16", check_gemm, summary,
                   n, dev, gen, k, nn, v, MICRO, bf16)
    for c, v, n in K5A_TRAIN:
        _run_check("train_kernel", "moments_bf16", check_stats, summary, n,
                   dev, gen, "moments", c, v, MICRO, bf16)
    for c, v, n in K5B_TRAIN:
        for dtype, per in ((bf16, n), (f32, 0)):
            _run_check("train_kernel", f"weighted_sums_{SUFFIX[dtype]}",
                       check_stats, summary, per, dev, gen, "weighted_sums",
                       c, v, MICRO, dtype)


def phase_pallas_kernels(dev, gen, summary):
    """The use_pallas kernels: fp32 at batch 2 (per_unit = launches per
    forward), bf16 at batch 1 (per_unit = launches per train step)."""
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype, batch, per in ((f32, BATCH, 1), (bf16, MICRO, 2)):
        t = SUFFIX[dtype]
        for cin, cout, v, st, dil, n in P_K6 + P_K6_EXTRA:
            _run_check("pallas_kernel", f"conv3d_{t}", check_conv3d, summary,
                       per * n, dev, gen, cin, cout, v, st, dil, batch, dtype)
        _run_check("pallas_kernel", f"conv3d_{t}", check_conv3d, summary, 0,
                   dev, gen, *P_K6_BIAS_RELU, batch, dtype, True)
        for c, v, n in P_K7:
            _run_check("pallas_kernel", f"pointwise_conv_{t}",
                       check_pointwise, summary, per * n, dev, gen, c, c, v,
                       batch, dtype)
        for cin, cout, v, scale in P_K7_EXTRA:
            _run_check("pallas_kernel", f"pointwise_conv_{t}",
                       check_pointwise, summary, 0, dev, gen, cin, cout, v,
                       batch, dtype, scale)
        for c, v, n in P_K4:
            _run_check("pallas_kernel", f"conv_transpose2x_{t}",
                       check_transpose, summary, per * n, dev, gen, c, c, v,
                       batch, dtype)
        for cin, cout, v, relu in P_K4_EXTRA:
            _run_check("pallas_kernel", f"conv_transpose2x_{t}",
                       check_transpose, summary, 0, dev, gen, cin, cout, v,
                       batch, dtype, relu)
        for c, v, n in P_K3:
            _run_check("pallas_kernel", f"group_norm_apply_{t}", check_gn,
                       summary, per * n, dev, gen, "group_norm_apply", c, v,
                       batch, dtype)
        for c, v, n in P_K5A:      # K5a's own rows count the default paths
            _run_check("pallas_kernel", f"moments_{t}", check_stats,
                       summary, 0, dev, gen, "moments", c, v, batch, dtype)
    for c, v, n in P_K3:           # the backward: training only
        for name, fn in (("group_norm_dx", check_gn),
                         ("weighted_sums_masked", check_stats)):
            _run_check("pallas_kernel", f"{name}_bf16", fn, summary, 2 * n,
                       dev, gen, name, c, v, MICRO, bf16)
    for c, v, off in K5_EXTRA:     # K5 off the path: scalar, unaligned
        for name in ("moments", "weighted_sums", "weighted_sums_masked"):
            for dtype in (f32, bf16):
                _run_check("pallas_kernel", f"{name}_{SUFFIX[dtype]}",
                           check_stats, summary, 0, dev, gen, name, c, v,
                           BATCH, dtype, off)
    emit({"phase": "stats_device_split", **{
        n: summary.split(n) for n in
        ("moments_f32", "moments_bf16", "weighted_sums_bf16",
         "weighted_sums_masked_bf16")}})
    emit({"phase": "pallas_device_split", **{
        n: summary.split(n) for n in
        [f"{k}_{t}" for k in ("gemm_stats", "pointwise_conv",
                              "conv_transpose2x")
         for t in ("f32", "bf16")]}})


# the kernels that run in a forward; the rest run in the backward
FORWARD_KERNELS = ("conv3x3x3_stats", "gemm_stats", "moments", "conv3d",
                   "pointwise_conv", "conv_transpose2x", "group_norm_apply")


def _modules_per_forward(net):
    """Kernel launches one forward (and its backward) makes, counted from
    the modules.  Default path: every stride-1 ConvNormAct runs K1 (3³) or
    K2 (1³); each plain producer's GroupNorm runs K5a; every GroupNorm's
    backward runs K5b; every K1 but the stem's (its input needs no
    gradient) runs K1-dx.  use_pallas: the 3³ edge convs run K6, SepConv
    K7, UpTranspose K4, every GroupNorm K3 (apply forward; masked K5b and
    dx backward), K5a for the GroupNorms whose producer is not K1/K2; K1
    (the stem) and K2 as before.  Kernels with no launch are left out."""
    from nas_3d_unet_tpu_torch.ops.primitives import (ConvNormAct, SepConv,
                                                      UpTranspose)

    mods = list(net.modules())
    cna = [m for m in mods if isinstance(m, ConvNormAct)]
    k1 = sum(m.stride == 1 and m.kernel == 3 and not m.k6 for m in cna)
    k2 = sum(m.stride == 1 and m.kernel == 1 for m in cna)
    norms = [m for m in mods if isinstance(m, (ConvNormAct, SepConv,
                                               UpTranspose))]
    out = {"conv3x3x3_stats": k1, "gemm_stats": k2,
           "moments": len(norms) - k1 - k2, "conv3x3x3": k1 - 1}
    if any(m.norm.use_pallas for m in norms):
        out.update({"conv3d": sum(m.k6 for m in cna),
                    "pointwise_conv": sum(isinstance(m, SepConv)
                                          for m in norms),
                    "conv_transpose2x": sum(isinstance(m, UpTranspose)
                                            for m in norms),
                    "group_norm_apply": len(norms),
                    "weighted_sums_masked": len(norms),
                    "group_norm_dx": len(norms)})
    else:
        out["weighted_sums"] = len(norms)
    return {k: n for k, n in out.items() if n}


def flagship_net(seed, dtype="float32", use_pallas=False):
    """The flagship derived net on the CPU, random weights from `seed` at
    flax's initialiser scales."""
    from nas_3d_unet_tpu_torch import bridge
    from nas_3d_unet_tpu_torch.models.genotype import default_genotype
    from nas_3d_unet_tpu_torch.models.unet import DerivedNet

    net = DerivedNet(default_genotype(3), in_channels=4, num_classes=3,
                     base_channels=16, depth=3, n_nodes=3, gn_groups=8,
                     dtype=dtype, use_pallas=use_pallas)
    bridge.load_flax_params(net, bridge.random_flax_params(net, seed))
    return net


def flagship_predictor(dev, seed, use_pallas=False):
    """The fp32 flagship net on `dev`, bound to the serving window
    settings."""
    from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor

    return SlidingWindowPredictor(
        flagship_net(seed, use_pallas=use_pallas).to(dev), PATCH,
        overlap=OVERLAP, batch_size=PATCH_BATCH, num_classes=3)


def synthetic_records(dev, seed, n):
    """`n` synthetic patients of SHAPE x 4 fp32 with {0,2,4} labels, as
    `bench.py` makes them, their image and label already on `dev`."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        vol = rng.standard_normal((*SHAPE, 4), dtype=np.float32)
        lab = (rng.integers(0, 3, SHAPE) * 2).astype(np.uint8)   # {0,2,4}
        recs.append({"patient": f"smoke_{i}", "image": vol, "label": lab,
                     "image_dev": torch.from_numpy(vol).to(dev),
                     "label_dev": torch.from_numpy(lab).to(dev),
                     "crop_start": np.zeros(3, np.int64),
                     "orig_shape": np.asarray(SHAPE, np.int64)})
    return recs


def noting_kernels(seen):
    """Context that records, per kernel, the geometry of each launch the
    net asks for: (kernel, *geometry) keys in `seen`."""
    from nas_3d_unet_tpu_torch.ops import conv3d, groupnorm, pgemm, stats

    k1, k2 = pgemm._k1, pgemm._k2
    mom, wsum = stats.moments, stats.weighted_sums
    k6, k7, k4 = conv3d._k6, conv3d._k7, conv3d._k4
    apply_, dx = groupnorm.group_norm_apply, groupnorm.group_norm_dx

    def k1_noted(x, w, dilation, with_stats):
        name = "conv3x3x3_stats" if with_stats else "conv3x3x3"
        seen[(name, x.shape[4], w.shape[4], x.shape[1], dilation)] += 1
        return k1(x, w, dilation, with_stats)

    def k2_noted(x3, w):
        edge = round(x3.shape[1] ** (1 / 3))
        seen[("gemm_stats", x3.shape[2], w.shape[1], edge)] += 1
        return k2(x3, w)

    def mom_noted(x):
        seen[("moments", x.shape[-1], x.shape[1])] += 1
        return mom(x)

    def wsum_noted(g, x, y=None):
        name = "weighted_sums" if y is None else "weighted_sums_masked"
        seen[(name, x.shape[-1], x.shape[1])] += 1
        return wsum(g, x, y)

    def k6_noted(x, w, b, stride, dilation, relu):
        seen[("conv3d", x.shape[4], w.shape[4], x.shape[1], stride,
              dilation)] += 1
        return k6(x, w, b, stride, dilation, relu)

    def k7_noted(x, w, b, relu):
        seen[("pointwise_conv", x.shape[-1], x.shape[1])] += 1
        return k7(x, w, b, relu)

    def k4_noted(x, w, relu):
        seen[("conv_transpose2x", x.shape[-1], x.shape[1])] += 1
        return k4(x, w, relu)

    def apply_noted(x, s, t, relu):
        seen[("group_norm_apply", x.shape[-1], x.shape[1])] += 1
        return apply_(x, s, t, relu)

    def dx_noted(g, x, y, a, b, c):
        seen[("group_norm_dx", x.shape[-1], x.shape[1])] += 1
        return dx(g, x, y, a, b, c)

    return _patched({(pgemm, "_k1"): k1_noted, (pgemm, "_k2"): k2_noted,
                     (stats, "moments"): mom_noted,
                     (stats, "weighted_sums"): wsum_noted,
                     (conv3d, "_k6"): k6_noted, (conv3d, "_k7"): k7_noted,
                     (conv3d, "_k4"): k4_noted,
                     (groupnorm, "group_norm_apply"): apply_noted,
                     (groupnorm, "group_norm_dx"): dx_noted})


def twin_path():
    """Context that routes every kernel of the net to its plain twin (K1,
    K2, K6, K7 and K4 with plain autograd, so dx goes through cuDNN's own
    backward; K3 as plain PyTorch with autograd through its statistics)."""
    from nas_3d_unet_tpu_torch.ops import conv3d, groupnorm, pgemm, stats

    return _patched({(pgemm, "conv3x3x3_stats"): pgemm.conv3x3x3_stats_twin,
                     (pgemm, "gemm_stats"): pgemm.gemm_stats_twin,
                     (stats, "moments"): stats.moments_twin,
                     (stats, "weighted_sums"): stats.weighted_sums_twin,
                     (conv3d, "conv3d"): conv3d.conv3d_twin,
                     (conv3d, "pointwise_conv"): conv3d.pointwise_conv_twin,
                     (conv3d, "conv_transpose2x"):
                         conv3d.conv_transpose2x_twin,
                     (groupnorm, "pallas_group_norm"):
                         groupnorm.pallas_group_norm_twin})


@contextlib.contextmanager
def _patched(table):
    """{(module, attribute): replacement}, patched for the block."""
    with contextlib.ExitStack() as stack:
        for (mod, attr), fn in table.items():
            stack.enter_context(mock.patch.object(mod, attr, fn))
        yield


def _table(*groups):
    """{(kernel, *geometry): launches} from the geometry tables."""
    out = collections.Counter()
    for name, rows in groups:
        for row in rows:
            if row[-1]:
                out[(name, *row[:-1])] += row[-1]
    return out


def _twice(rows):
    """Geometry rows with their launches doubled: one train step runs two
    microbatches."""
    return [(*r[:-1], 2 * r[-1]) for r in rows]


def kernel_tables(use_pallas, train):
    """{(kernel, *geometry): launches} a forward at batch 2 (serving) or a
    train step (training) makes, from the geometry tables."""
    if not use_pallas:
        if train:
            return _table(("conv3x3x3_stats", K1_TRAIN),
                          ("conv3x3x3", K1DX_TRAIN), ("gemm_stats", K2_TRAIN),
                          ("moments", K5A_TRAIN),
                          ("weighted_sums", K5B_TRAIN))
        return _table(("conv3x3x3_stats", K1_GEOMS), ("gemm_stats", K2_GEOMS),
                      ("moments", K5A_GEOMS))
    step = _twice if train else list
    groups = [("conv3x3x3_stats", step(P_K1)), ("gemm_stats", step(K2_GEOMS)),
              ("moments", step(P_K5A)), ("conv3d", step(P_K6)),
              ("pointwise_conv", step(P_K7)),
              ("conv_transpose2x", step(P_K4)),
              ("group_norm_apply", step(P_K3))]
    if train:
        groups += [("group_norm_dx", step(P_K3)),
                   ("weighted_sums_masked", step(P_K3))]
    return _table(*groups)


# launches per forward (and its backward) each configuration must count
# from its modules
PER_FORWARD = {
    False: {"conv3x3x3_stats": 16, "gemm_stats": 10, "moments": 20,
            "conv3x3x3": 15, "weighted_sums": 46},
    True: {"conv3x3x3_stats": 1, "gemm_stats": 10, "moments": 35,
           "conv3d": 21, "pointwise_conv": 9, "conv_transpose2x": 3,
           "group_norm_apply": 46, "group_norm_dx": 46,
           "weighted_sums_masked": 46},
}


def phase_slice(dev, seed, use_pallas=False):
    """Serving (phase 4, or phase 8 with use_pallas)."""
    from nas_3d_unet_tpu_torch.infer.predict import predict_records
    from nas_3d_unet_tpu_torch.infer.sliding import grid_coords
    from nas_3d_unet_tpu_torch.metrics.dice import regions_to_labels
    from nas_3d_unet_tpu_torch.ops import _cuda

    phase = "pallas_slice" if use_pallas else "slice"
    kernel_phase = "phase7" if use_pallas else "phase3"
    predictor = flagship_predictor(dev, seed, use_pallas)
    net = predictor.model
    t0 = time.perf_counter()
    recs = synthetic_records(dev, seed, N_PATIENTS + 1)   # +1: warm-up
    setup_s = time.perf_counter() - t0

    # one patch through the kernels (noting the shapes the net hands them,
    # which must be the geometries the kernel phase checked), then through
    # the twins, same weights
    seen = collections.Counter()
    pd, ph, pw = PATCH
    x = recs[0]["image_dev"][:pd, :ph, :pw].unsqueeze(0).contiguous()
    with torch.inference_mode():
        with noting_kernels(seen):
            logits_k = net(x)
        with twin_path():
            logits_t = net(x)
    torch.cuda.synchronize()
    logit_err = (logits_k - logits_t).abs().max().item()
    agree = (regions_to_labels(torch.sigmoid(logits_k))
             == regions_to_labels(torch.sigmoid(logits_t))).float().mean()
    agree = agree.item()
    tables = kernel_tables(use_pallas, train=False)
    emit({"phase": f"{phase}_parity", "logits_max_abs": logit_err,
          "limit": LOGIT_ATOL, "label_agreement": agree,
          "agreement_limit": LABEL_AGREE,
          f"geometries_match_{kernel_phase}": seen == tables})
    if not (logit_err <= LOGIT_ATOL and agree >= LABEL_AGREE):
        raise AssertionError("kernel path disagrees with the twin path")
    if seen != tables:
        raise AssertionError(f"the net's kernel shapes {dict(seen)} are not "
                             f"the geometries checked in {kernel_phase}")
    del logits_k, logits_t, x

    # keep each patient's label volume for the checks below
    labels_seen = []
    predict_labels = predictor.predict_labels

    def keep_labels(volume, threshold=0.5):
        out = predict_labels(volume, threshold=threshold)
        labels_seen.append(out)
        return out

    predictor.predict_labels = keep_labels

    warm = recs.pop(0)
    t0 = time.perf_counter()
    predict_records(predictor, [(warm["patient"], warm)], verbose=False)
    warm_s = time.perf_counter() - t0
    labels_seen.clear()

    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = predict_records(predictor, [(r["patient"], r) for r in recs],
                          verbose=False)
    torch.cuda.synchronize()
    s_per_patient = (time.perf_counter() - t0) / len(recs)
    launches = dict(_cuda.LAUNCHES)

    stride = tuple(max(1, int(round(p * (1 - OVERLAP)))) for p in PATCH)
    forwards = len(recs) * math.ceil(len(grid_coords(SHAPE, PATCH, stride))
                                     / PATCH_BATCH)
    per_fwd = _modules_per_forward(net)
    expected = {f"{k}_f32": n * forwards for k, n in per_fwd.items()
                if k in FORWARD_KERNELS}
    dice = [r["dice"] for r in out]
    label_sets = [sorted(torch.unique(t).tolist()) for t in labels_seen]
    emit({"phase": phase, "patients": len(out), "volume": list(SHAPE),
          "s_per_patient": s_per_patient, "warmup_patient_s": warm_s,
          "setup_s": setup_s, "forwards": forwards,
          "launches_per_forward": per_fwd,
          "launches": launches, "expected_launches": expected,
          "dice": dice, "label_values": label_sets,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30})
    if [r["patient"] for r in out] != [r["patient"] for r in recs]:
        raise AssertionError("results out of patient order")
    if per_fwd != PER_FORWARD[use_pallas] or launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected} "
                             f"(per forward {per_fwd})")
    if len(labels_seen) != len(recs):
        raise AssertionError("a patient's labels were not seen")
    for t in labels_seen:
        if t.dtype != torch.uint8 or tuple(t.shape) != SHAPE \
                or not set(torch.unique(t).tolist()) <= {0, 1, 2, 4}:
            raise AssertionError(f"bad label volume {t.dtype} {t.shape}")
    if not all(math.isfinite(v) for d in dice for v in d.values()):
        raise AssertionError(f"non-finite Dice {dice}")
    return launches, s_per_patient


def synthetic_batch(dev, seed):
    """bench.py's training batch: x ~ N(0, 1) of TRAIN_BATCH x
    TRAIN_PATCH^3 x 4 from `seed`, y = the WT mask (x[..., 1] > 0.5) in
    all three region channels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((TRAIN_BATCH, *(TRAIN_PATCH,) * 3, 4)).astype(
        np.float32)
    x = torch.from_numpy(x).to(dev)
    wt = (x[..., 1] > 0.5).float()
    return x, torch.stack([wt, wt, wt], dim=-1)


def grad_parity(net, x, y, kernel_ctx=None, use_pallas=False):
    """One step's gradients on the kernel path (inside `kernel_ctx`) and on
    the twin path, leaf by leaf: the relative L2 distance
    ‖g_k − g_t‖ / ‖g_t‖ (its largest and its median), the cosine, and the
    relative difference of the norms.  `ok` holds all but the last to
    their limits (the use_pallas configuration's own with use_pallas)."""
    from nas_3d_unet_tpu_torch.metrics.losses import dice_ce_loss
    from nas_3d_unet_tpu_torch.train.loop import loss_and_grads

    names = [n for n, _ in net.named_parameters()]
    out = {}
    for path, ctx in (("kernel", kernel_ctx or contextlib.nullcontext()),
                      ("twin", twin_path())):
        with ctx:
            loss, grads = loss_and_grads(net, x, y, dice_ce_loss, MICRO)
        out[path] = (loss.item(), [g.double() for g in grads])
    net.zero_grad(set_to_none=True)
    rel, cos, norm_rel = [], [], []
    for gk, gt in zip(out["kernel"][1], out["twin"][1]):
        nk, nt = gk.norm().item(), gt.norm().item()
        rel.append((gk - gt).norm().item() / max(nt, 1e-30))
        cos.append((gk.flatten() @ gt.flatten()).item()
                   / max(nk * nt, 1e-30))
        norm_rel.append(abs(nk - nt) / max(nt, 1e-30))
    worst, least = int(np.argmax(rel)), int(np.argmin(cos))
    vals = rel + cos + norm_rel
    lim_rel, lim_med, lim_cos = (
        (P_GRAD_REL_L2, P_GRAD_REL_L2_MEDIAN, P_GRAD_COS) if use_pallas
        else (GRAD_REL_L2, GRAD_REL_L2_MEDIAN, GRAD_COS))
    return {"loss_kernel": out["kernel"][0], "loss_twin": out["twin"][0],
            "leaves": len(rel), "grad_rel_l2_max": rel[worst],
            "rel_l2_worst_leaf": names[worst],
            "grad_rel_l2_median": float(np.median(rel)),
            "grad_cos_min": cos[least], "cos_worst_leaf": names[least],
            "grad_norm_rel_max": max(norm_rel),
            "limits": {"rel_l2": lim_rel, "rel_l2_median": lim_med,
                       "cos": lim_cos},
            "ok": (all(map(math.isfinite, vals)) and rel[worst] <= lim_rel
                   and np.median(rel) <= lim_med and cos[least] >= lim_cos)}


def phase_train(dev, seed, use_pallas=False):
    """Training (phase 6, or phase 9 with use_pallas)."""
    from nas_3d_unet_tpu_torch.ops import _cuda
    from nas_3d_unet_tpu_torch.train.loop import make_train_step
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer

    phase = "pallas_train" if use_pallas else "train"
    kernel_phase = "phase7" if use_pallas else "phase5"
    net = flagship_net(seed, "bfloat16", use_pallas).to(dev)
    x, y = synthetic_batch(dev, seed)

    # one step's gradients, kernel path (noting the shapes) then twin path
    seen = collections.Counter()
    rec = grad_parity(net, x, y, noting_kernels(seen), use_pallas)
    tables = kernel_tables(use_pallas, train=True)
    emit({"phase": f"{phase}_parity", **rec,
          f"geometries_match_{kernel_phase}": seen == tables})
    if not rec["ok"]:
        raise AssertionError("kernel-path gradients disagree with the twin "
                             "path")
    if seen != tables:
        raise AssertionError(f"the step's kernel shapes {dict(seen)} are "
                             f"not the geometries checked in {kernel_phase}")

    opt = make_optimizer(net.parameters(), 3e-4, 1e-4)
    step = make_train_step(net, opt, augment=AUGMENT, microbatch=MICRO,
                           seed=seed)
    t0 = time.perf_counter()
    warm = [step(x, y).item() for _ in range(WARMUP_STEPS)]
    warm_s = time.perf_counter() - t0
    _cuda.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(x, y) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    losses = [v.item() for v in losses]
    launches = dict(_cuda.LAUNCHES)
    per = _modules_per_forward(net)
    slices = TRAIN_BATCH // MICRO
    expected = {f"{k}_bf16": n * slices * TIMED_STEPS for k, n in per.items()}
    rec = {"phase": phase, "batch": TRAIN_BATCH, "patch": TRAIN_PATCH,
           "microbatch": MICRO, "dtype": "bfloat16",
           "patches_per_s": TRAIN_BATCH / step_s, "step_s": step_s,
           "warmup_losses": warm, "warmup_s": warm_s, "losses": losses,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "launches_per_microbatch": per, "launches": launches,
           "expected_launches": expected}
    emit(rec)
    if not all(map(math.isfinite, warm + losses)):
        raise AssertionError(f"non-finite loss {warm + losses}")
    if per != PER_FORWARD[use_pallas] or launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected} "
                             f"(per microbatch {per})")
    return launches, rec


def check_copy(x, rpb):
    """E1 at one rows-per-block: bit-equal to the twin, the same bits on a
    second launch; library: `dst.copy_(x)`.  Timed as the probe times it
    (its ITERS launches after 2 warm-up ones): a launch takes ~0.05 ms."""
    from nas_3d_unet_tpu_torch.experiments import r3_dma_probe as e1
    from nas_3d_unet_tpu_torch.utils.timing import cuda_ms

    yk = e1.copy_rows(x, rpb)
    rep = _repeatable(e1.copy_rows, (x, rpb), yk)
    equal = torch.equal(yk, e1.copy_rows_twin(x))
    dst = torch.empty_like(x)
    rec = {"rows_per_block": rpb, "blocks": x.shape[0] // rpb,
           "bit_equal": equal, "bitwise_repeatable": rep,
           "max_abs_err": (yk.float() - x.float()).abs().max().item()}
    for key, fn, args in (("ms", e1.copy_rows, (x, rpb)),
                          ("plain_ms", e1.copy_rows_twin, (x,)),
                          ("library_ms", dst.copy_, (x,))):
        rec[key] = cuda_ms(fn, *args, iters=e1.ITERS, warmup=2)
    rec.update(e1.rate(x, rec["ms"]))
    rec["bound_ms"], rec["bound_by"] = bound_ms(e1.copy_bytes(x), 0.0,
                                                torch.bfloat16)
    rec["ok"] = equal and rep
    return rec


def check_pg(variant, ops):
    """E2's `variant` at the level-0 geometry against its fp32-accumulated
    twin: nodot bit-equal, the others within Y_ULPS bf16 ulps.  Library
    (`e2.LIBRARY`): nodot's gather, for the others `torch.matmul` of a
    pre-built concat of the variant's slices with its stacked weight tiles
    (fold1536: its own concat with ac2), the GEMM alone."""
    from nas_3d_unet_tpu_torch.experiments import r3_pg_variants as e2

    args = (variant, *ops, e2.WP)
    yk = e2.pg(*args)
    yt = e2.pg_twin(*args)
    rep = _repeatable(e2.pg, args, yk)
    torch.cuda.synchronize()
    rec = {"variant": variant, "nb": ops[0].shape[0],
           "bitwise_repeatable": rep, **_y_check(yk, yt)}
    if variant == "nodot":
        rec["y_ok"] = rec["bit_equal"] = torch.equal(yk, yt)
    del yk, yt
    rec.update(_timings(e2.pg, e2.pg_twin, e2.library(*args), args))
    flops, nbytes = e2.work(variant)
    rec["TFLOP_s"] = flops / rec["ms"] / 1e9
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, torch.bfloat16)
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    rec["ok"] = rec["y_ok"] and rep
    return rec


def sass_functions(so):
    """[(function, HMMA instructions, FFMA instructions)] for every kernel
    function in the built library's SASS (`cuobjdump -sass`), mangled
    names (the two sources' instantiations of one template each
    appear)."""
    from nas_3d_unet_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = []
    for ln in sass.splitlines():
        if "Function :" in ln:
            out.append([ln.split("Function :", 1)[1].strip(), 0, 0])
        elif out and "HMMA" in ln:
            out[-1][1] += 1
        elif out and "FFMA" in ln:
            out[-1][2] += 1
    return [tuple(f) for f in out]


def sass_hmma(functions):
    """HMMA instructions in each E2 kernel's SASS, by variant."""
    counts = {}
    for fn, n, _ in functions:
        v = next((v for v in PG_VARIANTS if f"pg_{v}_kernel" in fn), None)
        if v:
            counts[v] = n
    return counts


def ptxas_report(log, kinds):
    """{"<source>: <kernel>": [registers, spill stores, spill loads]} for
    each kernel whose name holds one of `kinds`, from the ptxas -v report
    of the build log (names demangled to `kernel<args>` where `c++filt`
    is at hand)."""
    import shutil

    out, src, fn = {}, None, None
    for ln in log.splitlines():
        if " -c -o " in ln:                  # an nvcc command: its source
            src, fn = os.path.basename(ln.split()[-1]), None
        elif m := re.search(r"Compiling entry function '(\w+)'", ln):
            fn = m.group(1) if any(k in m.group(1) for k in kinds) else None
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                    r"bytes spill loads", ln)):
            out.setdefault((src, fn), [0, 0, 0])[1:] = map(int, m.groups())
        elif fn and (m := re.search(r"Used (\d+) registers", ln)):
            out.setdefault((src, fn), [0, 0, 0])[0] = int(m.group(1))
    names = [fn for _, fn in out]
    tool = shutil.which("c++filt")
    if tool and names:
        names = subprocess.run([tool], input="\n".join(names), text=True,
                               capture_output=True, timeout=60,
                               check=True).stdout.splitlines()
    short = [(re.search(r"\w+_kernel<[^>]*>", n) or re.search(".*", n))
             .group(0) for n in names]
    return {f"{src}: {name}": v for ((src, _), v), name
            in zip(out.items(), short)}


def kernels_launched(fn, *args, every=False):
    """The names of the device kernels one call of `fn` launches, from a
    `torch.profiler` trace (demangled: `(anonymous namespace)::...`):
    each name once, sorted, or with `every` each launch in launch order."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
             if e.get("cat") == "kernel"]
    return names if every else sorted(set(names))


# (kernel, device kernel it must launch, call): the tensor-core conv behind
# K1, K1-dx and K6 in bf16, the tensor-core GEMM behind K2, K7 and K4 in
# bf16, the FMA conv tile behind K1, K1-dx and K6 in fp32, the voxel-row
# FMA tile behind K2 and K7 in fp32, the FMA template behind K4 in fp32
MMA, GMMA = "conv_mma_kernel", "gemm_mma_kernel"
K5 = "stats_sums_kernel"          # K5a, K5b and masked K5b, both dtypes
CFMA, GFMA, FMA = "conv_fma_kernel", "gemm_fma_kernel", "gemm_moments_kernel"


def _sass_calls(dev, gen):
    from nas_3d_unet_tpu_torch.ops import conv3d, pgemm

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    x, w = rand(1, 16, 16, 16, 32), rand(3, 3, 3, 32, 32) * 0.06
    x3, w2 = x.view(1, -1, 32), rand(32, 16) * 0.2
    w4 = rand(2, 2, 2, 32, 16) * 0.2
    xf, wf, x3f, w2f = x.float(), w.float(), x3.float(), w2.float()
    bias = torch.randn((32,), generator=gen, device=dev)
    return [("pointwise_conv_bf16", GMMA, conv3d.pointwise_conv,
             (x, w2, None, False)),
            ("pointwise_conv_bf16", GMMA, conv3d.pointwise_conv,
             (x, w2, bias[:16], True)),
            ("conv_transpose2x_bf16", GMMA, conv3d.conv_transpose2x,
             (x, w4, True)),
            ("pointwise_conv_f32", GFMA, conv3d.pointwise_conv,
             (xf, w2f, bias[:16], True)),
            ("pointwise_conv_f32", GFMA, conv3d.pointwise_conv,
             (xf, w2f, None, False)),
            ("conv_transpose2x_f32", FMA, conv3d.conv_transpose2x,
             (xf, w4.float(), False)),
            ("conv3x3x3_bf16", MMA, pgemm.conv3x3x3, (x, w, 1)),
            ("conv3d_bf16", MMA, conv3d.conv3d, (x, w, None, 1, 1, False)),
            ("conv3d_bf16", MMA, conv3d.conv3d, (x, w, bias, 2, 2, True)),
            ("conv3x3x3_stats_bf16", MMA, pgemm.conv3x3x3_stats, (x, w, 1)),
            ("gemm_stats_bf16", GMMA, pgemm.gemm_stats, (x3, w2)),
            ("conv3x3x3_stats_f32", CFMA, pgemm.conv3x3x3_stats,
             (xf, wf, 1)),
            ("gemm_stats_f32", GFMA, pgemm.gemm_stats, (x3f, w2f)),
            ("conv3x3x3_f32", CFMA, pgemm.conv3x3x3, (xf, wf, 1)),
            ("conv3d_f32", CFMA, conv3d.conv3d,
             (xf, wf, bias, 1, 1, True)),
            ("conv3d_f32", CFMA, conv3d.conv3d, (xf, wf, None, 2, 1, False))]


def _k5_calls(dev, gen):
    """One call of each K5 form (moments, weighted_sums, and masked by y)
    in both dtypes, on aligned inputs (16-byte loads) and on views one
    element into their buffers (the scalar instantiation): [(the
    instantiation it must launch, fn, args)]."""
    from nas_3d_unet_tpu_torch.ops import stats

    calls = []
    for dtype, t, wide in ((torch.float32, "float", 4),
                           (torch.bfloat16, "__nv_bfloat16", 8)):
        for offset, vec in ((0, wide), (1, 1)):
            ts = [_offset_view(torch.randn((2, 8, 8, 8, 32), generator=gen,
                                           device=dev).to(dtype), offset)
                  for _ in range(3)]
            for n, (w, m) in ((1, ("false", "false")),
                              (2, ("true", "false")), (3, ("true", "true"))):
                fn = stats.moments if n == 1 else stats.weighted_sums
                calls.append((f"{K5}<{t}, {w}, {m}, {vec}>", fn,
                              tuple(ts[:n])))
    return calls


def k5_plans_accepted(dev):
    """The fields of `ops/stats.py`'s plan, each set one above the plan of
    a bf16 K5b call (batch 2, 8³, C 32), whose wrong plan `stats.cu`
    accepted: it must refuse every one (no launch, an error code)."""
    from nas_3d_unet_tpu_torch.ops import _cuda, stats

    g, x = (torch.zeros((2, 8 ** 3, 32), dtype=torch.bfloat16, device=dev)
            for _ in range(2))
    b, v, c = x.shape
    p = stats.plan(b, v, c, 2, 2)
    buf = torch.empty(2 + 4 * (p.nspan + 1), b, c, device=dev)
    accepted = []
    for field in p._fields:
        try:
            _cuda.run("weighted_sums_bf16", dev, g.data_ptr(), x.data_ptr(),
                      buf.data_ptr(), b, v, c,
                      *p._replace(**{field: getattr(p, field) + 1}))
        except RuntimeError:
            continue
        accepted.append(field)
    torch.cuda.synchronize()
    return accepted


def plans_agree():
    """The hand-written tiles' plans from the library against their
    mirrors: the tensor-core conv's (`conv_mma_plan`, and `conv_mma_blocks`,
    which sizes K1's moments partials) against `ops/conv_mma.py` and the
    FMA conv tile's (`conv_fma_plan`, `conv_fma_blocks`) against
    `ops/conv_fma.py` at every K1, K1-dx and K6 geometry checked (both
    dtypes run the same geometries), the GEMM's (`gemm_mma_plan`) against
    `ops/gemm_mma.py` at every K2 (moments), K7 and K4 (depth-to-space, N
    = 8·Cout) geometry, and the fp32 GEMM's (`gemm_fma_plan`) against
    `ops/gemm_fma.py` at every K2 (moments) and K7 geometry: {geometry:
    (library, mirror)} where they differ."""
    import ctypes

    from nas_3d_unet_tpu_torch.ops import (_cuda, conv_fma, conv_mma,
                                           gemm_fma, gemm_mma)

    lib = _cuda.lib()
    geoms = {(ci, co, 1, d) for ci, co, _, d, _ in K1DX_TRAIN + K1DX_EXTRA}
    geoms |= {(ci, co, s, d) for ci, co, _, s, d, _ in P_K6 + P_K6_EXTRA}
    geoms |= {(ci, co, 1, d) for ci, co, _, d, _ in K1_TRAIN + K1_EXTRA}
    bad = {}
    for g in sorted(geoms):
        out = (ctypes.c_int * 5)()
        if lib.conv_mma_plan(*g, out):
            raise AssertionError(f"conv_mma_plan refused {g}")
        p = conv_mma.plan(*g)
        mirror = [p.bn, p.brick[0], p.nbuf, p.smem, math.prod(p.halo)]
        if list(out) != mirror:
            bad[str(g)] = (list(out), mirror)
        if lib.conv_fma_plan(*g, out):
            raise AssertionError(f"conv_fma_plan refused {g}")
        p = conv_fma.plan(*g)
        mirror = [p.bn, p.brick[0], conv_fma.KC, p.nbuf, p.smem]
        if list(out) != mirror:
            bad[str(("fma", *g))] = (list(out), mirror)
    for ci, co, v, d, _ in K1_TRAIN + K1_EXTRA:
        vol = _volume(v)
        for name, tile in (("conv_mma", conv_mma), ("conv_fma", conv_fma)):
            got = getattr(lib, f"{name}_blocks")(ci, co, d, *vol)
            want = len(list(conv_mma.bricks(vol, tile.plan(ci, co, 1, d))))
            if got != want:
                bad[str((name, "blocks", ci, co, d, vol))] = (got, want)
    gemms = {(k, n, 1, 0) for k, n, _, _ in K2_TRAIN + K2_EXTRA}
    gemms |= {(c, c, 0, 0) for c, _, _ in P_K7}
    gemms |= {(ci, co, 0, 0) for ci, co, _, _ in P_K7_EXTRA}
    gemms |= {(c, 8 * c, 0, 1) for c, _, _ in P_K4}
    gemms |= {(ci, 8 * co, 0, 1) for ci, co, _, _ in P_K4_EXTRA}
    for g in sorted(gemms):
        out = (ctypes.c_int * 4)()
        if lib.gemm_mma_plan(*g, out):
            raise AssertionError(f"gemm_mma_plan refused {g}")
        p = gemm_mma.plan(g[0], g[1], bool(g[2]), bool(g[3]))
        mirror = [p.bn, p.rows, p.nchunks, p.smem]
        if list(out) != mirror:
            bad[str(("gemm", *g))] = (list(out), mirror)
    for g in sorted({g[:3] for g in gemms if not g[3]}):
        out = (ctypes.c_int * 5)()
        if lib.gemm_fma_plan(*g, out):
            raise AssertionError(f"gemm_fma_plan refused {g}")
        p = gemm_fma.plan(g[0], g[1], bool(g[2]))
        mirror = [p.bn, p.rows, p.nchunks, p.stages, p.smem]
        if list(out) != mirror:
            bad[str(("gemm_fma", *g))] = (list(out), mirror)
    return bad


def phase_sass(dev, gen, functions):
    """The bf16 convs (K1, K1-dx, K6) and GEMMs (K2, K7, K4) on the tensor
    cores: the kernels their wrappers launch are conv_mma_kernel or
    gemm_mma_kernel instantiations, each with HMMA in its SASS; the fp32
    convs on the FMA conv tile: they launch conv_fma_kernel, every
    instantiation of which has FFMA and no HMMA; K2 and K7 in fp32 on the
    voxel-row FMA tile: they launch gemm_fma_kernel, every instantiation
    of which has FFMA and no HMMA; K4 in fp32, the only caller left of the
    FMA template, launches gemm_moments_kernel, no instantiation of which
    has HMMA or is bf16.  And the kernels' plans are the ones
    `ops/conv_mma.py`, `ops/conv_fma.py`, `ops/gemm_mma.py` and
    `ops/gemm_fma.py` mirror; K5 launches one `stats_sums_kernel` a call,
    and refuses a plan other than `ops/stats.py`'s."""
    hmma = {kind: {fn: n for fn, n, _ in functions if kind in fn}
            for kind in (MMA, GMMA, CFMA, GFMA, FMA)}
    ffma = {kind: {fn: n for fn, _, n in functions if kind in fn}
            for kind in (CFMA, GFMA)}
    fma_bf16 = [fn for fn in hmma[FMA] if "nv_bfloat16" in fn]
    ok = all(hmma[MMA].values()) and all(hmma[GMMA].values()) \
        and bool(hmma[MMA]) and bool(hmma[GMMA]) \
        and all(bool(f) and all(f.values()) for f in ffma.values()) \
        and not any(hmma[CFMA].values()) and not any(hmma[GFMA].values()) \
        and not any(hmma[FMA].values()) and not fma_bf16
    launched = {}
    with torch.no_grad():
        for name, want, fn, args in _sass_calls(dev, gen):
            names = kernels_launched(fn, *args)
            launched.setdefault(name, []).extend(names)
            mains = [n for n in names if any(k in n for k in hmma)]
            ok = ok and bool(mains) and all(want in n for n in mains)
    # the FMA template is K4 fp32's alone
    ok = ok and all(name == "conv_transpose2x_f32" for name, names
                    in launched.items() for n in names if FMA in n)
    # K5: one launch a call, of the instantiation its inputs call for,
    # all in one trace
    k5_calls = _k5_calls(dev, gen)
    with torch.no_grad():
        k5 = kernels_launched(lambda: [fn(*a) for _, fn, a in k5_calls],
                              every=True)
    k5_ok = len(k5) == len(k5_calls) and all(
        want in n for (want, _, _), n in zip(k5_calls, k5))
    k5_wrong_plans = k5_plans_accepted(dev)
    plans_differ = plans_agree()
    emit({"phase": "sass", "conv_mma_hmma": hmma[MMA],
          "gemm_mma_hmma": hmma[GMMA], "conv_fma_hmma": hmma[CFMA],
          "conv_fma_ffma": ffma[CFMA], "gemm_fma_hmma": hmma[GFMA],
          "gemm_fma_ffma": ffma[GFMA], "gemm_moments_hmma": hmma[FMA],
          "gemm_moments_bf16": fma_bf16,
          "launched": launched, "plans_differ": plans_differ,
          "k5_launched": [re.search(r"\w+_kernel<[^>]*>", n).group(0)
                          if K5 in n else n for n in k5],
          "k5_wrong_plans_accepted": k5_wrong_plans,
          "ok": ok and k5_ok and not k5_wrong_plans and not plans_differ})
    if not k5_ok:
        raise AssertionError(f"K5 calls launched {k5}, not one "
                             f"{K5} each as planned")
    if k5_wrong_plans:
        raise AssertionError(f"stats.cu launched K5 on a wrong plan: "
                             f"{k5_wrong_plans} one off")
    if not ok:
        raise AssertionError("the bf16 convs and GEMMs are not all on the "
                             "tensor cores, the fp32 convs not all on the "
                             "FMA conv tile, K2/K7 fp32 not on the FMA "
                             "GEMM tile, K4 fp32 not alone on the template, "
                             "or an FMA kernel has HMMA or is bf16")
    if plans_differ:
        raise AssertionError(f"tile plans differ: {plans_differ}")


def phase_probes(dev, seed, summary, functions):
    """E1 at every rows-per-block and E2's variants at NB = 128 against
    their twins, their SASS, then the probes' entry points with the
    launch counts cleared just before and read just after."""
    from nas_3d_unet_tpu_torch.experiments import r3_dma_probe as e1
    from nas_3d_unet_tpu_torch.experiments import r3_pg_variants as e2
    from nas_3d_unet_tpu_torch.ops import _cuda

    x = e1.operand(seed, dev)
    for rpb in e1.RPB:      # per_unit 1: the row is one sweep's worth
        _run_check("probes", "copy_rows_bf16", check_copy, summary, 1, x, rpb)
    emit({"phase": "probes", "kernel": "copy_rows_bf16",
          "library": e1.library(x)})
    del x
    ops = e2.operands(seed, dev)
    for v in PG_VARIANTS:
        _run_check("probes", f"pg_{v}_bf16", check_pg, summary, 1, v, ops)
    del ops
    hmma = sass_hmma(functions)
    emit({"phase": "probes_sass", "hmma": hmma})
    if set(hmma) != set(PG_VARIANTS) or hmma["nodot"] \
            or not all(hmma[v] for v in PG_VARIANTS if v != "nodot"):
        raise AssertionError(f"E2's kernels: HMMA counts {hmma}")

    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e1.main(["--seed", str(seed)])
    e2.main(["--seed", str(seed)])
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    emit({"phase": "probes_main", "seconds": time.perf_counter() - t0,
          "launches": launches})
    names = ["copy_rows_bf16"] + [f"pg_{v}_bf16" for v in PG_VARIANTS]
    if not all(launches.get(n) for n in names):
        raise AssertionError(f"a probe kernel did not launch: {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nas_3d_unet_tpu_torch import _build
    from nas_3d_unet_tpu_torch.utils.precision import strict_fp32

    so = _build.library_path()
    so.unlink(missing_ok=True)                 # always build from the sources
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = so.with_suffix(".log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s,
          "sources": [SRC_PGEMM, SRC_CONV, SRC_STATS, SRC_GN, SRC_PROBES],
          "flags": " ".join(_build.NVCC_FLAGS), "ptxas": ptxas,
          "ptxas_tensor_core_kernels": ptxas_report(log, (MMA, GMMA)),
          "ptxas_conv_fma": ptxas_report(log, (CFMA,)),
          "ptxas_gemm_fma": ptxas_report(log, (GFMA,)),
          "ptxas_stats": ptxas_report(log, (K5,))})

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    summary = Summary()
    with strict_fp32():          # the twins and the plain convs: no TF32
        phase_kernels(dev, gen, summary)
        serve_launches, s_per_patient = phase_slice(dev, args.seed)
        phase_train_kernels(dev, gen, summary)
        train_launches, train = phase_train(dev, args.seed)
        phase_pallas_kernels(dev, gen, summary)
        p_serve_launches, p_s_per_patient = phase_slice(dev, args.seed, True)
        p_train_launches, p_train = phase_train(dev, args.seed, True)
        functions = sass_functions(so)
        probe_launches = phase_probes(dev, args.seed, summary, functions)
        phase_sass(dev, gen, functions)

    emit({"phase": "done", "s_per_patient": s_per_patient,
          "train_patches_per_s": train["patches_per_s"],
          "train_peak_mem_gb": train["peak_mem_gb"],
          "pallas_s_per_patient": p_s_per_patient,
          "pallas_train_patches_per_s": p_train["patches_per_s"],
          "pallas_train_peak_mem_gb": p_train["peak_mem_gb"],
          "card": smi, "build_s": build_s})
    # each kernel's launches in the run of its path: the default path's
    # serving and training, the use_pallas configuration's, the probes'
    kernels = [(n, serve_launches) for n in
               ("conv3x3x3_stats_f32", "gemm_stats_f32", "moments_f32")]
    kernels += [(n, train_launches) for n in
                ("conv3x3x3_stats_bf16", "conv3x3x3_bf16", "gemm_stats_bf16",
                 "moments_bf16", "weighted_sums_bf16")]
    kernels += [(f"{n}_f32", p_serve_launches) for n in
                ("conv3d", "pointwise_conv", "conv_transpose2x",
                 "group_norm_apply")]
    kernels += [(f"{n}_bf16", p_train_launches) for n in
                ("conv3d", "pointwise_conv", "conv_transpose2x",
                 "group_norm_apply", "group_norm_dx", "weighted_sums_masked")]
    kernels += [(n, probe_launches) for n in
                ["copy_rows_bf16"] + [f"pg_{v}_bf16" for v in PG_VARIANTS]]
    line = []
    for name, launches in kernels:
        base = name.rsplit("_", 1)[0]
        line.append({"name": name, "route": "cuda",
                     "source": SOURCES.get(name, SOURCES.get(base, SRC_PGEMM)),
                     "replaces": REPLACES[base], "launches": launches[name],
                     **summary.entry(name)})
    print(smi)
    print(json.dumps({"kernels": line}))
    loaded = {m.split(".")[0] for m in sys.modules}
    if loaded & {"jax", "flax", "nas_3d_unet_tpu"}:
        raise AssertionError("the JAX stack was imported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
