#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nas_3d_unet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed as JSON lines:
  1. device: CUDA must be present (else exit 2); the card's name and power
     limit from nvidia-smi.
  2. build: compiles nas_3d_unet_tpu_torch/csrc/*.cu from scratch (one
     nvcc per source, in parallel, sm_90a) and times it; then the C++
     host path's library (data/native/preproc.cpp, g++), which must
     build.
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
     from the modules) x 5; then, in a child process (a trace taken in
     this one left every later trace empty), the same step under
     `utils/profiling.py` `trace` and `annotate`, whose trace file must
     hold the annotation and device events of the hand kernels
     (`conv_mma_kernel`, `gemm_mma_kernel`, `stats_sums_kernel`), and
     `device_memory_stats` a peak above 0.
 6a. train_n: `train.steps_per_call` on phase 6's flagship, step and data
     (bf16, 128^3, batch 2, microbatch 1, flips and jitter): under cuDNN's
     deterministic algorithms and from one saved state, two calls of a
     4-step CUDA graph (`make_train_step_n`: one eager warm-up step, the
     capture, one replay a call), the LR changed between them, against 8
     eager steps: the losses, every parameter, AdamW's moments and count
     and the augmentation generator's state bit-equal, and the launches
     recorded at capture equal to (per microbatch, counted from the
     modules) x 2 x 4 (a replay enters no Python and counts none).  Then,
     with cuDNN's default settings, ungated: s a step and peak memory of
     eager steps and of 5-step replays, and the first call's seconds.
 6b. cli: the package's commands, in-process through `cli.main`, from the
     root config.json at full width (train: bf16, 128^3, batch 2,
     microbatch 1; predict: the fp32 body) with 2 epochs of 3 steps and a
     validation fraction of 0.25.  Writes 4 BraTS-layout patients (2 HGG,
     2 LGG) of 240x240x155 from --seed, runs `preprocess` (4 .npz with
     their keys; the C++ host path must have run, 4 z-scores and one box
     a patient, and a second `preprocess` under NAS3D_NO_NATIVE on the
     numpy path gives the same crops and labels and images within 1e-5;
     s/patient of both printed), `train` (finite losses, two epoch
     records, metadata.json,
     best.npz; launches = per microbatch x 12 + per forward x 16 eval
     forwards), `train` for 1 epoch in a fresh dir and again for 2, which
     resumes at step 3 (a checkpoint loaded onto the card and saved again
     is byte-equal; the resumed parameters' max |delta| against the
     uninterrupted run and how many are bit-equal are reported, not
     gated, with whether one step's gradients repeat bit for bit, as the
     path runs and with cuDNN held to deterministic algorithms, the ops
     PyTorch reports as nondeterministic, and whether the depthwise conv's
     backward and K1's cuDNN weight gradient repeat at 128^3 and 64^3),
     `train -o train.steps_per_call=3` likewise (1 epoch, then resumed to
     2: finite losses, the resume at step 3, the checkpoint), and
     `predict` from the
     first run's checkpoints (a .nii.gz of
     240x240x155 with labels in {0,1,2,4} and finite Dice per patient;
     launches = per forward x forwards), then `search` for one warmup epoch
     of 2 steps and again, resumed at step 2, for one bilevel epoch of 2
     steps with 1 eval batch (the resume event, both epoch records with
     finite losses, the checkpoint, a valid genotype.json, the
     `search_done` line).  Prints the Trainer's patches/s beside phase 6's,
     s/patient (NIfTI write included) beside phase 4's, and its own
     seconds.
 6c. search_kernels: the search's kernels against their twins at every
     geometry one bilevel step of the shipped supernet gives them (bf16,
     batch 1; S_K1, S_K1DX, S_K2, S_K5A, S_K5B): K1 at Cout = k·C for k =
     1..3 outgoing edges (16..256, dilation 1 and 2, the up cells' 16 ->
     48 at 128^3), K1-dx, K2 at the cells' projections, K5a and K5b;
     their ms per bilevel step in the line's "per_step" (a Summary of its
     own: the kernels line keeps the other paths').
 6d. search: the shipped supernet (config.json: base 16, depth 3, 3
     nodes, bf16, merged ops, random weights from --seed through the
     bridge, α from `init_alphas`) on synthetic 128^3 batches (patch 0
     trains, patch 1 is the val batch).  One bilevel step's α and w
     gradients on the kernel path against the twin path (per leaf, the
     limits of phase 6) and the shapes it hands the kernels against phase
     6c's tables; then 1 warmup step (α unchanged) and 3 timed bilevel
     steps (α moved): seconds a step, patches/s, finite losses, peak
     memory, launches equal to the count from the modules
     (`_search_per_step`) x steps; the genotype `parse_alphas` decodes,
     whose derived net runs one forward.
  6e. search_unrolled: the second-order step (`search.unrolled`, ξ =
     `search.w_lr` as config.json leaves `search.xi` 0) on phase 6d's
     supernet: its kernels against their twins at every geometry one step
     hands them (SU_ tables: three forwards, K1-dx also differentiated,
     K5a and K5b in every GroupNorm's differentiable backward); one
     step's α gradient and val loss on the kernel path against the twin
     path at ξ = PARITY_XI (100× search.w_lr, so that the second-order
     term is most of it; UNROLLED_ALPHA_LIMITS, from grad_parity.py
     --search), with that term's share; then one step noted (its geometries
     against the tables) and SU_STEPS timed at 128^3: s a step,
     patches/s, peak memory, finite losses, α moved, launches equal to
     the tables' × steps, the genotype.
 6e'. search_unrolled_pallas: the second-order step on the shipped
     supernet with model.use_pallas (K6, K7 and K4 on the edge ops, K3 for
     every GroupNorm, K1 for the stem, K2 for the projections) at 128^3,
     batch 1, bf16: its kernels against their twins at every geometry one
     step hands them (SUP_ tables: K3 dx also unmasked, as K3 dx's own
     backward runs it, the masked K5b and K5b, K5a in every K3 backward's
     rebuilt statistics); one step's α gradient and val loss on the kernel
     path against the twin path at ξ = PARITY_XI (UNROLLED_ALPHA_LIMITS;
     at SUP_PARITY_PATCH^3, where the twin path fits the card)
     with the second-order term's share, and again with K3's statistics
     held constant in its differentiated backward (a planted fault that
     must miss the limits); then one step noted (its geometries against
     the tables) and SUP_STEPS timed: s a step, patches/s, peak memory,
     finite losses, α moved, launches equal to the tables' × steps, the
     genotype.
 6f. search_pc: `search.partial_channels` 2 (the supernet rebuilt with
     pc_k 2, weights from --seed): its kernels at every geometry a
     first-order step (SPC_) and an unrolled step (SB_) hand them; a
     first-order step's α (PC_ALPHA_LIMITS) and w gradients and the
     unrolled α gradient (as 6e) against the twin path; then, as 6e,
     SPC_STEPS timed
     first-order steps and SB_STEPS timed unrolled steps (both settings).
 6g. remat: repeatability and activation checkpointing (`model.remat`
     on the cells, `model.remat_edges` on the supernet's edges) at full
     width on one rank, under cuDNN's deterministic algorithms: the
     derived bf16 train step (batch 2 of 128^3, microbatch 1; remat off
     and on the cells), the shipped supernet's first-order step (128^3,
     batch 1) and second-order step (REMAT_SECOND_PATCH^3; off, cells,
     cells and edges) and its PC step (pc_k 2, first-order, 128^3; off
     only), one step's gradients each (nothing updated).  Remat off runs REPEAT_RUNS times: one
     digest of the gradients and losses means the step repeats.  For a
     step that does not, one more run under
     `torch.use_deterministic_algorithms(True, warn_only=True)` names the
     ops without a deterministic implementation, and the phase fails
     unless one is named.  A setting's
     gradients must equal remat off's bit for bit where the step repeats;
     where it does not (the op named in the reason), they must lie within
     the step's limits.  Launches equal to remat off's plus the
     checkpointed regions' forward kernels (K1, K2, K5a, counted from the
     modules, `remat_per_forward`) once per backward through them (2 a
     train step, 2 a first-order step, 4 a second-order one), peak memory
     and seconds of each.
 6h. dp: data parallelism, DP_WORLD ranks (processes of this script,
     `--dp-rank`) on card 0 over gloo, which carries CUDA tensors (NCCL
     refuses two ranks on one device), global batch 2: the first step's
     averaged gradients of the derived train step, the first-order and
     pc_k 2 search steps at 128^3 and the second-order step (remat on the
     cells and edges, ξ = PARITY_XI, the rows' masks of different
     density) at DP_UNROLLED_PATCH^3 against this process's one-process
     step at the global batch (the per-leaf limits of phases 6, 6d, 6f
     and 6e), both ranks' bit-equal; the second-order step with a planted
     fault, its inner gradient not averaged, must fail those limits; DP_STEPS train steps with
     AdamW and augmentation (the ranks' parameters bit-equal, launches
     per rank equal to the modules' count); a Trainer epoch and
     `predict_dataset` over phase "cli"'s store (the ranks' histories and
     parameters equal, every patient's labels bit-equal to phase "cli"'s
     one-process predictions); then the `train` command under torchrun at
     world 1 on this card (NCCL), and at 2 ranks where there are 2 cards.
 6i. spatial: spatial sharding at data 1 x spatial SP_WORLD: SP_WORLD
     ranks (processes of this script, `--sp-rank`) on card 0 over gloo,
     each holding a D-slab of the same rows (halo exchanges and
     cross-slab sums, `parallel/spatial.py`), against this process's
     one-process runs: the first step's gradients of the bf16 flagship
     train step (128^3, batch 2) and of its `use_pallas` twin (the
     limits of phases 6 and 9), and the first-order search step's α
     (ALPHA_LIMITS) and w gradients (128^3, batch 1), and the
     second-order step's (DP_UNROLLED_PATCH^3, batch 1, ξ = SP_SECOND_XI,
     UNROLLED_ALPHA_LIMITS), the ranks' reduced gradients bit-equal; two
     planted faults must fail their limits: the GroupNorm moments left
     un-reduced in the forward (the train step's), and the loss sums'
     identity adjoint kept in the second-order step's inner graph;
     SP_STEPS train steps with AdamW and augmentation (the ranks'
     parameters bit-equal); `predict_labels` of a synthetic
     160x192x152 patient, each rank stitching its D-slab, bit-equal to one
     process's labels.  Per rank and run: exact launch counts (the
     one-process step's with K1's moments moved to K1-dx's kernel and
     K5a, `spatial_launches`), s a step, peak GB.  Both ranks share one
     card: not scaling numbers.
 6j. quality: the chip-scale twins of experiments/r4_learn_chip.py and
     r5_genotype_chip.py through the commands, on NIfTI written from
     --seed (4 patients of 96x112x80, 64^3 patches, batch 1, the shipped
     bf16 body at base 16, depth 3, 3 nodes): (a) `preprocess`, `train`
     (default genotype, 4 x 50 steps, lr 1e-3) and `predict` on the
     learnable blob task, mean WT Dice >= 0.7; (b) the shift task (the
     label is the t1ce blob shifted by +6 voxels an axis; no
     augmentation): `search` (3 x 40 steps, 1 warmup epoch, α lr 3e-2;
     r5's 5 x 40 does not fit the script's time), `train` of the
     searched genotype (4 x 50) and `predict`, WT >= 0.7 and >= 3
     conv-family ops in the genotype; (c) the same search on the noise
     control (the label blob placed apart from the image's): the signal's
     final conv mass above the control's.  The patients are written and
     preprocessed first; then each task's commands run in a child
     process beside phases 6h and 6i (whose s a step then share the
     card with them), under cuDNN's deterministic algorithms.  The native preprocessing
     ran, and every search and train launched K1, K1-dx, K2, K5a and
     K5b (each child prints its launches).
     Prints Dice, conv counts, conv and none masses, and each stage's
     seconds.
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
     12 -> 5 (scalar), and 64 -> 64 with ReLU); K7 and K4 in fp32 run
     the voxel-row FMA tile (K4 with its depth-to-space store); K3's
     apply (fp32 and bf16) and dx (bf16); K7's, K4's and K3's records, as
     K2's, also hold their device ms and host ms (`device_ms`: the calls
     queued behind a spin kernel, so the device's time and the host's are
     each timed alone; the call's `ms` holds both), and their library
     call's, summed per unit with K2's in the line "pallas_device_split";
     K5b masked by y > 0 (K3's backward sums, bf16); K5a at the
     configuration's own geometries; and off the path every K5 form in
     both dtypes at K5_EXTRA (the ragged volume at C 12 and 7, the scalar
     loads, and inputs one element into their buffers, not 16-byte
     aligned).  Every K5 record (phases 3, 5
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
     its SASS, one such kernel a call; K1, K1-dx and K6 (stride 1 and 2)
     in fp32 launch the FMA conv tile (`conv_fma_kernel`), every
     instantiation of which has FFMA and no HMMA in its SASS; K2, K7 and
     K4 in fp32 launch the voxel-row FMA tile (`gemm_fma_kernel`: K2 its
     STATS instantiation, K7 a plain one, K4 a D2S one), every
     instantiation of which has FFMA and no HMMA; the conv tiles' plans
     and brick counts equal `ops/conv_mma.py`'s and `ops/conv_fma.py`'s
     mirrors at every K1, K1-dx and K6 geometry checked, the GEMM tiles'
     plans `ops/gemm_mma.py`'s and `ops/gemm_fma.py`'s at every K2, K7
     and K4 geometry; and one call of each K5 form in both dtypes,
     aligned and not, in one trace, launches exactly one kernel,
     `stats_sums_kernel` with the planned loads, and `stats.cu` refuses a
     plan with any field one off `ops/stats.py`'s.  A trace that comes
     back holding no kernel at all is taken again (up to 3 times; the
     record lists the retakes under "trace_retakes").
The "done" line also holds each search phase's s a step, patches/s, peak
memory and launches a step, the search phases' seconds, each remat
setting's s a step and peak memory, phase "dp"'s seconds, world, backend
and s a train step per rank, phase "spatial"'s seconds, s a train
step and s of the second-order step per rank, and the whole script's.
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
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
           "pointwise_conv_f32": SRC_GFMA, "conv_transpose2x_f32": SRC_GFMA}
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

# The search (phases "search_kernels" and "search"): the shipped supernet
# (config.json: base 16, depth 3, 3 nodes, GroupNorm 8, bf16, merged ops)
# at 128^3, search batch 1; launches per bilevel step (the α-step's
# forward and backward, then the w-step's).  Sources of k outgoing edges
# run conv3 / dil_conv3 / up_conv3 as one k·C-wide K1 (C·k = 16..256).
# K1 and K1-dx: (Cin, Cout, edge, dilation, launches) as `noting_kernels`
# keys them (K1-dx: dy's channels, then dx's)
S_K1 = [(4, 48, 128, 1, 2), (16, 16, 128, 1, 2), (16, 16, 128, 2, 2),
        (16, 32, 128, 1, 2), (16, 32, 128, 2, 2), (16, 48, 128, 1, 4),
        (16, 48, 128, 2, 2), (32, 32, 64, 1, 4), (32, 32, 64, 2, 4),
        (32, 64, 64, 1, 4), (32, 64, 64, 2, 4), (32, 96, 64, 1, 4),
        (32, 96, 64, 2, 2), (64, 64, 32, 1, 4), (64, 64, 32, 2, 4),
        (64, 128, 32, 1, 4), (64, 128, 32, 2, 4), (64, 192, 32, 1, 4),
        (64, 192, 32, 2, 2), (128, 128, 16, 1, 2), (128, 128, 16, 2, 2),
        (128, 256, 16, 1, 2), (128, 256, 16, 2, 2)]
S_K1DX = [(16, 16, 128, 1, 2), (16, 16, 128, 2, 2), (32, 16, 128, 1, 2),
          (32, 16, 128, 2, 2), (32, 32, 64, 1, 4), (32, 32, 64, 2, 4),
          (48, 16, 128, 1, 3), (48, 16, 128, 2, 1), (64, 32, 64, 1, 4),
          (64, 32, 64, 2, 4), (64, 64, 32, 1, 4), (64, 64, 32, 2, 4),
          (96, 32, 64, 1, 4), (96, 32, 64, 2, 2), (128, 64, 32, 1, 4),
          (128, 64, 32, 2, 4), (128, 128, 16, 1, 2), (128, 128, 16, 2, 2),
          (192, 64, 32, 1, 4), (192, 64, 32, 2, 2), (256, 128, 16, 1, 2),
          (256, 128, 16, 2, 2)]
# K2: (K, N, edge, launches); K5a, K5b: (C, edge, launches)
S_K2 = [(48, 16, 128, 2), (48, 32, 128, 4), (96, 16, 64, 2), (96, 32, 64, 2),
        (96, 64, 64, 2), (192, 32, 32, 2), (192, 64, 32, 2),
        (192, 128, 32, 2), (384, 64, 16, 2)]
S_K5A = [(16, 128, 18), (32, 64, 36), (48, 128, 2), (64, 32, 36),
         (64, 64, 2), (96, 64, 10), (128, 16, 18), (128, 32, 2),
         (192, 32, 10), (384, 16, 8)]
S_K5B = [(16, 64, 2), (16, 128, 20), (32, 32, 2), (32, 64, 40),
         (32, 128, 6), (48, 128, 7), (64, 16, 2), (64, 32, 43),
         (64, 64, 11), (96, 64, 12), (128, 16, 22), (128, 32, 12),
         (192, 32, 14), (256, 16, 4), (384, 16, 8)]
SEARCH_BATCH = 1
SEARCH_WARMUP_STEPS, SEARCH_STEPS = 1, 3
S_TABLES = [("conv3x3x3_stats", S_K1), ("conv3x3x3", S_K1DX),
            ("gemm_stats", S_K2), ("moments", S_K5A), ("weighted_sums", S_K5B)]
# Phase "search_unrolled": launches per second-order step (SU_), the
# virtual step's forward and its backward with a graph, the val forward
# on the virtual weights and the α gradient back through both, then the
# w-step.  Three forwards where the first-order step runs two: K1 and K2
# launch 3/2 as often at the same geometries.  Under the graph every
# GroupNorm backward runs K5a (its statistics rebuilt) and K5b, and K1-dx
# is differentiated: K1-dx again with the other flip, (Cin, Cout) as K1's.
# Phase "search_pc": a first-order step with search.partial_channels 2
# (SPC_: the candidates at C/2, K1 from Cin = 8), and an unrolled step of
# that supernet (SB_: both settings, K1 and K2 3/2 of SPC_'s).
SU_K1DX = [(16, 16, 128, 1, 5), (16, 16, 128, 2, 5), (16, 32, 128, 1, 1),
           (16, 32, 128, 2, 1), (16, 48, 128, 1, 2), (16, 48, 128, 2, 1),
           (32, 16, 128, 1, 4), (32, 16, 128, 2, 4), (32, 32, 64, 1, 10),
           (32, 32, 64, 2, 10), (32, 64, 64, 1, 2), (32, 64, 64, 2, 2),
           (32, 96, 64, 1, 2), (32, 96, 64, 2, 1), (48, 16, 128, 1, 7),
           (48, 16, 128, 2, 3), (64, 32, 64, 1, 8), (64, 32, 64, 2, 8),
           (64, 64, 32, 1, 10), (64, 64, 32, 2, 10), (64, 128, 32, 1, 2),
           (64, 128, 32, 2, 2), (64, 192, 32, 1, 2), (64, 192, 32, 2, 1),
           (96, 32, 64, 1, 8), (96, 32, 64, 2, 4), (128, 64, 32, 1, 8),
           (128, 64, 32, 2, 8), (128, 128, 16, 1, 5), (128, 128, 16, 2, 5),
           (128, 256, 16, 1, 1), (128, 256, 16, 2, 1), (192, 64, 32, 1, 8),
           (192, 64, 32, 2, 4), (256, 128, 16, 1, 4), (256, 128, 16, 2, 4)]
SU_K5A = [(16, 64, 1), (16, 128, 39), (32, 32, 1), (32, 64, 77), (32, 128, 4),
          (48, 128, 8), (64, 16, 1), (64, 32, 77), (64, 64, 9), (96, 64, 23),
          (128, 16, 38), (128, 32, 9), (192, 32, 23), (256, 16, 2),
          (384, 16, 16)]
SU_K5B = [(16, 64, 4), (16, 128, 44), (32, 32, 4), (32, 64, 86),
          (32, 128, 14), (48, 128, 17), (64, 16, 4), (64, 32, 89),
          (64, 64, 23), (96, 64, 28), (128, 16, 44), (128, 32, 24),
          (192, 32, 30), (256, 16, 8), (384, 16, 16)]
SPC_K1 = [(4, 48, 128, 1, 2), (8, 8, 128, 1, 2), (8, 8, 128, 2, 2),
          (8, 16, 128, 1, 2), (8, 16, 128, 2, 2), (8, 24, 128, 1, 4),
          (8, 24, 128, 2, 2), (16, 16, 64, 1, 4), (16, 16, 64, 2, 4),
          (16, 32, 64, 1, 4), (16, 32, 64, 2, 4), (16, 48, 64, 1, 4),
          (16, 48, 64, 2, 2), (32, 32, 32, 1, 4), (32, 32, 32, 2, 4),
          (32, 64, 32, 1, 4), (32, 64, 32, 2, 4), (32, 96, 32, 1, 4),
          (32, 96, 32, 2, 2), (64, 64, 16, 1, 2), (64, 64, 16, 2, 2),
          (64, 128, 16, 1, 2), (64, 128, 16, 2, 2)]
SPC_K1DX = [(8, 8, 128, 1, 2), (8, 8, 128, 2, 2), (16, 8, 128, 1, 2),
            (16, 8, 128, 2, 2), (16, 16, 64, 1, 4), (16, 16, 64, 2, 4),
            (24, 8, 128, 1, 3), (24, 8, 128, 2, 1), (32, 16, 64, 1, 4),
            (32, 16, 64, 2, 4), (32, 32, 32, 1, 4), (32, 32, 32, 2, 4),
            (48, 16, 64, 1, 4), (48, 16, 64, 2, 2), (64, 32, 32, 1, 4),
            (64, 32, 32, 2, 4), (64, 64, 16, 1, 2), (64, 64, 16, 2, 2),
            (96, 32, 32, 1, 4), (96, 32, 32, 2, 2), (128, 64, 16, 1, 2),
            (128, 64, 16, 2, 2)]
SPC_K2 = [(48, 16, 128, 2), (48, 32, 128, 4), (96, 16, 64, 2),
          (96, 32, 64, 2), (96, 64, 64, 2), (192, 32, 32, 2),
          (192, 64, 32, 2), (192, 128, 32, 2), (384, 64, 16, 2)]
SPC_K5A = [(8, 128, 18), (16, 64, 36), (24, 128, 2), (32, 32, 36),
           (48, 64, 10), (64, 16, 18), (64, 64, 2), (96, 32, 10),
           (128, 32, 2), (192, 16, 8)]
SPC_K5B = [(8, 128, 19), (16, 64, 40), (16, 128, 5), (24, 128, 6),
           (32, 32, 43), (32, 64, 10), (32, 128, 2), (48, 64, 12),
           (48, 128, 1), (64, 16, 24), (64, 32, 10), (64, 64, 3),
           (96, 32, 14), (128, 16, 4), (128, 32, 4), (192, 16, 8)]
SB_K1DX = [(8, 8, 128, 1, 5), (8, 8, 128, 2, 5), (8, 16, 128, 1, 1),
           (8, 16, 128, 2, 1), (8, 24, 128, 1, 2), (8, 24, 128, 2, 1),
           (16, 8, 128, 1, 4), (16, 8, 128, 2, 4), (16, 16, 64, 1, 10),
           (16, 16, 64, 2, 10), (16, 32, 64, 1, 2), (16, 32, 64, 2, 2),
           (16, 48, 64, 1, 2), (16, 48, 64, 2, 1), (24, 8, 128, 1, 7),
           (24, 8, 128, 2, 3), (32, 16, 64, 1, 8), (32, 16, 64, 2, 8),
           (32, 32, 32, 1, 10), (32, 32, 32, 2, 10), (32, 64, 32, 1, 2),
           (32, 64, 32, 2, 2), (32, 96, 32, 1, 2), (32, 96, 32, 2, 1),
           (48, 16, 64, 1, 8), (48, 16, 64, 2, 4), (64, 32, 32, 1, 8),
           (64, 32, 32, 2, 8), (64, 64, 16, 1, 5), (64, 64, 16, 2, 5),
           (64, 128, 16, 1, 1), (64, 128, 16, 2, 1), (96, 32, 32, 1, 8),
           (96, 32, 32, 2, 4), (128, 64, 16, 1, 4), (128, 64, 16, 2, 4)]
SB_K5A = [(8, 128, 38), (16, 64, 77), (16, 128, 3), (24, 128, 7),
          (32, 32, 77), (32, 64, 5), (32, 128, 2), (48, 64, 23), (48, 128, 1),
          (64, 16, 39), (64, 32, 5), (64, 64, 5), (96, 32, 23), (128, 16, 2),
          (128, 32, 5), (192, 16, 16)]
SB_K5B = [(8, 128, 41), (16, 64, 86), (16, 128, 11), (24, 128, 14),
          (32, 32, 89), (32, 64, 20), (32, 128, 6), (48, 64, 28),
          (48, 128, 3), (64, 16, 48), (64, 32, 20), (64, 64, 7), (96, 32, 30),
          (128, 16, 8), (128, 32, 8), (192, 16, 16)]
SU_K1 = [(*r[:-1], r[-1] * 3 // 2) for r in S_K1]
SU_K2 = [(*r[:-1], r[-1] * 3 // 2) for r in S_K2]
SB_K1 = [(*r[:-1], r[-1] * 3 // 2) for r in SPC_K1]
SB_K2 = [(*r[:-1], r[-1] * 3 // 2) for r in SPC_K2]
SU_TABLES = [("conv3x3x3_stats", SU_K1), ("conv3x3x3", SU_K1DX),
             ("gemm_stats", SU_K2), ("moments", SU_K5A),
             ("weighted_sums", SU_K5B)]
SPC_TABLES = [("conv3x3x3_stats", SPC_K1), ("conv3x3x3", SPC_K1DX),
              ("gemm_stats", SPC_K2), ("moments", SPC_K5A),
              ("weighted_sums", SPC_K5B)]
SB_TABLES = [("conv3x3x3_stats", SB_K1), ("conv3x3x3", SB_K1DX),
             ("gemm_stats", SB_K2), ("moments", SB_K5A),
             ("weighted_sums", SB_K5B)]
SU_STEPS, SPC_STEPS, SB_STEPS = 1, 3, 1    # timed, after one noted step
# Phase "search_unrolled_pallas": launches per second-order step of the
# shipped supernet with model.use_pallas (SUP_; counted by `noting_kernels`
# on the CPU at 16^3, the edges times 8, and the same at 32^3 times 4).
# The stem alone runs K1 (its input needs no dx, so no K1-dx), the 1³
# projections K2; the edge ops' 3³ convs run K6 (Cin, Cout, edge, stride,
# dilation: the merged ops at Cout k·C), the separable convs' pointwise
# K7 and the up ops K4 (C, edge); every GroupNorm is K3.  Under the graph
# each K3 backward rebuilds its statistics (K5a), takes the masked K5b and
# launches K3 dx through `_GroupNormDx`, whose own backward launches K3 dx
# twice (masked for g; unmasked, SUP_K3DXU, for x), the masked K5b (for
# A) and K5b (for B and C).
SUP_K1 = [(4, 48, 128, 1, 3)]
SUP_K2 = [(48, 16, 128, 3), (48, 32, 128, 6), (96, 16, 64, 3), (96, 32, 64, 3),
          (96, 64, 64, 3), (192, 32, 32, 3), (192, 64, 32, 3),
          (192, 128, 32, 3), (384, 64, 16, 3)]
SUP_K6 = [(16, 16, 128, 1, 1, 3), (16, 16, 128, 1, 2, 3),
          (16, 32, 128, 1, 1, 3), (16, 32, 128, 1, 2, 3),
          (16, 48, 128, 1, 1, 6), (16, 48, 128, 1, 2, 3),
          (32, 32, 64, 1, 1, 6), (32, 32, 64, 1, 2, 6), (32, 64, 64, 1, 1, 6),
          (32, 64, 64, 1, 2, 6), (32, 96, 64, 1, 1, 6), (32, 96, 64, 1, 2, 3),
          (32, 96, 128, 2, 1, 6), (32, 96, 128, 2, 2, 6),
          (64, 64, 32, 1, 1, 6), (64, 64, 32, 1, 2, 6), (64, 128, 32, 1, 1, 6),
          (64, 128, 32, 1, 2, 6), (64, 192, 32, 1, 1, 6),
          (64, 192, 32, 1, 2, 3), (64, 192, 64, 2, 1, 6),
          (64, 192, 64, 2, 2, 6), (128, 128, 16, 1, 1, 3),
          (128, 128, 16, 1, 2, 3), (128, 256, 16, 1, 1, 3),
          (128, 256, 16, 1, 2, 3), (128, 384, 32, 2, 1, 6),
          (128, 384, 32, 2, 2, 6)]
SUP_K7 = [(16, 128, 27), (32, 64, 54), (64, 32, 54), (128, 16, 27)]
SUP_K4 = [(16, 64, 3), (32, 32, 3), (64, 16, 3)]
SUP_K3 = [(16, 64, 3), (16, 128, 36), (32, 32, 3), (32, 64, 69), (32, 128, 12),
          (48, 128, 15), (64, 16, 3), (64, 32, 69), (64, 64, 18), (96, 64, 24),
          (128, 16, 33), (128, 32, 18), (192, 32, 24), (256, 16, 6),
          (384, 16, 12)]
SUP_K3DX = [(16, 64, 5), (16, 128, 56), (32, 32, 5), (32, 64, 109),
            (32, 128, 18), (48, 128, 22), (64, 16, 5), (64, 32, 112),
            (64, 64, 29), (96, 64, 36), (128, 16, 55), (128, 32, 30),
            (192, 32, 38), (256, 16, 10), (384, 16, 20)]
SUP_K3DXU = [(16, 64, 1), (16, 128, 12), (32, 32, 1), (32, 64, 23),
             (32, 128, 4), (48, 128, 5), (64, 16, 1), (64, 32, 23),
             (64, 64, 6), (96, 64, 8), (128, 16, 11), (128, 32, 6),
             (192, 32, 8), (256, 16, 2), (384, 16, 4)]
SUP_K5A = [(16, 64, 1), (16, 128, 45), (32, 32, 1), (32, 64, 89),
           (32, 128, 10), (48, 128, 17), (64, 16, 1), (64, 32, 89),
           (64, 64, 21), (96, 64, 32), (128, 16, 44), (128, 32, 21),
           (192, 32, 32), (256, 16, 8), (384, 16, 16)]
SUP_K5B = [(16, 64, 1), (16, 128, 12), (32, 32, 1), (32, 64, 23), (32, 128, 4),
           (48, 128, 5), (64, 16, 1), (64, 32, 23), (64, 64, 6), (96, 64, 8),
           (128, 16, 11), (128, 32, 6), (192, 32, 8), (256, 16, 2),
           (384, 16, 4)]
SUP_K5BM = [(16, 64, 5), (16, 128, 56), (32, 32, 5), (32, 64, 109),
            (32, 128, 18), (48, 128, 22), (64, 16, 5), (64, 32, 112),
            (64, 64, 29), (96, 64, 36), (128, 16, 55), (128, 32, 30),
            (192, 32, 38), (256, 16, 10), (384, 16, 20)]
SUP_TABLES = [("conv3x3x3_stats", SUP_K1), ("gemm_stats", SUP_K2),
              ("conv3d", SUP_K6), ("pointwise_conv", SUP_K7),
              ("conv_transpose2x", SUP_K4), ("group_norm_apply", SUP_K3),
              ("group_norm_dx", SUP_K3DX),
              ("group_norm_dx_unmasked", SUP_K3DXU), ("moments", SUP_K5A),
              ("weighted_sums", SUP_K5B), ("weighted_sums_masked", SUP_K5BM)]
SUP_STEPS = 1
# the use_pallas step's α parity runs at this patch: at 128^3 the twin
# path (plain autograd through K3's twin, fp32 copies of every GroupNorm's
# input in the recorded backward) ran out of the card's 80 GB; at 96^3 it
# took 35.4 GB, the kernel path 16.2 (NVIDIA H100 80GB HBM3, 700 W)
SUP_PARITY_PATCH = 96
# the launch counter's name of a table's kernel where the two differ
LAUNCH_NAME = {"group_norm_dx_unmasked": "group_norm_dx"}
# phase "cli"'s search: 2 steps an epoch, 1 warmup epoch (run 1), then
# resumed for 1 bilevel epoch with 1 eval batch (run 2)
CLI_SEARCH = ["search.steps_per_epoch=2", "search.warmup_epochs=1",
              "search.val_steps=1"]

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
GRAD_LIMITS = (GRAD_REL_L2, GRAD_REL_L2_MEDIAN, GRAD_COS)
P_GRAD_LIMITS = (P_GRAD_REL_L2, P_GRAD_REL_L2_MEDIAN, P_GRAD_COS)
# The search's α gradients (grad_parity.py --search, H100, seeds 0-3 and
# planted α faults), see PERF.md: a first-order step of the shipped
# supernet (ALPHA_) and of its pc_k 2 twin (PC_ALPHA_), and the
# second-order step of either at PARITY_XI (UNROLLED_ALPHA_).  PARITY_XI
# is 100× search.w_lr: the second-order term is then ~3/4 of the α
# gradient, where at ξ = w_lr (2 %) bf16 rounding hides it.
# Each is (rel. L2 max, its median, cosine min), between the sound worst
# and the planted faults' nearest; PERF.md §6 has the readings.
ALPHA_LIMITS = (0.02, 0.015, 0.9998)
PC_ALPHA_LIMITS = (0.1, 0.012, 0.995)
UNROLLED_ALPHA_LIMITS = (0.15, 0.06, 0.99)
PARITY_XI = 0.03
N_PATIENTS = 3               # timed patients, after one warm-up patient
SHAPE = (160, 192, 152)      # a cropped BraTS volume, as bench.py serves
PATCH, OVERLAP, PATCH_BATCH = (128, 128, 128), 0.5, 2
TRAIN_PATCH, TRAIN_BATCH = 128, 2
WARMUP_STEPS, TIMED_STEPS = 3, 5
AUGMENT = dict(flip_prob=0.5, intensity_shift=0.1, intensity_scale=0.1)
# phase "cli": raw BraTS-layout patients (2 HGG, 2 LGG) of the scanner's
# geometry, trained from the root config.json with these overrides
RAW_SHAPE = (240, 240, 155)
CLI_PATIENTS = 4
CLI_OVERRIDES = ["train.epochs=2", "train.steps_per_epoch=3",
                 "data.val_fraction=0.25"]
CLI_VAL_STEPS = 8            # Trainer.train's default, as the CLI runs it
NPZ_KEYS = {"image", "label", "crop_start", "orig_shape", "affine",
            "patient", "modalities"}

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
    ctypes).  Where the device caught up with the host (the spin too
    short to hide it: a slow call, or the host held up), the loop runs
    again behind a spin 4 times as long; raises if that is caught up too."""
    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for spin in (spin_cycles, 4 * spin_cycles):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        host = (time.perf_counter() - t0) * 1e3 / iters
        end.record()
        ahead = not start.query()   # still spinning: the host was ahead
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters, host
    raise AssertionError("device_ms: the host did not stay ahead")


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


def check_gn(dev, gen, name, c, v, batch, dtype, masked=True):
    """K3's apply (`y = relu(x·s + t)`, library: F.group_norm with its
    statistics, on the permuted tensor) or dx (`a·g + b·x + c`, g masked
    by y > 0; unmasked with `masked` False, as K3 dx's own backward runs
    it) against its twin at one geometry, as the flagship calls them (ReLU
    fused)."""
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
        if not masked:
            y = torch.ones_like(y)
        args = (g, x, y if masked else None, vec(), vec(), vec())
        kernel, twin = groupnorm.group_norm_dx, groupnorm.group_norm_dx_twin
        # library: the whole GroupNorm backward's dx (which also takes its
        # own sums), with the ReLU mask applied to g, on NCDHW copies and
        # the statistics and γ of x from native_group_norm
        groups = min(8, c)
        gamma = (vec()[0] * 0.5 + 1).to(dtype)
        gc, xc, yc = map(_ncdhw, (g, x, y))   # y all ones: unmasked
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
        times.update(split_ms(kernel, library, args))
    torch.cuda.synchronize()
    if not masked:
        nbytes -= n * e                 # no y to read
    rec = {"c": c, "volume": v, "batch": batch, "masked": masked,
           "bitwise_repeatable": rep, **_y_check(yk, yt), **times}
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
                              "conv_transpose2x", "group_norm_apply")
         for t in ("f32", "bf16")] + ["group_norm_dx_bf16"]}})


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

    def k6_noted(x, w, b, stride, dilation, relu, pads=None):
        seen[("conv3d", x.shape[4], w.shape[4], x.shape[1], stride,
              dilation)] += 1
        return k6(x, w, b, stride, dilation, relu, pads)

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
        # unmasked: the b·x term of K3 dx's own backward (`_GroupNormDx`)
        name = "group_norm_dx" if y is not None else "group_norm_dx_unmasked"
        seen[(name, x.shape[-1], x.shape[1])] += 1
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

    def keep_labels(volume, threshold=0.5, mesh=None):
        out = predict_labels(volume, threshold=threshold, mesh=mesh)
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


def leaf_stats(names, kernel, twin, limits=None):
    """Gradients of the kernel path against the twin path, leaf by leaf:
    the relative L2 distance ‖g_k − g_t‖ / ‖g_t‖ (its largest and its
    median), the cosine, and the relative difference of the norms.  `ok`
    holds all but the last to `limits` (rel. L2, its median, cosine;
    default the derived net's weight limits)."""
    rel, cos, norm_rel = [], [], []
    for gk, gt in zip(kernel, twin):
        gk, gt = gk.double(), gt.double()
        nk, nt = gk.norm().item(), gt.norm().item()
        rel.append((gk - gt).norm().item() / max(nt, 1e-30))
        cos.append((gk.flatten() @ gt.flatten()).item()
                   / max(nk * nt, 1e-30))
        norm_rel.append(abs(nk - nt) / max(nt, 1e-30))
    worst, least = int(np.argmax(rel)), int(np.argmin(cos))
    vals = rel + cos + norm_rel
    lim_rel, lim_med, lim_cos = limits or GRAD_LIMITS
    return {"leaves": len(rel), "grad_rel_l2_max": rel[worst],
            "rel_l2_worst_leaf": names[worst],
            "grad_rel_l2_median": float(np.median(rel)),
            "grad_cos_min": cos[least], "cos_worst_leaf": names[least],
            "grad_norm_rel_max": max(norm_rel),
            "limits": {"rel_l2": lim_rel, "rel_l2_median": lim_med,
                       "cos": lim_cos},
            "ok": bool(all(map(math.isfinite, vals))
                       and rel[worst] <= lim_rel
                       and np.median(rel) <= lim_med
                       and cos[least] >= lim_cos)}


def grad_parity(net, x, y, kernel_ctx=None, use_pallas=False):
    """One step's gradients on the kernel path (inside `kernel_ctx`) and on
    the twin path, leaf by leaf (`leaf_stats`)."""
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
    return {"loss_kernel": out["kernel"][0], "loss_twin": out["twin"][0],
            **leaf_stats(names, out["kernel"][1], out["twin"][1],
                         P_GRAD_LIMITS if use_pallas else GRAD_LIMITS)}


TRACE_ANNOTATION = "chip_smoke.train_step"
# the hand kernels' device functions a train step launches (K1 and K1-dx
# on the tensor-core conv, K2 on the tensor-core GEMM, K5a/K5b)
TRACE_KERNELS = ("conv_mma_kernel", "gemm_mma_kernel", "stats_sums_kernel")


def traced_step(dev, step):
    """One warm `step()` under `utils/profiling.py`'s `trace` and
    `annotate`: the trace file it writes holds the annotation and the
    hand kernels' device events; `device_memory_stats` has a peak."""
    from nas_3d_unet_tpu_torch.utils.profiling import (annotate,
                                                       device_memory_stats,
                                                       trace)

    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir):
            with annotate(TRACE_ANNOTATION):
                step().item()
        files = os.listdir(log_dir)
        with open(os.path.join(log_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    rec = {"trace_files": files,
           "annotation_events": sorted({e.get("cat") for e in events
                                        if e.get("name") == TRACE_ANNOTATION}),
           "hand_kernel_events": {k: sum(k in n for n in kernels)
                                  for k in TRACE_KERNELS},
           "kernel_events": len(kernels),
           "peak_allocated_gb": device_memory_stats(dev).get(
               "allocated_bytes.all.peak", 0) / 2 ** 30}
    if len(files) != 1 or not rec["annotation_events"] \
            or not all(rec["hand_kernel_events"].values()) \
            or not rec["peak_allocated_gb"] > 0:
        raise AssertionError(f"traced train step: {rec}")
    return rec


def trace_step_main(args) -> int:
    """The traced train step in a process of its own (`--trace-dir`): the
    flagship bf16 step as phase "train" runs it, two warm steps, then
    `traced_step`; the record goes to <trace-dir>/traced_step.json.  In
    the script's own process, every `torch.profiler` trace taken after
    this one held no kernel (phase "sass")."""
    from nas_3d_unet_tpu_torch import _build
    from nas_3d_unet_tpu_torch.train.loop import make_train_step
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer
    from nas_3d_unet_tpu_torch.utils.precision import strict_fp32

    dev = torch.device(args.trace_device)
    _build.load()
    with strict_fp32():
        net = flagship_net(args.seed, "bfloat16").to(dev)
        step = make_train_step(net, make_optimizer(net.parameters(), 3e-4,
                                                   1e-4),
                               augment=AUGMENT, microbatch=MICRO,
                               seed=args.seed)
        x, y = synthetic_batch(dev, args.seed)
        for _ in range(2):
            step(x, y).item()
        rec = traced_step(dev, lambda: step(x, y))
    with open(os.path.join(args.trace_dir, "traced_step.json"), "w") as f:
        json.dump(rec, f)
    return 0


def traced_in_child(dev, seed):
    """`trace_step_main` in a child process of this script; its record."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--trace-dir", tmp, "--trace-device", str(dev)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"traced train step: exit "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        with open(os.path.join(tmp, "traced_step.json")) as f:
            return json.load(f)


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
    traced = None if use_pallas else traced_in_child(dev, seed)
    rec = {"phase": phase, "batch": TRAIN_BATCH, "patch": TRAIN_PATCH,
           "microbatch": MICRO, "dtype": "bfloat16",
           "patches_per_s": TRAIN_BATCH / step_s, "step_s": step_s,
           "warmup_losses": warm, "warmup_s": warm_s, "losses": losses,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "launches_per_microbatch": per, "launches": launches,
           "expected_launches": expected, "traced_step": traced}
    emit(rec)
    if not all(map(math.isfinite, warm + losses)):
        raise AssertionError(f"non-finite loss {warm + losses}")
    if per != PER_FORWARD[use_pallas] or launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected} "
                             f"(per microbatch {per})")
    return launches, rec


# Phase "train_n" (train.steps_per_call): TRAIN_N steps a call, two calls
# with an LR change between them, against 2 x TRAIN_N eager steps; then the
# timings of one TRAIN_N_TIMED-step replay against eager steps
TRAIN_N, TRAIN_N_TIMED = 4, 5
TRAIN_N_LR = (3e-4, 1.5e-4)


def _snapshot(net, opt, gen):
    """The training state: every parameter and moment (clones), count, lr
    and the generator's state."""
    return ([t.detach().clone() for t in (*net.parameters(), *opt.mu,
                                          *opt.nu)],
            opt.count, opt.lr, gen.get_state())


def _restore(net, opt, gen, snap):
    tensors, opt.count, opt.lr, rng = snap
    with torch.no_grad():
        for t, s in zip((*net.parameters(), *opt.mu, *opt.nu), tensors):
            t.copy_(s)
    gen.set_state(rng)


def _two_calls(step, batches, opt, n):
    """Two calls of n batches each (`step(xs, ys)`, losses (n,)), the LR
    at TRAIN_N_LR's values; the losses."""
    from nas_3d_unet_tpu_torch.train.optim import set_learning_rate

    out = []
    for call, lr in enumerate(TRAIN_N_LR):
        set_learning_rate(opt, lr)
        xs, ys = zip(*batches[call * n:(call + 1) * n])
        out.append(step(xs, ys))
    return torch.cat(out)


def phase_train_n(dev, seed):
    """`train.steps_per_call` (phase 6a): the bf16 flagship at 128^3,
    batch 2, microbatch 1, device augmentation.  Under cuDNN's
    deterministic algorithms, from one saved state: 2 x TRAIN_N eager
    steps against two replays of a TRAIN_N-step CUDA graph, the LR changed
    between the calls; the losses, every parameter, AdamW's moments, count
    and the generator's state must be bit-equal, and the launches recorded
    at capture must be the modules' count x microbatches x TRAIN_N (a
    replay counts none).  Then, with cuDNN's default settings, s a step
    and peak memory of eager steps and of TRAIN_N_TIMED-step replays
    (ungated)."""
    from nas_3d_unet_tpu_torch.ops import _cuda
    from nas_3d_unet_tpu_torch.train.loop import (make_train_step,
                                                  make_train_step_n)
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer

    t_phase = time.perf_counter()
    net = flagship_net(seed, "bfloat16").to(dev)
    opt = make_optimizer(net.parameters(), TRAIN_N_LR[0], 1e-4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = torch.Generator(device=dev)
    data.manual_seed(seed + 1)
    batches = []
    for _ in range(2 * TRAIN_N_TIMED):
        x = torch.randn((TRAIN_BATCH, *(TRAIN_PATCH,) * 3, 4),
                        generator=data, device=dev)
        wt = (x[..., 1] > 0.5).float()
        batches.append((x, torch.stack([wt, wt, wt], dim=-1)))
    kw = dict(augment=AUGMENT, microbatch=MICRO, gen=gen)
    slices = TRAIN_BATCH // MICRO
    per = _modules_per_forward(net)

    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    cudnn.deterministic = True
    try:
        start = _snapshot(net, opt, gen)
        step = make_train_step(net, opt, **kw)
        eager = _two_calls(lambda xs, ys: torch.stack(
            [step(x, y) for x, y in zip(xs, ys)]), batches, opt, TRAIN_N)
        want = _snapshot(net, opt, gen)
        _restore(net, opt, gen, start)
        step_n = make_train_step_n(net, opt, n=TRAIN_N, **kw)
        _cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        graphed = _two_calls(step_n, batches, opt, TRAIN_N)
        torch.cuda.synchronize()
        graphed_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        captured = dict(step_n.launches_at_capture)
        got = _snapshot(net, opt, gen)
    finally:
        cudnn.deterministic = deterministic
    differ = [i for i, (a, b) in enumerate(zip(want[0], got[0]))
              if not torch.equal(a, b)]
    n_params = len(list(net.parameters()))
    bits = {"losses_equal": torch.equal(eager, graphed),
            "tensors": len(want[0]), "tensors_differ": len(differ),
            "params_differ": sum(i < n_params for i in differ),
            "count": [want[1], got[1]],
            "generator_equal": torch.equal(want[3], got[3])}
    expected = {f"{k}_bf16": v * slices * TRAIN_N for k, v in per.items()}
    # the first call also ran one eager warm-up step before the capture
    expected_total = {f"{k}_bf16": v * slices * (TRAIN_N + 1)
                      for k, v in per.items()}
    del step_n, step
    net.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # the timings, with cuDNN's default settings
    step = make_train_step(net, opt, **kw)
    step(*batches[0]).item()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in batches[:TRAIN_N_TIMED]:
        step(x, y)
    torch.cuda.synchronize()
    eager_s = (time.perf_counter() - t0) / TRAIN_N_TIMED
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del step
    net.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    step_n = make_train_step_n(net, opt, n=TRAIN_N_TIMED, **kw)
    xs, ys = zip(*batches[:TRAIN_N_TIMED])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step_n(xs, ys).cpu()                      # warm-up, capture, replay
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for call in range(2):
        xs, ys = zip(*batches[call * TRAIN_N_TIMED:
                              (call + 1) * TRAIN_N_TIMED])
        losses = step_n(xs, ys)
    torch.cuda.synchronize()
    graph_s = (time.perf_counter() - t0) / (2 * TRAIN_N_TIMED)
    rec = {"phase": "train_n", "batch": TRAIN_BATCH, "patch": TRAIN_PATCH,
           "microbatch": MICRO, "dtype": "bfloat16", "n": TRAIN_N,
           "bits": bits, "eager_losses": eager.tolist(),
           "graph_losses": graphed.tolist(), "graph_calls_s": graphed_s,
           "launches_at_capture": captured, "expected_at_capture": expected,
           "launches": launches, "expected_launches": expected_total,
           "timed_n": TRAIN_N_TIMED, "eager_step_s": eager_s,
           "eager_peak_gb": eager_peak, "graph_step_s": graph_s,
           "graph_first_call_s": first_s,
           "graph_peak_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "graph_reserved_gb": torch.cuda.memory_reserved(dev) / 2 ** 30,
           "timed_losses_finite": bool(torch.isfinite(losses).all()),
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    del step_n
    net.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    if not (bits["losses_equal"] and not differ and want[1] == got[1]
            == 2 * TRAIN_N and bits["generator_equal"]):
        raise AssertionError(f"{TRAIN_N}-step replays differ from eager "
                             f"steps: {bits}")
    if captured != expected or launches != expected_total:
        raise AssertionError(f"launches at capture {captured} != {expected}"
                             f", in all {launches} != {expected_total}")
    if not rec["timed_losses_finite"]:
        raise AssertionError(f"non-finite loss {losses}")
    return rec


def check_step_kernels(phase, dev, gen, summary, groups):
    """Each kernel of a search step at every geometry of its table
    (`groups`: (kernel, rows) as `_table` takes them), bf16, batch 1,
    against its twin; per_unit = launches per step, summed in `summary`."""
    bf16 = torch.bfloat16
    for name, rows in groups:
        for *geom, n in rows:
            kernel = f"{LAUNCH_NAME.get(name, name)}_bf16"
            if name.startswith("conv3x3x3"):
                _run_check(phase, kernel, check_conv, summary, n,
                           dev, gen, *geom, SEARCH_BATCH, bf16,
                           name == "conv3x3x3_stats")
            elif name == "gemm_stats":
                _run_check(phase, kernel, check_gemm, summary, n,
                           dev, gen, *geom, SEARCH_BATCH, bf16)
            elif name == "conv3d":
                _run_check(phase, kernel, check_conv3d, summary, n, dev, gen,
                           *geom, SEARCH_BATCH, bf16)
            elif name in ("pointwise_conv", "conv_transpose2x"):
                c, v = geom
                fn = check_pointwise if name == "pointwise_conv" \
                    else check_transpose
                _run_check(phase, kernel, fn, summary, n, dev, gen, c, c, v,
                           SEARCH_BATCH, bf16)
            elif name.startswith("group_norm"):
                _run_check(phase, kernel, check_gn, summary, n, dev, gen,
                           LAUNCH_NAME.get(name, name), *geom, SEARCH_BATCH,
                           bf16, name != "group_norm_dx_unmasked")
            else:
                _run_check(phase, kernel, check_stats, summary, n,
                           dev, gen, name, *geom, SEARCH_BATCH, bf16)
    return {f"{n}_bf16": summary.entry(f"{n}_bf16")
            for n in {LAUNCH_NAME.get(name, name)
                      for name, rows in groups if rows}}


def phase_search_kernels(dev, gen, summary):
    """The search's kernels at every geometry one full-width bilevel step
    hands them (bf16, batch 1); per_unit = launches per bilevel step, summed
    in `summary` (the search's own: the kernels line keeps the other
    paths')."""
    t0 = time.perf_counter()
    per_step = check_step_kernels("search_kernel", dev, gen, summary,
                                  S_TABLES)
    seconds = time.perf_counter() - t0
    emit({"phase": "search_kernels", "seconds": seconds,
          "per_step": per_step})
    return seconds


def search_supernet(seed):
    """The shipped supernet (the root config.json's model) on the CPU, with
    random weights from `seed` at flax's initialiser scales through the
    bridge, and α from `init_alphas` on a CPU generator seeded with
    `seed`."""
    from nas_3d_unet_tpu_torch import bridge
    from nas_3d_unet_tpu_torch.models.genotype import init_alphas
    from nas_3d_unet_tpu_torch.models.unet import make_supernet
    from nas_3d_unet_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "config.json"))
    net = make_supernet(cfg.model, cfg.data.num_classes)
    bridge.load_flax_params(net, bridge.random_flax_params(net, seed))
    g = torch.Generator()
    g.manual_seed(seed)
    return net, init_alphas(g, cfg.model.n_nodes), cfg


def _search_per_step(net):
    """Kernel launches of a warmup step and of a bilevel step, counted from
    the modules.  A warmup step is a forward and the w-backward, as a train
    microbatch (`_modules_per_forward`).  A bilevel step runs two forwards;
    the w-step's backward runs every K5b and every K1-dx but the stem's;
    the α-step's (the weights frozen) only those of the modules whose input
    depends on α: not the stem, nor the projections and edge ops that read
    it (both inputs of down cell 0, s0 of down cell 1, the skip of the last
    up cell)."""
    warm = _modules_per_forward(net)
    down = [getattr(net, n) for n in net._down]
    last_up = getattr(net, net._up[-1])

    def pre(cell, i):
        return getattr(cell, cell.pre[i])

    reads_stem = torch.nn.ModuleList([
        net.ConvNormAct_0, pre(down[0], 0), pre(down[0], 1),
        down[0].src_in0, down[0].src_in1, pre(down[1], 0), down[1].src_in0,
        pre(last_up, 0), last_up.src_skip])
    off = _modules_per_forward(reads_stem)
    step = {k: 2 * warm[k] for k in ("conv3x3x3_stats", "gemm_stats",
                                     "moments")}
    step["conv3x3x3"] = warm["conv3x3x3"] + warm["conv3x3x3_stats"] \
        - off.get("conv3x3x3_stats", 0)
    step["weighted_sums"] = 2 * warm["weighted_sums"] \
        - off.get("weighted_sums", 0)
    return warm, step


class _Recorder:
    """Stands in for AdamW in a search step: keeps the gradients it is
    handed and updates nothing."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


def search_grad_parity(net, alphas, batches, kernel_ctx,
                       alpha_limits=ALPHA_LIMITS):
    """One bilevel step's α gradients (the α-step's) and w gradients (the
    w-step's) on the kernel path (inside `kernel_ctx`) and on the twin
    path, no update in between (`_Recorder`), leaf by leaf."""
    from nas_3d_unet_tpu_torch.search.bilevel import make_search_step

    out = {}
    for path, ctx in (("kernel", kernel_ctx), ("twin", twin_path())):
        w_rec, a_rec = _Recorder(net.parameters()), _Recorder(alphas.values())
        with ctx:
            m = make_search_step(net, w_rec, a_rec, alphas)(*batches)
        out[path] = ({k: v.item() for k, v in m.items()}, w_rec.grads,
                     a_rec.grads)
    net.zero_grad(set_to_none=True)
    (mk, wk, ak), (mt, wt, at) = out["kernel"], out["twin"]
    rec = {"losses_kernel": mk, "losses_twin": mt,
           "alpha": leaf_stats(list(alphas), ak, at, alpha_limits),
           "w": leaf_stats([n for n, _ in net.named_parameters()], wk, wt)}
    rec["ok"] = rec["alpha"]["ok"] and rec["w"]["ok"]
    return rec


def phase_search(dev, seed):
    """The search on the card: the shipped supernet at 128^3, one warmup
    step and SEARCH_STEPS bilevel steps from synthetic batches."""
    from nas_3d_unet_tpu_torch import bridge
    from nas_3d_unet_tpu_torch.models.genotype import parse_alphas
    from nas_3d_unet_tpu_torch.models.unet import make_derived
    from nas_3d_unet_tpu_torch.ops import _cuda
    from nas_3d_unet_tpu_torch.search.bilevel import (make_search_step,
                                                      make_warmup_step)
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer

    t_phase = time.perf_counter()
    net, alphas, cfg = search_supernet(seed)
    net = net.to(dev)
    alphas = {k: v.to(dev).requires_grad_() for k, v in alphas.items()}
    x, y = synthetic_batch(dev, seed)       # patch 0 trains, patch 1 is val
    batches = (x[:1], y[:1], x[1:], y[1:])

    # one step's gradients, kernel path (noting the shapes) then twin path
    seen = collections.Counter()
    rec = search_grad_parity(net, alphas, batches, noting_kernels(seen))
    tables = _table(*S_TABLES)
    emit({"phase": "search_parity", **rec,
          "geometries_match_search_kernels": seen == tables})
    if not rec["ok"]:
        raise AssertionError("the search step's kernel-path gradients "
                             "disagree with the twin path")
    if seen != tables:
        raise AssertionError(f"the search step's kernel shapes {dict(seen)} "
                             "are not the geometries checked in "
                             "search_kernels")

    sc = cfg.search
    w_opt = make_optimizer(net.parameters(), sc.w_lr, sc.w_weight_decay)
    a_opt = make_optimizer(alphas.values(), sc.alpha_lr,
                           sc.alpha_weight_decay)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    warmup = make_warmup_step(net, w_opt, alphas, AUGMENT, gen=gen)
    step = make_search_step(net, w_opt, a_opt, alphas, AUGMENT, gen=gen)
    a0 = {k: v.detach().clone() for k, v in alphas.items()}
    per_warm, per_step = _search_per_step(net)

    _cuda.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = [warmup(*batches[:2])["train_loss"].item()
            for _ in range(SEARCH_WARMUP_STEPS)]
    warm_s = (time.perf_counter() - t0) / SEARCH_WARMUP_STEPS
    warm_launches = dict(_cuda.LAUNCHES)
    alpha_fixed = all(torch.equal(alphas[k], a0[k]) for k in alphas)

    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    steps_s, losses = [], []
    for _ in range(SEARCH_STEPS):
        t0 = time.perf_counter()
        m = step(*batches)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t0)
        losses.append({k: v.item() for k, v in m.items()})
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    alpha_moved = any(not torch.equal(alphas[k], a0[k]) for k in alphas)

    alphas_np = {k: v.detach().cpu().numpy() for k, v in alphas.items()}
    genotype = parse_alphas(alphas_np, cfg.model.n_nodes)
    derived = make_derived(cfg.model, cfg.data.num_classes, genotype)
    bridge.load_flax_params(derived, bridge.random_flax_params(derived,
                                                               seed))
    with torch.inference_mode():
        logits = derived.to(dev)(x[:1])
    derived_ok = (tuple(logits.shape) == (1, *(TRAIN_PATCH,) * 3, 3)
                  and bool(torch.isfinite(logits).all()))
    del derived, logits

    expected_warm = {f"{k}_bf16": n * SEARCH_WARMUP_STEPS
                     for k, n in per_warm.items()}
    expected = {f"{k}_bf16": n * SEARCH_STEPS for k, n in per_step.items()}
    step_s = float(np.mean(steps_s))
    rec = {"phase": "search", "patch": TRAIN_PATCH, "batch": SEARCH_BATCH,
           "dtype": cfg.model.dtype,
           "params": sum(p.numel() for p in net.parameters()),
           "warmup_step_s": warm_s, "warmup_losses": warm,
           "bilevel_step_s": steps_s, "step_s": step_s,
           "patches_per_s": SEARCH_BATCH / step_s, "losses": losses,
           "peak_mem_gb": peak, "alpha_fixed_in_warmup": alpha_fixed,
           "alpha_moved_in_bilevel": alpha_moved,
           "launches_per_warmup_step": per_warm,
           "launches_per_bilevel_step": per_step,
           "warmup_launches": warm_launches,
           "expected_warmup_launches": expected_warm,
           "launches": launches, "expected_launches": expected,
           "genotype": json.loads(genotype.to_json()),
           "derived_forward_ok": derived_ok,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    values = warm + [v for m in losses for v in m.values()]
    if not all(map(math.isfinite, values)):
        raise AssertionError(f"non-finite search loss {values}")
    if not alpha_fixed or not alpha_moved:
        raise AssertionError(f"α fixed in warmup {alpha_fixed}, moved in "
                             f"the bilevel steps {alpha_moved}")
    if launches != expected or warm_launches != expected_warm:
        raise AssertionError(f"search launches {launches} != {expected}, "
                             f"warmup {warm_launches} != {expected_warm}")
    if not derived_ok:
        raise AssertionError("the searched genotype's net gave bad logits")
    return rec


def unrolled_parity(net, alphas, batches, kernel_ctx=None, xi=PARITY_XI,
                    faults=None):
    """The second-order α-step's val loss and α gradients (at ξ = `xi`) on
    the kernel path (inside `kernel_ctx`) and on the twin path, leaf by
    leaf (UNROLLED_ALPHA_LIMITS), and the second-order term's share,
    ‖g − g₁‖ / ‖g₁‖ on the kernel path, g₁ the first-order α gradient of
    the same val batch.  `faults`: {name: context} of planted faults, each
    a kernel-path run against the same twin path ("fault_<name>"), which
    must miss the limits ("faults_caught")."""
    from nas_3d_unet_tpu_torch.metrics.losses import dice_ce_loss
    from nas_3d_unet_tpu_torch.models.unet import arch_weights_from_alphas
    from nas_3d_unet_tpu_torch.search.bilevel import unrolled_alpha_grads

    a_params = list(alphas.values())
    out = {}
    paths = [("kernel", kernel_ctx or contextlib.nullcontext()),
             ("twin", twin_path())]
    paths += [(f"fault_{name}", ctx) for name, ctx in (faults or {}).items()]
    peak = {}
    for path, ctx in paths:
        torch.cuda.reset_peak_memory_stats()
        with ctx:
            loss, grads = unrolled_alpha_grads(net, alphas, a_params, xi,
                                               *batches, dice_ce_loss)
        out[path] = (loss.item(), [g.double() for g in grads])
        peak[path] = torch.cuda.max_memory_allocated() / 2 ** 30
        del loss, grads
        torch.cuda.empty_cache()
    first = torch.autograd.grad(
        dice_ce_loss(net(batches[2], arch_weights_from_alphas(alphas)),
                     batches[3]), a_params)
    net.zero_grad(set_to_none=True)
    g = torch.cat([t.flatten() for t in out["kernel"][1]])
    g1 = torch.cat([t.double().flatten() for t in first])
    rec = {"loss_kernel": out["kernel"][0], "loss_twin": out["twin"][0],
           "peak_gb": peak,
           "second_order_share": ((g - g1).norm() / g1.norm()).item(),
           "alpha": leaf_stats(list(alphas), out["kernel"][1],
                               out["twin"][1], UNROLLED_ALPHA_LIMITS)}
    rec["ok"] = rec["alpha"]["ok"] and math.isfinite(rec["loss_kernel"])
    for name in faults or {}:
        rec[f"fault_{name}"] = leaf_stats(
            list(alphas), out[f"fault_{name}"][1], out["twin"][1],
            UNROLLED_ALPHA_LIMITS)
    if faults:
        rec["faults_caught"] = not any(rec[f"fault_{name}"]["ok"]
                                       for name in faults)
        rec["ok"] = rec["ok"] and rec["faults_caught"]
    return rec


def search_inputs(dev, seed, pc_k=1, use_pallas=False):
    """The shipped supernet (`search_supernet`, rebuilt with `pc_k` as the
    Searcher does, or with `use_pallas`, its weights drawn again from
    `seed`) and its α on the card, the batches (patch 0 trains, patch 1 is
    the val batch) and the config."""
    from nas_3d_unet_tpu_torch import bridge

    net, alphas, cfg = search_supernet(seed)
    if pc_k > 1 or use_pallas:
        net = net.clone(pc_k=pc_k, use_pallas=use_pallas)
        bridge.load_flax_params(net, bridge.random_flax_params(net, seed))
    x, y = synthetic_batch(dev, seed)
    return (net.to(dev), {k: v.to(dev).requires_grad_()
                          for k, v in alphas.items()},
            (x[:1], y[:1], x[1:], y[1:]), cfg)


def timed_search_steps(phase, dev, seed, net, alphas, cfg, batches,
                       make_step, groups, steps, **extra):
    """One step noted (`noting_kernels`: the geometries it hands the
    kernels against `groups`, the tables the phase checked), then `steps`
    timed ones from fresh AdamW states: s a step, patches/s, finite losses,
    peak memory (over all of them), α moved, launches equal to the tables'
    per step × steps, the genotype the α decodes.  `make_step(w_opt,
    a_opt, gen)` builds the step."""
    from nas_3d_unet_tpu_torch.models.genotype import parse_alphas
    from nas_3d_unet_tpu_torch.ops import _cuda
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer

    sc = cfg.search
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    step = make_step(
        make_optimizer(net.parameters(), sc.w_lr, sc.w_weight_decay),
        make_optimizer(alphas.values(), sc.alpha_lr, sc.alpha_weight_decay),
        gen)
    tables = _table(*groups)
    per_step = collections.Counter()
    for k, rows in groups:
        per_step[f"{LAUNCH_NAME.get(k, k)}_bf16"] += sum(r[-1] for r in rows)
    per_step = dict(per_step)
    seen = collections.Counter()
    torch.cuda.reset_peak_memory_stats(dev)
    with noting_kernels(seen):
        noted = {k: v.item() for k, v in step(*batches).items()}
    a0 = {k: v.detach().clone() for k, v in alphas.items()}
    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    steps_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step(*batches)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t0)
        losses.append({k: v.item() for k, v in m.items()})
    launches = dict(_cuda.LAUNCHES)
    expected = {k: n * steps for k, n in per_step.items()}
    alpha_moved = any(not torch.equal(alphas[k], a0[k]) for k in alphas)
    genotype = parse_alphas({k: v.detach().cpu().numpy()
                             for k, v in alphas.items()}, cfg.model.n_nodes)
    step_s = float(np.mean(steps_s))
    rec = {"phase": phase, "patch": TRAIN_PATCH, "batch": SEARCH_BATCH,
           "dtype": cfg.model.dtype,
           "params": sum(p.numel() for p in net.parameters()), **extra,
           "noted_step_losses": noted, "step_s_each": steps_s,
           "step_s": step_s, "patches_per_s": SEARCH_BATCH / step_s,
           "losses": losses,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "alpha_moved": alpha_moved, "launches_per_step": per_step,
           "launches": launches, "expected_launches": expected,
           "geometries_match_tables": seen == tables,
           "genotype": json.loads(genotype.to_json())}
    emit(rec)
    values = list(noted.values()) + [v for m in losses for v in m.values()]
    if not all(map(math.isfinite, values)):
        raise AssertionError(f"{phase}: non-finite search loss {values}")
    if seen != tables:
        raise AssertionError(f"{phase}: the step's kernel shapes {dict(seen)}"
                             " are not the geometries its phase checked")
    if launches != expected or not alpha_moved:
        raise AssertionError(f"{phase}: launches {launches} != {expected}, "
                             f"α moved {alpha_moved}")
    genotype.validate()
    return rec


def _parity_check(phase, rec, **extra):
    emit({"phase": phase, **extra, **rec})
    if rec.get("faults_caught") is False:
        raise AssertionError(f"{phase}: a planted fault passes the limits")
    if not rec["ok"]:
        raise AssertionError(f"{phase}: the kernel-path gradients disagree "
                             "with the twin path")


def phase_search_unrolled(dev, gen, seed):
    """The second-order step (`search.unrolled`) on the shipped supernet:
    its kernels at every geometry it hands them (SU_ tables), its α
    gradient on the kernel path against the twin path, then one noted and
    SU_STEPS timed steps, all at 128^3."""
    from nas_3d_unet_tpu_torch.search.bilevel import \
        make_search_step_unrolled

    t_phase = time.perf_counter()
    per_step = check_step_kernels("search_unrolled_kernel", dev, gen,
                                  Summary(), SU_TABLES)
    emit({"phase": "search_unrolled_kernels", "per_step": per_step,
          "seconds": time.perf_counter() - t_phase})
    net, alphas, batches, cfg = search_inputs(dev, seed)
    xi = cfg.search.xi or cfg.search.w_lr
    _parity_check("search_unrolled_parity",
                  unrolled_parity(net, alphas, batches), xi=PARITY_XI)
    rec = timed_search_steps(
        "search_unrolled", dev, seed, net, alphas, cfg, batches,
        lambda w_opt, a_opt, g: make_search_step_unrolled(
            net, w_opt, a_opt, alphas, xi, AUGMENT, gen=g),
        SU_TABLES, SU_STEPS, xi=xi)
    return rec, time.perf_counter() - t_phase


def k3_statistics_constant():
    """A planted fault, the code before K3's backward was twice
    differentiable: K3's statistics held constant in its differentiated
    backward (`groupnorm._grad_statistics` detached)."""
    from nas_3d_unet_tpu_torch.ops import groupnorm

    cut = groupnorm._grad_statistics
    return mock.patch.object(groupnorm, "_grad_statistics",
                             lambda *a: tuple(t.detach() for t in cut(*a)))


def phase_search_unrolled_pallas(dev, gen, seed):
    """The second-order step on the shipped supernet with model.use_pallas
    (K6, K7 and K4 on the edge ops, K3 for every GroupNorm): its kernels
    at every geometry it hands them (SUP_ tables), its α gradient on the
    kernel path against the twin path, and with K3's statistics held
    constant (a planted fault that must miss the limits), then one noted
    and SUP_STEPS timed steps, all at 128^3 in bf16."""
    from nas_3d_unet_tpu_torch.search.bilevel import \
        make_search_step_unrolled

    t_phase = time.perf_counter()
    per_step = check_step_kernels("search_unrolled_pallas_kernel", dev, gen,
                                  Summary(), SUP_TABLES)
    emit({"phase": "search_unrolled_pallas_kernels", "per_step": per_step,
          "seconds": time.perf_counter() - t_phase})
    net, alphas, batches, cfg = search_inputs(dev, seed, use_pallas=True)
    xi = cfg.search.xi or cfg.search.w_lr
    e = SUP_PARITY_PATCH
    _parity_check("search_unrolled_pallas_parity", unrolled_parity(
        net, alphas, [t[:, :e, :e, :e].contiguous() for t in batches],
        faults={"k3_statistics_constant": k3_statistics_constant()}),
        xi=PARITY_XI, patch=e, patch_why="memory: the twin path at 128^3 "
        "does not fit the card")
    rec = timed_search_steps(
        "search_unrolled_pallas", dev, seed, net, alphas, cfg, batches,
        lambda w_opt, a_opt, g: make_search_step_unrolled(
            net, w_opt, a_opt, alphas, xi, AUGMENT, gen=g),
        SUP_TABLES, SUP_STEPS, xi=xi, use_pallas=True)
    return rec, time.perf_counter() - t_phase


def phase_search_pc(dev, gen, seed):
    """PC-DARTS (`search.partial_channels` 2) on the shipped supernet: its
    kernels at every geometry a first-order step (SPC_) and an unrolled
    step (SB_) hand them; one first-order step's α and w gradients and the
    unrolled α gradient on the kernel path against the twin path; then
    one noted and SPC_STEPS timed first-order steps, and one noted and
    SB_STEPS timed unrolled steps, all at 128^3."""
    from nas_3d_unet_tpu_torch.search.bilevel import (
        make_search_step, make_search_step_unrolled)

    t_phase = time.perf_counter()
    per_step = check_step_kernels("search_pc_kernel", dev, gen, Summary(),
                                  SPC_TABLES)
    per_step_both = check_step_kernels("search_pc_kernel", dev, gen,
                                       Summary(), SB_TABLES)
    emit({"phase": "search_pc_kernels", "per_step": per_step,
          "per_unrolled_step": per_step_both,
          "seconds": time.perf_counter() - t_phase})
    net, alphas, batches, cfg = search_inputs(dev, seed, pc_k=2)
    xi = cfg.search.xi or cfg.search.w_lr
    _parity_check("search_pc_parity", search_grad_parity(
        net, alphas, batches, contextlib.nullcontext(), PC_ALPHA_LIMITS),
        pc_k=2)
    _parity_check("search_pc_unrolled_parity",
                  unrolled_parity(net, alphas, batches), pc_k=2,
                  xi=PARITY_XI)
    pc = timed_search_steps(
        "search_pc", dev, seed, net, alphas, cfg, batches,
        lambda w_opt, a_opt, g: make_search_step(net, w_opt, a_opt, alphas,
                                                 AUGMENT, gen=g),
        SPC_TABLES, SPC_STEPS, pc_k=2)
    both = timed_search_steps(
        "search_pc_unrolled", dev, seed, net, alphas, cfg, batches,
        lambda w_opt, a_opt, g: make_search_step_unrolled(
            net, w_opt, a_opt, alphas, xi, AUGMENT, gen=g),
        SB_TABLES, SB_STEPS, pc_k=2, xi=xi)
    return pc, both, time.perf_counter() - t_phase


# ---------------------------------------------------------------------------
# Phases "remat" and "dp": activation checkpointing and data parallelism
# ---------------------------------------------------------------------------

REMAT_SETTINGS = {"off": (False, False), "cells": (True, False),
                  "cells_edges": (True, True)}
REMAT_KERNELS = ("conv3x3x3_stats", "gemm_stats", "moments")
# runs of a step (remat off, cuDNN held to deterministic algorithms) whose
# gradients must give one digest for the step to count as repeating
REPEAT_RUNS = 4
# the second-order step's edge in phase "remat": its six runs at 128^3
# took 140 s of the script's time on the H100 (grad_parity.py --repeats
# holds it at 128^3); the upsample and every other op run at 64^3 too
REMAT_SECOND_PATCH = 64


def _set_remat(net, cells, edges):
    """Checkpoint `net`'s cells (`cells`) and the supernet's edges
    (`edges`) from the next forward on: the flags `checkpointed` reads."""
    net.remat = cells
    for name in (*net._down, *net._up):
        cell = getattr(net, name)
        if hasattr(cell, "remat_edges"):
            cell.remat_edges = edges


def remat_per_forward(net):
    """Forward kernel launches (K1, K2, K5a) one forward makes inside the
    cells and inside the supernet's edges (`_SourceOps` or `MixedOp`),
    counted from the modules: what one backward through a checkpointed
    region launches again."""
    cells = [getattr(net, n) for n in (*net._down, *net._up)]
    edges = [m for c in cells for n, m in c.named_children()
             if n.startswith(("src_", "CheckpointMixedOp"))]

    def fwd(mods):
        per = _modules_per_forward(torch.nn.ModuleList(mods))
        return {k: per.get(k, 0) for k in REMAT_KERNELS}

    return fwd(cells), fwd(edges)


def _remat_expected(base, cells, edges, passes, on_cells, on_edges):
    """`base` launches plus, per backward through them (`passes`), the
    forward kernels of the checkpointed cells and edges again."""
    out = dict(base)
    for k in REMAT_KERNELS:
        extra = passes * (cells[k] * on_cells + edges[k] * on_edges)
        if extra:
            out[f"{k}_bf16"] = out.get(f"{k}_bf16", 0) + extra
    return out


def _remat_grads(kind, net, alphas, batches, xi):
    """One step's gradients, nothing updated: the derived train step's
    (`loss_and_grads`, microbatch MICRO), or a first-order (also with
    partial channels: "pc") or second-order search step's α then w
    gradients (`_Recorder`s); with the losses."""
    from nas_3d_unet_tpu_torch.metrics.losses import dice_ce_loss
    from nas_3d_unet_tpu_torch.search.bilevel import (
        make_search_step, make_search_step_unrolled)
    from nas_3d_unet_tpu_torch.train.loop import loss_and_grads

    if kind == "derived":
        loss, grads = loss_and_grads(net, *batches, dice_ce_loss, MICRO)
        return [loss.item()], [], [g.clone() for g in grads]
    w_rec, a_rec = _Recorder(net.parameters()), _Recorder(alphas.values())
    if kind in ("first", "pc"):
        step = make_search_step(net, w_rec, a_rec, alphas)
    else:
        step = make_search_step_unrolled(net, w_rec, a_rec, alphas, xi)
    m = step(*batches)
    return [v.item() for v in m.values()], a_rec.grads, w_rec.grads


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def nondeterministic_ops(fn):
    """What `torch.use_deterministic_algorithms(True, warn_only=True)`
    warns of while `fn()` runs: the ops that have no deterministic
    implementation on the card (each warning's first sentence)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(". ")[0][:200] for w in caught
                   if "determinis" in str(w.message)})


def phase_remat(dev, seed):
    """Repeatability and activation checkpointing at full width on one
    rank, under cuDNN's deterministic algorithms: the derived bf16 train
    step (batch 2 of 128^3, microbatch 1), the shipped supernet's
    first-order step (128^3, batch 1), second-order step
    (REMAT_SECOND_PATCH^3, batch 1) and PC step (pc_k 2, first-order,
    128^3).  Each step with remat off runs REPEAT_RUNS
    times; one digest of its gradients and losses means it repeats.  For
    a step that does not, one more run reads the ops
    `use_deterministic_algorithms` names, and the phase fails unless one
    is named.
    Then remat on the cells (and the cells and edges of the supernet; the
    PC step is not checkpointed): gradients bit-equal to remat off's
    where off repeats (else, the op named, within the step's limits),
    launches equal to remat off's plus the checkpointed regions' forward
    kernels once per backward through them, each setting's peak memory
    and s a step."""
    from nas_3d_unet_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    out = {}
    try:
        x, y = synthetic_batch(dev, seed)
        derived = flagship_net(seed, "bfloat16").to(dev)
        slices = TRAIN_BATCH // MICRO
        per = _modules_per_forward(derived)
        steps = [("derived", derived, None, (x, y),
                  {f"{k}_bf16": n * slices for k, n in per.items()},
                  slices, GRAD_LIMITS)]
        net, alphas, batches, cfg = search_inputs(dev, seed)
        xi = cfg.search.xi or cfg.search.w_lr
        first = {f"{k}_bf16": n for k, n in _search_per_step(net)[1].items()}

        def per_step(tables):
            return {f"{k}_bf16": sum(r[-1] for r in rows)
                    for k, rows in tables}

        e = REMAT_SECOND_PATCH
        # first-order: the α-step's backward and the w-step's; second-
        # order: the α-step's inner and outer backwards (the train
        # forward's regions twice, the val forward's once), the w-step's
        steps += [("first", net, alphas, batches, first, 2, ALPHA_LIMITS),
                  ("second", net, alphas,
                   [t[:, :e, :e, :e].contiguous() for t in batches],
                   per_step(SU_TABLES), 4, UNROLLED_ALPHA_LIMITS),
                  ("pc", None, None, None, per_step(SPC_TABLES), 2,
                   PC_ALPHA_LIMITS)]
        for kind, model, al, b, base, passes, a_limits in steps:
            if kind == "pc":            # its own supernet, built when due
                model, al, b, _ = search_inputs(dev, seed, pc_k=2)
            cells, edges = remat_per_forward(model)
            names = [n for n, _ in model.named_parameters()]

            def run(name):
                """One step at remat setting `name`."""
                _set_remat(model, *REMAT_SETTINGS[name])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                _cuda.LAUNCHES.clear()
                t0 = time.perf_counter()
                losses, ga, gw = _remat_grads(kind, model, al, b, xi)
                torch.cuda.synchronize()
                r = {"step_s": time.perf_counter() - t0,
                     "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                     / 2 ** 30,
                     "losses": losses, "launches": dict(_cuda.LAUNCHES),
                     "digest": _digest([*ga, *gw, torch.tensor(losses)])[:16]}
                _set_remat(model, False, False)
                model.zero_grad(set_to_none=True)
                return r, (ga, gw)

            runs, grads = {}, {}
            runs["off"], grads["off"] = run("off")
            digests = [runs["off"]["digest"]]
            for _ in range(REPEAT_RUNS - 1):
                digests.append(run("off")[0]["digest"])
            repeats = len(set(digests)) == 1
            ops = None                  # looked for where it does not
            if not repeats:
                ops = nondeterministic_ops(
                    lambda: _remat_grads(kind, model, al, b, xi))
                model.zero_grad(set_to_none=True)
            settings = {"derived": ["cells"], "pc": []}.get(
                kind, ["cells", "cells_edges"])
            for name in settings:
                runs[name], grads[name] = run(name)
            for name, r in runs.items():
                r["expected_launches"] = _remat_expected(
                    base, cells, edges, passes, *REMAT_SETTINGS[name])
            rec = {"phase": "remat", "step": kind,
                   "off_digests": digests, "repeats": repeats,
                   "nondeterministic_ops": ops,
                   "per_forward_in_cells": cells,
                   "per_forward_in_edges": edges,
                   "backwards_through_regions": passes}
            off = grads["off"]
            for name in settings:
                r = runs[name]
                r["bit_equal_to_off"] = _same(grads[name][0], off[0]) \
                    and _same(grads[name][1], off[1]) \
                    and r["losses"] == runs["off"]["losses"]
                if r["bit_equal_to_off"]:
                    continue
                r["w"] = leaf_stats(names, grads[name][1], off[1])
                r["alpha"] = (leaf_stats(list(al), grads[name][0], off[0],
                                         a_limits) if al else None)
                r["reason"] = ("remat changes the bits of a step that "
                               "repeats" if repeats else
                               "remat off does not repeat its bits: "
                               + "; ".join(ops))
            del grads
            emit(rec | runs)
            out[kind] = rec | runs
            if not repeats and not ops:
                raise AssertionError(
                    f"remat {kind}: remat off gave {len(set(digests))} "
                    f"digests in {REPEAT_RUNS} runs and no op is named as "
                    "nondeterministic")
            for name, r in runs.items():
                if r["launches"] != r["expected_launches"]:
                    raise AssertionError(
                        f"remat {kind} {name}: launches {r['launches']} != "
                        f"{r['expected_launches']}")
                if not all(map(math.isfinite, r["losses"])):
                    raise AssertionError(f"remat {kind} {name}: losses "
                                         f"{r['losses']}")
                if name == "off" or r["bit_equal_to_off"]:
                    continue
                if repeats:
                    raise AssertionError(f"remat {kind} {name}: {r['reason']}")
                if not (r["w"]["ok"] and (r["alpha"] is None
                                          or r["alpha"]["ok"])):
                    raise AssertionError(f"remat {kind} {name}: gradients "
                                         "off remat off's limits")
            del runs
        del steps, derived, net, alphas, batches, model, al, b
    finally:
        cudnn.deterministic = saved
    torch.cuda.empty_cache()
    return out, time.perf_counter() - t_phase


DP_WORLD = 2
DP_STEPS = 3
# the second-order step at 64^3: at 128^3 two ranks fit (26.6 GB each
# with remat on the cells and edges), but the phase took 214 s, 185 of
# them in the one-process reference and the ranks, which the second-order
# step dominates (chip_smoke.py on an H100 80GB HBM3 at 700 W)
DP_UNROLLED_PATCH = 64
# the second-order step's rows: row i's WT mask is modality 1 above
# DP_THRESHOLDS[i] (31 % and 69 % of the voxels), so that the ranks'
# gradients differ and a rank that leaves out the other's terms shows
DP_THRESHOLDS = (0.5, -0.5)
DP_TIMEOUT = 900


def _dp_batch(dev, seed, edge, batch):
    """A synthetic batch of `batch` x edge^3 as `synthetic_batch` makes
    it, row i's mask from DP_THRESHOLDS[i]."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (batch, edge, edge, edge, 4)).astype(np.float32)).to(dev)
    t = torch.tensor(DP_THRESHOLDS[:batch], device=dev).view(-1, 1, 1, 1)
    wt = (x[..., 1] > t).float()
    return x, torch.stack([wt, wt, wt], dim=-1)


def _inner_not_reduced(mesh):
    """`mesh` with a planted fault: the differentiable mean returns this
    rank's tensors, so the second-order step's inner gradient is not
    averaged (each rank's virtual step from its own rows, its α gradient
    without the other ranks' Hessian-vector terms); every other
    collective as `mesh`'s."""
    class InnerNotReduced(type(mesh)):
        def all_reduce_mean(self, tensors):
            return list(tensors)

    return InnerNotReduced(rank=mesh.rank, world=mesh.world)


def _rows(mesh, *tensors):
    """This rank's rows of global-batch tensors (all of them without a
    mesh)."""
    if mesh is None:
        return tensors
    n = tensors[0].shape[0] // mesh.world
    return tuple(t[mesh.rank * n:(mesh.rank + 1) * n] for t in tensors)


def dp_gradients(dev, seed, mesh):
    """The first step's gradients at global batch 2, averaged over
    `mesh`'s ranks (one process: None): the derived bf16 train step at
    128^3, the shipped supernet's first-order step and its pc_k 2 twin's
    at 128^3, and its second-order step at ξ = PARITY_XI, remat on the
    cells and edges, at DP_UNROLLED_PATCH^3; with a mesh, that step again
    with the inner gradient not averaged (`_inner_not_reduced`, kind
    "second_fault").  Nothing is updated (`_Recorder`s)."""
    from nas_3d_unet_tpu_torch.search.bilevel import (
        make_search_step, make_search_step_unrolled)
    from nas_3d_unet_tpu_torch.train.loop import make_train_step

    out = {}
    x, y = synthetic_batch(dev, seed)
    net = flagship_net(seed, "bfloat16").to(dev)
    rec = _Recorder(net.parameters())
    make_train_step(net, rec, mesh=mesh)(*_rows(mesh, x, y))
    out["derived"] = ([], [g.cpu() for g in rec.grads])
    del net, rec
    xv, yv = synthetic_batch(dev, seed + 1)
    kinds = [("first", 1, TRAIN_PATCH), ("pc", 2, TRAIN_PATCH),
             ("second", 1, DP_UNROLLED_PATCH)]
    if mesh is not None:
        kinds.append(("second_fault", 1, DP_UNROLLED_PATCH))
    for kind, pc_k, edge in kinds:
        net, alphas, _, _ = search_inputs(dev, seed, pc_k)
        if edge == TRAIN_PATCH:
            b = (x, y, xv, yv)
        else:
            b = (*_dp_batch(dev, seed, edge, DP_WORLD),
                 *_dp_batch(dev, seed + 1, edge, DP_WORLD))
        w_rec, a_rec = _Recorder(net.parameters()), _Recorder(alphas.values())
        if kind.startswith("second"):
            _set_remat(net, True, True)
            step = make_search_step_unrolled(
                net, w_rec, a_rec, alphas, PARITY_XI,
                mesh=_inner_not_reduced(mesh) if kind == "second_fault"
                else mesh)
        else:
            step = make_search_step(net, w_rec, a_rec, alphas, mesh=mesh)
        step(*_rows(mesh, *b))
        out[kind] = ([g.cpu() for g in a_rec.grads],
                     [g.cpu() for g in w_rec.grads])
        del net, alphas, w_rec, a_rec, step
    torch.cuda.empty_cache()
    return out


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def dp_rank_main(args) -> int:
    """One rank of phase "dp" (`--dp-rank`): joins a gloo group of
    DP_WORLD ranks on the parent's card (`--dp-device`) through the port's
    `maybe_initialize_distributed`, and writes its results to
    <dp-dir>/rank<r>.pt: `dp_gradients`, DP_STEPS train steps (the
    parameters' digest, the launches), a Trainer epoch and
    `predict_dataset` over phase "cli"'s store."""
    from nas_3d_unet_tpu_torch import _build
    from nas_3d_unet_tpu_torch.data.pipeline import dataset_paths
    from nas_3d_unet_tpu_torch.infer.predict import predict_dataset
    from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor
    from nas_3d_unet_tpu_torch.models.genotype import default_genotype
    from nas_3d_unet_tpu_torch.models.unet import make_derived
    from nas_3d_unet_tpu_torch.ops import _cuda
    from nas_3d_unet_tpu_torch.parallel import mesh as dp
    from nas_3d_unet_tpu_torch.train.checkpoint import (load_checkpoint,
                                                        load_params)
    from nas_3d_unet_tpu_torch.train.loop import Trainer, make_train_step
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer
    from nas_3d_unet_tpu_torch.utils.config import (load_config,
                                                    parse_overrides)
    from nas_3d_unet_tpu_torch.utils.precision import strict_fp32

    dev = torch.device(args.dp_device)
    dp.maybe_initialize_distributed(dev, backend="gloo")
    mesh = dp.make_mesh()
    _build.load()
    res = {"rank": mesh.rank, "world": mesh.world,
           "backend": str(torch.distributed.get_backend())}
    with strict_fp32():
        res["grads"] = dp_gradients(dev, args.seed, mesh)
        # DP_STEPS train steps, AdamW and augmentation as phase "train"
        net = flagship_net(args.seed, "bfloat16").to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        step = make_train_step(net, make_optimizer(net.parameters(), 3e-4,
                                                   1e-4),
                               augment=AUGMENT, gen=gen, mesh=mesh)
        x, y = _rows(mesh, *synthetic_batch(dev, args.seed))
        _cuda.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["losses"] = [step(x, y).item() for _ in range(DP_STEPS)]
        res["step_s"] = (time.perf_counter() - t0) / DP_STEPS
        res["launches"] = dict(_cuda.LAUNCHES)
        res["per_forward"] = _modules_per_forward(net)
        res["params_digest"] = _digest(net.parameters())
        del net, step
        torch.cuda.empty_cache()
        # a Trainer epoch and predict over phase "cli"'s store
        root = os.path.dirname(os.path.abspath(__file__))
        ov = parse_overrides(CLI_OVERRIDES + [
            f"data.processed_dir={args.dp_store}",
            f"train.checkpoint_dir={args.dp_dir}/trainer",
            f"train.genotype_path={args.dp_dir}/absent.json",
            "train.epochs=1", f"parallel.data_parallel={DP_WORLD}"])
        cfg = load_config(os.path.join(root, "config.json"), ov)
        paths = dataset_paths(cfg.data.processed_dir, mesh.rank, mesh.world)
        tr = Trainer(make_derived(cfg.model, cfg.data.num_classes,
                                  default_genotype(cfg.model.n_nodes)),
                     cfg, paths, device=dev, mesh=mesh)
        t0 = time.perf_counter()
        state = tr.train()
        res["trainer_s"] = time.perf_counter() - t0
        res["trainer_history"] = tr.history
        res["trainer_digest"] = _digest(torch.from_numpy(v) for k, v in
                                        sorted(state.items())
                                        if k.startswith("params/"))
        del tr, state
        torch.cuda.empty_cache()
        net = make_derived(cfg.model, cfg.data.num_classes,
                           default_genotype(cfg.model.n_nodes),
                           dtype_override=cfg.infer.dtype)
        load_params(net, load_checkpoint(f"{args.dp_ckpt}/best.npz"))
        predictor = SlidingWindowPredictor(
            net.to(dev), cfg.infer.patch_size, cfg.infer.overlap,
            cfg.infer.batch_size, cfg.data.num_classes)
        t0 = time.perf_counter()
        res["predict"] = predict_dataset(predictor, cfg.data.processed_dir,
                                         f"{args.dp_dir}/pred",
                                         cfg.infer.threshold, mesh=mesh)
        res["predict_s"] = time.perf_counter() - t0
    torch.save(res, os.path.join(args.dp_dir, f"rank{mesh.rank}.pt"))
    dp.destroy()
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(nproc, args, log):
    """The CLI under torchrun with `nproc` ranks on the cards (NCCL):
    (exit code, seconds, the JSON lines it printed)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), "-m", "nas_3d_unet_tpu_torch",
           *args]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=root, stdout=f, stderr=subprocess.STDOUT,
                            timeout=DP_TIMEOUT).returncode
    secs = time.perf_counter() - t0
    with open(log) as f:
        lines = [json.loads(ln) for ln in f if ln.startswith("{")]
    return rc, secs, lines


def phase_dp(dev, seed, tmp):
    """Data parallelism on the card: DP_WORLD ranks (processes of this
    script, `dp_rank_main`) on card 0 over gloo, which carries CUDA
    tensors (NCCL refuses two ranks on one device), global batch 2, held
    against this process's one-process steps at the global batch; then
    the CLI under torchrun at world 1 (NCCL), and at 2 ranks on 2 cards
    where there are."""
    from nas_3d_unet_tpu_torch.io.nifti import read_nifti

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    ref = dp_gradients(dev, seed, None)
    ref_s = time.perf_counter() - t0
    ddir = os.path.join(tmp, "dp")
    os.makedirs(ddir)
    port = _free_port()
    procs = []
    for r in range(DP_WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DP_WORLD),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        log = open(os.path.join(ddir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--dp-rank", str(r), "--dp-dir", ddir, "--dp-device", str(dev),
             "--dp-store", f"{tmp}/store", "--dp-ckpt", f"{tmp}/a"],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    t0 = time.perf_counter()
    rcs = []
    try:
        for p, log in procs:
            rcs.append(p.wait(timeout=DP_TIMEOUT))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            log.close()
    ranks_s = time.perf_counter() - t0
    if any(rcs):
        tails = [open(os.path.join(ddir, f"rank{r}.log")).read()[-3000:]
                 for r in range(DP_WORLD)]
        raise AssertionError(f"dp ranks exited {rcs}: {tails}")
    res = [torch.load(os.path.join(ddir, f"rank{r}.pt"), weights_only=False)
           for r in range(DP_WORLD)]

    rec = {"phase": "dp", "world": DP_WORLD, "backend": res[0]["backend"],
           "card": "one card, both ranks", "reference_s": ref_s,
           "ranks_s": ranks_s, "unrolled_patch": DP_UNROLLED_PATCH,
           "unrolled_patch_why": "time: two ranks fit at 128^3 with remat",
           "unrolled_xi": PARITY_XI,
           "step_s": [r["step_s"] for r in res],
           "losses": [r["losses"] for r in res],
           "trainer_s": [r["trainer_s"] for r in res],
           "predict_s": [r["predict_s"] for r in res]}
    ok = {}
    # gradients: the ranks' averaged ones against the global-batch step's
    for kind, a_limits in (("derived", None), ("first", ALPHA_LIMITS),
                           ("pc", PC_ALPHA_LIMITS),
                           ("second", UNROLLED_ALPHA_LIMITS)):
        (ra, rw), (ga, gw) = ref[kind], res[0]["grads"][kind]
        names = [f"w{i}" for i in range(len(rw))]
        r = {"w": leaf_stats(names, [g.double() for g in gw],
                             [g.double() for g in rw])}
        if a_limits:
            r["alpha"] = leaf_stats([f"a{i}" for i in range(len(ra))],
                                    [g.double() for g in ga],
                                    [g.double() for g in ra], a_limits)
        r["ranks_bit_equal"] = all(
            _same(a, b) for a, b in zip(res[0]["grads"][kind],
                                         res[1]["grads"][kind]))
        rec[f"grads_{kind}"] = r
        ok[kind] = (r["w"]["ok"] and (not a_limits or r["alpha"]["ok"])
                    and r["ranks_bit_equal"])
    # the planted fault (the inner gradient not averaged) must fall
    # outside the second-order limits that the sound step meets
    fa, ra = res[0]["grads"]["second_fault"][0], ref["second"][0]
    rec["grads_second_fault"] = {"alpha": leaf_stats(
        [f"a{i}" for i in range(len(ra))], [g.double() for g in fa],
        [g.double() for g in ra], UNROLLED_ALPHA_LIMITS)}
    ok["second_fault_caught"] = not rec["grads_second_fault"]["alpha"]["ok"]
    per = res[0]["per_forward"]
    expected = {f"{k}_bf16": n * DP_STEPS for k, n in per.items()}
    rec["launches"] = [r["launches"] for r in res]
    rec["expected_launches"] = expected
    rec["params_bit_equal_after_steps"] = len(
        {r["params_digest"] for r in res}) == 1
    rec["trainer_history"] = res[0]["trainer_history"]
    rec["trainer_ranks_equal"] = (
        res[0]["trainer_history"] == res[1]["trainer_history"]
        and res[0]["trainer_digest"] == res[1]["trainer_digest"])
    # predict: each rank its patients; labels bit-equal to phase cli's
    # one-process predictions from the same checkpoint
    pred = res[0]["predict"]
    rec["predict_patients"] = [p["patient"] for p in pred]
    rec["predict_labels_equal_one_process"] = (
        pred == res[1]["predict"] and len(pred) == CLI_PATIENTS and all(
            np.array_equal(read_nifti(p["output"]).data, read_nifti(
                os.path.join(tmp, "pred", os.path.basename(p["output"])))
                .data) for p in pred))

    # the CLI under torchrun: world 1 on this card (NCCL), then 2 ranks on
    # 2 cards where there are
    cli_args = ["train", "-c", os.path.join(root, "config.json")]
    for o in CLI_OVERRIDES + [f"data.processed_dir={tmp}/store",
                              f"train.genotype_path={tmp}/absent.json",
                              "train.epochs=1"]:
        cli_args += ["-o", o]
    runs = {}
    for n in ((1, 2) if torch.cuda.device_count() >= 2 else (1,)):
        rc, secs, lines = _torchrun(n, cli_args + [
            "-o", f"train.checkpoint_dir={tmp}/torchrun{n}"],
            os.path.join(ddir, f"torchrun{n}.log"))
        done = [ln for ln in lines if ln.get("event") == "train_done"]
        runs[n] = {"rc": rc, "seconds": secs, "done": done}
    rec["torchrun"] = runs
    if torch.cuda.device_count() < 2:
        rec["torchrun_two_cards"] = "skipped: one card"
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    for kind, good in ok.items():
        if not good and kind == "second_fault_caught":
            raise AssertionError("dp: the second-order step with its inner "
                                 "gradient not averaged passes the limits")
        if not good:
            raise AssertionError(f"dp {kind}: gradients off the one-process "
                                 "step's limits or ranks differ")
    if any(r["launches"] != expected for r in res):
        raise AssertionError(f"dp launches {rec['launches']} != {expected}")
    if not rec["params_bit_equal_after_steps"] \
            or not rec["trainer_ranks_equal"]:
        raise AssertionError("dp: the ranks' parameters differ")
    if not all(math.isfinite(v) for r in res for v in r["losses"]) \
            or not all(math.isfinite(h["mean_dice"])
                       for h in rec["trainer_history"]):
        raise AssertionError("dp: non-finite loss or Dice")
    if not rec["predict_labels_equal_one_process"]:
        raise AssertionError("dp: predict labels differ from one rank's")
    for n, r in runs.items():
        if r["rc"] != 0 or len(r["done"]) != 1 \
                or r["done"][0].get("backend") != "nccl" \
                or r["done"][0].get("world") != n:
            raise AssertionError(f"torchrun {n}: {r}")
    return rec


SP_WORLD = 2
SP_STEPS = 3
SP_TIMEOUT = 900
# ξ of the second-order step on slabs (at DP_UNROLLED_PATCH^3, batch 1):
# the planted fault (the loss sums' identity adjoint in the inner graph)
# drops only the cross-slab terms of the Dice sums' curvature, and at
# PARITY_XI that moved α 0.0821 / 0.0396 / 0.99928 (rel. L2 max / median
# / cosine min), inside UNROLLED_ALPHA_LIMITS; at 0.1 it read 0.2119 /
# 0.0671 / 0.98020, outside all three, the sound step 0.0521 / 0.0373 /
# 0.99867 (chip_smoke.py phase "spatial", NVIDIA H100 80GB HBM3, 700 W)
SP_SECOND_XI = 0.1


def spatial_launches(one_process):
    """The launches a step on D-slabs makes, from the one-process step's:
    each K1 runs as K1-dx's kernel on its slab with the halo, then K5a on
    the crop (`pgemm.conv3x3x3_stats_slab`); every other kernel as many
    times."""
    out = dict(one_process)
    for t in ("bf16", "f32"):
        k1 = out.pop(f"conv3x3x3_stats_{t}", 0)
        for name in (f"conv3x3x3_{t}", f"moments_{t}"):
            if k1:
                out[name] = out.get(name, 0) + k1
    return out


def _moments_not_reduced():
    """A planted fault: the GroupNorms' forward moments left un-reduced
    (each rank normalizes with its slab's statistics over the whole
    volume's count); the backward's sums as the port reduces them."""
    from nas_3d_unet_tpu_torch.ops import groupnorm

    sound = groupnorm._global_sums

    def faulty(r1, r2, slab):
        if torch.is_grad_enabled():         # the forward's moments
            return r1, r2
        return sound(r1, r2, slab)

    return mock.patch.object(groupnorm, "_global_sums", faulty)


def _identity_adjoint_kept():
    """A planted fault: the second-order step's slabs keep the first-order
    convention (the loss sums' identity adjoint, each rank's loss seeded
    with 1), so its inner graph drops the cross-slab Hessian terms."""
    from nas_3d_unet_tpu_torch.search import bilevel

    return mock.patch.object(bilevel, "_exact", lambda slab: slab)


def spatial_runs(dev, seed, mesh):
    """The runs phase "spatial" compares, under `mesh` (None: in one
    process): {kind: (gradients, launches, s, peak GB)} for the first step
    of the derived bf16 train step ("derived"; with a mesh also "fault",
    `_moments_not_reduced`), its `use_pallas` twin ("pallas"), the
    first-order search step ("search": α's gradients, then w's, the
    former's count in "search_alphas") and the second-order one at
    DP_UNROLLED_PATCH^3, ξ = SP_SECOND_XI ("second", the same order; with a
    mesh also "second_fault", `_identity_adjoint_kept`); "steps":
    SP_STEPS AdamW steps with augmentation (the parameters' digest);
    "predict": one synthetic patient's labels.  Nothing else is
    updated (`_Recorder`)."""
    from nas_3d_unet_tpu_torch.ops import _cuda
    from nas_3d_unet_tpu_torch.search.bilevel import (
        make_search_step, make_search_step_unrolled)
    from nas_3d_unet_tpu_torch.train.loop import make_train_step
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer

    def timed(fn):
        torch.cuda.empty_cache()
        _cuda.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (dict(_cuda.LAUNCHES), time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(dev) / 2 ** 30)

    out = {}
    x, y = synthetic_batch(dev, seed)
    kinds = [("derived", False, None), ("pallas", True, None)]
    if mesh is not None:
        kinds.append(("fault", False, _moments_not_reduced()))
    for kind, use_pallas, fault in kinds:
        net = flagship_net(seed, "bfloat16", use_pallas).to(dev)
        rec = _Recorder(net.parameters())
        with fault or contextlib.nullcontext():
            launches, secs, peak = timed(
                lambda: make_train_step(net, rec, mesh=mesh)(x, y))
        out[kind] = ([g.cpu() for g in rec.grads], launches, secs, peak)
        del net, rec
    net, alphas, batches, _ = search_inputs(dev, seed)
    w_rec, a_rec = _Recorder(net.parameters()), _Recorder(alphas.values())
    launches, secs, peak = timed(lambda: make_search_step(
        net, w_rec, a_rec, alphas, mesh=mesh)(*batches))
    # α's gradients first, then w's
    out["search"] = ([g.cpu() for g in a_rec.grads + w_rec.grads], launches,
                     secs, peak)
    out["search_alphas"] = len(a_rec.grads)
    del net, alphas, w_rec, a_rec
    b = (*_dp_batch(dev, seed, DP_UNROLLED_PATCH, 1),
         *_dp_batch(dev, seed + 1, DP_UNROLLED_PATCH, 1))
    kinds = [("second", None)]
    if mesh is not None:
        kinds.append(("second_fault", _identity_adjoint_kept()))
    for kind, fault in kinds:
        net, alphas, _, _ = search_inputs(dev, seed)
        w_rec, a_rec = _Recorder(net.parameters()), _Recorder(alphas.values())
        with fault or contextlib.nullcontext():
            launches, secs, peak = timed(lambda: make_search_step_unrolled(
                net, w_rec, a_rec, alphas, SP_SECOND_XI, mesh=mesh)(*b))
        out[kind] = ([g.cpu() for g in a_rec.grads + w_rec.grads], launches,
                     secs, peak)
        del net, alphas, w_rec, a_rec
    if mesh is not None:
        net = flagship_net(seed, "bfloat16").to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        step = make_train_step(net, make_optimizer(net.parameters(), 3e-4,
                                                   1e-4),
                               augment=AUGMENT, gen=gen, mesh=mesh)
        step(x, y)                                  # warm-up
        losses = []
        launches, secs, peak = timed(lambda: losses.extend(
            step(x, y).item() for _ in range(SP_STEPS)))
        out["steps"] = (_digest(net.parameters()), losses, launches,
                        secs / SP_STEPS, peak)
        del net, step
    predictor = flagship_predictor(dev, seed)
    image = synthetic_records(dev, seed, 1)[0]["image_dev"]
    labels = []
    launches, secs, peak = timed(lambda: labels.append(
        predictor.predict_labels(image, mesh=mesh).cpu()))
    out["predict"] = (labels[0], launches, secs, peak)
    del predictor, image
    torch.cuda.empty_cache()
    return out


def spatial_rank_main(args) -> int:
    """One rank of phase "spatial" (`--sp-rank`): joins a gloo group of
    SP_WORLD ranks on the parent's card (`--sp-device`), lays them out as
    data 1 x spatial SP_WORLD and writes `spatial_runs` to
    <sp-dir>/rank<r>.pt."""
    from nas_3d_unet_tpu_torch import _build
    from nas_3d_unet_tpu_torch.parallel import mesh as dp
    from nas_3d_unet_tpu_torch.utils.precision import strict_fp32

    dev = torch.device(args.sp_device)
    dp.maybe_initialize_distributed(dev, backend="gloo")
    mesh = dp.make_mesh(1, SP_WORLD)
    _build.load()
    with strict_fp32():
        res = {"rank": mesh.rank, "world": mesh.world,
               "spatial": mesh.spatial,
               "backend": str(torch.distributed.get_backend()),
               "runs": spatial_runs(dev, args.seed, mesh)}
    torch.save(res, os.path.join(args.sp_dir, f"rank{mesh.rank}.pt"))
    dp.destroy()
    return 0


def phase_spatial(dev, seed, tmp):
    """Spatial sharding on the card: SP_WORLD ranks (processes of this
    script, `spatial_rank_main`) on card 0 over gloo at data 1 x spatial
    SP_WORLD, against this process's one-process runs."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    ref = spatial_runs(dev, seed, None)
    ref_s = time.perf_counter() - t0
    sdir = os.path.join(tmp, "spatial")
    os.makedirs(sdir)
    port = _free_port()
    procs = []
    for r in range(SP_WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(SP_WORLD),
                   LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        log = open(os.path.join(sdir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--sp-rank", str(r), "--sp-dir", sdir, "--sp-device", str(dev)],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    t0 = time.perf_counter()
    rcs = []
    try:
        for p, log in procs:
            rcs.append(p.wait(timeout=SP_TIMEOUT))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            log.close()
    ranks_s = time.perf_counter() - t0
    if any(rcs):
        tails = [open(os.path.join(sdir, f"rank{r}.log")).read()[-3000:]
                 for r in range(SP_WORLD)]
        raise AssertionError(f"spatial ranks exited {rcs}: {tails}")
    res = [torch.load(os.path.join(sdir, f"rank{r}.pt"), weights_only=False)
           for r in range(SP_WORLD)]
    runs = [r["runs"] for r in res]

    rec = {"phase": "spatial", "layout": f"data 1 x spatial {SP_WORLD}",
           "backend": res[0]["backend"],
           "card": "one card, both ranks: the times and memory are not "
                   "scaling numbers; spatial sharding across cards and "
                   "NCCL at two ranks are not run on one card",
           "reference_s": ref_s, "ranks_s": ranks_s}
    ok = {}
    # gradients: the ranks' (summed over the group) against one process's
    sound = {"fault": "derived", "second_fault": "second"}
    for kind, limits in (("derived", GRAD_LIMITS), ("pallas", P_GRAD_LIMITS),
                         ("search", ALPHA_LIMITS),
                         ("second", UNROLLED_ALPHA_LIMITS),
                         ("fault", GRAD_LIMITS),
                         ("second_fault", UNROLLED_ALPHA_LIMITS)):
        got, want = runs[0][kind][0], ref[sound.get(kind, kind)][0]
        r = {}
        if kind.startswith("second") or kind == "search":
            k = ref["search_alphas"]
            r["alpha"] = leaf_stats([f"a{i}" for i in range(k)],
                                    [g.double() for g in got[:k]],
                                    [g.double() for g in want[:k]],
                                    limits)
            r["w"] = leaf_stats([f"w{i}" for i in range(len(got) - k)],
                                [g.double() for g in got[k:]],
                                [g.double() for g in want[k:]])
            good = r["alpha"]["ok"] and (r["w"]["ok"]
                                         or kind == "second_fault")
        else:
            r["w"] = leaf_stats([f"w{i}" for i in range(len(got))],
                                [g.double() for g in got],
                                [g.double() for g in want], limits)
            good = r["w"]["ok"]
        if kind not in sound:
            r["ranks_bit_equal"] = all(
                _same(a, b) for a, b in zip(runs[0][kind][0],
                                             runs[1][kind][0]))
            good = good and r["ranks_bit_equal"]
            r["launches"] = [run[kind][1] for run in runs]
            r["expected_launches"] = spatial_launches(ref[kind][1])
            r["one_process_launches"] = ref[kind][1]
            r["launches_exact"] = all(
                la == r["expected_launches"] for la in r["launches"])
            # a first call: cold (cuDNN's and the caches' first use)
            r["first_call_s"] = [run[kind][2] for run in runs]
            r["peak_gb"] = [run[kind][3] for run in runs]
            r["one_process_first_call_s"], r["one_process_peak_gb"] = \
                ref[kind][2:4]
        rec[f"grads_{kind}"] = r
        ok[kind] = good
    ok["fault_caught"] = not ok.pop("fault")
    ok["second_fault_caught"] = not ok.pop("second_fault")
    rec["second_patch"] = DP_UNROLLED_PATCH
    rec["second_patch_why"] = ("time: at 128^3 the second-order step takes "
                               "~27 s a run, and the phase runs it 5 times")
    rec["second_xi"] = SP_SECOND_XI
    rec["second_xi_why"] = ("at PARITY_XI the planted fault moves α less "
                            "than the limits allow")
    # SP_STEPS AdamW steps: the ranks' parameters bit-equal, launches
    one_step = spatial_launches(ref["derived"][1])
    steps = [run["steps"] for run in runs]
    rec["steps"] = {
        "params_bit_equal": len({st[0] for st in steps}) == 1,
        "losses": [st[1] for st in steps],
        "launches": [st[2] for st in steps],
        "expected_launches": {k: n * SP_STEPS for k, n in one_step.items()},
        "step_s": [st[3] for st in steps],
        "peak_gb": [st[4] for st in steps]}
    rec["steps"]["launches_exact"] = all(
        la == rec["steps"]["expected_launches"]
        for la in rec["steps"]["launches"])
    # predict: the labels of one process, bit for bit
    rec["predict"] = {
        "labels_equal_one_process": all(
            run["predict"][0].shape == ref["predict"][0].shape
            and torch.equal(run["predict"][0], ref["predict"][0])
            for run in runs),
        "shape": list(ref["predict"][0].shape),
        "launches": [run["predict"][1] for run in runs],
        "expected_launches": ref["predict"][1],
        "s": [run["predict"][2] for run in runs],
        "peak_gb": [run["predict"][3] for run in runs],
        "one_process_s": ref["predict"][2],
        "one_process_peak_gb": ref["predict"][3]}
    rec["predict"]["launches_exact"] = all(
        la == ref["predict"][1] for la in rec["predict"]["launches"])
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    for kind, good in ok.items():
        if kind == "fault_caught" and not good:
            raise AssertionError("spatial: the GroupNorm moments left "
                                 "un-reduced pass the train step's limits")
        if kind == "second_fault_caught" and not good:
            raise AssertionError("spatial: the second-order step with the "
                                 "loss sums' identity adjoint passes the "
                                 "limits")
        if not good:
            raise AssertionError(f"spatial {kind}: gradients off the "
                                 "one-process step's limits or ranks differ")
    for kind in ("derived", "pallas", "search", "second"):
        if not rec[f"grads_{kind}"]["launches_exact"]:
            raise AssertionError(f"spatial {kind} launches: "
                                 f"{rec[f'grads_{kind}']}")
    if not rec["steps"]["params_bit_equal"] \
            or not rec["steps"]["launches_exact"] \
            or not all(math.isfinite(v) for st in steps for v in st[1]):
        raise AssertionError(f"spatial steps: {rec['steps']}")
    if not rec["predict"]["labels_equal_one_process"] \
            or not rec["predict"]["launches_exact"]:
        raise AssertionError(f"spatial predict: {rec['predict']}")
    return rec


def write_raw_patients(raw_dir, seed):
    """CLI_PATIENTS BraTS-layout patients under raw_dir/HGG and LGG: four
    RAW_SHAPE fp32 modalities, zero outside an ellipsoid head, and a
    segmentation with {0, 1, 2, 4} blobs (edema, necrotic core, enhancing
    tumour) inside it; `.nii`, not `.nii.gz` (gzip would cost seconds a
    patient and test nothing here)."""
    from nas_3d_unet_tpu_torch.io.nifti import write_nifti

    rng = np.random.default_rng(seed)
    grid = np.ogrid[tuple(slice(0, n) for n in RAW_SHAPE)]
    centre = [n / 2 for n in RAW_SHAPE]
    for i in range(CLI_PATIENTS):
        name = f"BraTS_smoke_{i}"
        pdir = os.path.join(raw_dir, "HGG" if i < 2 else "LGG", name)
        os.makedirs(pdir)
        # semi-axes: a cropped head of ~145 x 175 x 140, as BraTS's are
        axes = [f * n * (1 + 0.05 * rng.random())
                for f, n in zip((0.3, 0.36, 0.45), RAW_SHAPE)]
        head = sum(((g - c) / a) ** 2
                   for g, c, a in zip(grid, centre, axes)) < 1
        tumour = [c + 0.3 * a * (rng.random() - 0.5)
                  for c, a in zip(centre, axes)]
        r2 = sum((g - c) ** 2 for g, c in zip(grid, tumour))
        seg = np.zeros(RAW_SHAPE, np.uint8)
        seg[(r2 < 20 ** 2) & head] = 2
        seg[(r2 < 12 ** 2) & head] = 4
        seg[(r2 < 6 ** 2) & head] = 1
        n = int(head.sum())
        for m, gain in zip(("t1", "t1ce", "t2", "flair"), (0, 60, 30, 80)):
            vol = np.zeros(RAW_SHAPE, np.float32)
            vol[head] = 400 + 60 * rng.standard_normal(n, dtype=np.float32)
            vol += gain * (seg > 0)
            write_nifti(os.path.join(pdir, f"{name}_{m}.nii"), vol)
        write_nifti(os.path.join(pdir, f"{name}_seg.nii"), seg)


class _Tee(io.StringIO):
    """stdout kept as it is written, and passed on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def _cli(args):
    """`cli.main(args)`; returns the JSON lines it printed, and seconds."""
    from nas_3d_unet_tpu_torch import cli

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout)) as out:
        rc = cli.main(args)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{args[0]} exited {rc}")
    return [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")], secs


def _jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def grad_repeatability(dev, seed):
    """Whether one train step's gradients repeat bit for bit on the card
    (what a bitwise resume needs): the count of parameter leaves whose
    gradient differs between two runs on the same batch, as the path runs
    and with cuDNN held to deterministic algorithms, and the ops that
    `torch.use_deterministic_algorithms` reports having no deterministic
    implementation."""
    import warnings

    from nas_3d_unet_tpu_torch.metrics.losses import dice_ce_loss
    from nas_3d_unet_tpu_torch.train.loop import loss_and_grads

    net = flagship_net(seed, "bfloat16").to(dev)
    x, y = synthetic_batch(dev, seed)

    def twice():
        runs = []
        for _ in range(2):
            loss, grads = loss_and_grads(net, x, y, dice_ce_loss, MICRO)
            runs.append((loss.item(), [g.clone() for g in grads]))
        (la, ga), (lb, gb) = runs
        return la == lb, [n for n, a, b in zip(names, ga, gb)
                          if not torch.equal(a, b)]

    names = [n for n, _ in net.named_parameters()]
    out = {"leaves": len(names)}
    out["loss_equal"], differ = twice()
    out["leaves_differ"] = len(differ)
    out["leaves_differ_names"] = differ
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        out["cudnn_deterministic_loss_equal"], differ = twice()
        out["cudnn_deterministic_leaves_differ"] = len(differ)
    finally:
        cudnn.deterministic = saved
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss_and_grads(net, x, y, dice_ce_loss, MICRO)
        finally:
            torch.use_deterministic_algorithms(False)
    out["nondeterministic_ops"] = sorted({
        str(w.message).split(". ")[0][:160] for w in caught})
    net.zero_grad(set_to_none=True)
    del net, x, y
    out["cudnn_backward_repeats"] = cudnn_backward_repeats(dev, seed)
    return out


def cudnn_backward_repeats(dev, seed):
    """Whether the cuDNN backwards of the path repeat bit for bit at the
    flagship's two largest levels (bf16, batch 1, as a microbatch runs
    them): the depthwise 3³ conv's dx and dw (SepConv) and K1's plain
    weight gradient (`conv3d_weight`), each twice on the same inputs."""
    from nas_3d_unet_tpu_torch.ops.conv3d import conv3d_same

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for edge, c in ((128, 16), (64, 32)):
        x = torch.randn((1, edge, edge, edge, c), generator=gen,
                        device=dev).bfloat16()
        g = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
        w = torch.randn((3, 3, 3, 1, c), generator=gen, device=dev) * 0.2
        wk = torch.randn((3, 3, 3, c, c), generator=gen, device=dev) * 0.05
        runs = []
        for _ in range(2):
            xr = x.clone().requires_grad_()
            wr = w.bfloat16().requires_grad_()
            conv3d_same(xr, wr, 1, groups=c).backward(g)
            dwk = torch.nn.grad.conv3d_weight(
                x.permute(0, 4, 1, 2, 3), wk.permute(4, 3, 0, 1, 2).shape,
                g.permute(0, 4, 1, 2, 3), padding=1)
            runs.append((xr.grad, wr.grad, dwk))
        (a, b) = runs
        out[f"{edge}^3x{c}"] = {
            "depthwise_dx": torch.equal(a[0], b[0]),
            "depthwise_dw": torch.equal(a[1], b[1]),
            "conv_weight": torch.equal(a[2], b[2])}
    return out


def phase_cli(dev, seed, slice_s_per_patient, train_rec, tmp):
    """The package's commands on patients written to disk (phase 6b):
    `preprocess`, `train` (twice more to hold a resume against the
    uninterrupted run) and `predict`, in-process through `cli.main`, from
    the root config.json at full width, all under `tmp` (phase "dp" reads
    its store, checkpoints and predictions).  Launches are read around the
    uninterrupted `train` and around `predict`, and checked last."""

    from nas_3d_unet_tpu_torch.infer.sliding import grid_coords
    from nas_3d_unet_tpu_torch.io.nifti import read_nifti
    from nas_3d_unet_tpu_torch.models.genotype import (Genotype,
                                                       default_genotype)
    from nas_3d_unet_tpu_torch.models.unet import make_derived
    from nas_3d_unet_tpu_torch.ops import _cuda
    from nas_3d_unet_tpu_torch.train import checkpoint as ck
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer
    from nas_3d_unet_tpu_torch.utils.config import (load_config,
                                                    parse_overrides)

    from nas_3d_unet_tpu_torch.data.native import _native

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    write_raw_patients(os.path.join(tmp, "raw"), seed)
    write_s = time.perf_counter() - t_phase
    overrides = CLI_OVERRIDES + [
        f"data.raw_dir={tmp}/raw", f"data.processed_dir={tmp}/store",
        f"train.genotype_path={tmp}/absent.json",
        f"infer.output_dir={tmp}/pred"]
    cfg = load_config(os.path.join(root, "config.json"),
                      parse_overrides(overrides))
    base = ["-c", os.path.join(root, "config.json"),
            "--device", str(dev)]
    for o in overrides:
        base += ["-o", o]

    # preprocess, on the native path (as by default), then timed beside it
    # on the numpy path into a store of its own
    _native.CALLS.clear()
    _, pre_s = _cli(["preprocess", *base])
    native_calls = dict(_native.CALLS)
    with mock.patch.dict(os.environ, {"NAS3D_NO_NATIVE": "1"}):
        _, pre_numpy_s = _cli(["preprocess", *base, "-o",
                               f"data.processed_dir={tmp}/store_numpy"])
    numpy_calls = dict(_native.CALLS)
    native_vs_numpy = {}
    for name in sorted(os.listdir(f"{tmp}/store_numpy")):
        with np.load(os.path.join(cfg.data.processed_dir, name)) as f:
            a = {k: f[k] for k in ("image", "crop_start", "label")}
        with np.load(f"{tmp}/store_numpy/{name}") as f:
            b = {k: f[k] for k in ("image", "crop_start", "label")}
        native_vs_numpy[name] = {
            "image_max_abs": float(np.abs(a["image"] - b["image"]).max()),
            "image_differ": int((a["image"] != b["image"]).sum()),
            "crop_and_label_equal": bool(
                np.array_equal(a["crop_start"], b["crop_start"])
                and np.array_equal(a["label"], b["label"]))}
    shutil.rmtree(f"{tmp}/store_numpy")
    store = sorted(os.listdir(cfg.data.processed_dir))
    crops = []
    for name in store:
        with np.load(os.path.join(cfg.data.processed_dir, name)) as f:
            if set(f.files) != NPZ_KEYS or f["image"].dtype != np.float32 \
                    or f["image"].shape[-1] != 4 \
                    or f["label"].dtype != np.uint8:
                raise AssertionError(f"{name}: {f.files}")
            crops.append(f["image"].shape[:3])
    if len(store) != CLI_PATIENTS:
        raise AssertionError(f"preprocess wrote {store}")

    # train, uninterrupted, with the launches read around it
    def train(ckpt, epochs):
        return _cli(["train", *base, "-o", f"train.epochs={epochs}",
                     "-o", f"train.checkpoint_dir={tmp}/{ckpt}"])

    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    _, train_s = train("a", cfg.train.epochs)
    torch.cuda.synchronize()
    train_launches = dict(_cuda.LAUNCHES)
    epochs = [e for e in _jsonl(f"{tmp}/a/metrics.jsonl")
              if e["event"] == "epoch"]
    with open(f"{tmp}/a/metadata.json") as f:
        meta = json.load(f)
    ok_train = (len(epochs) == cfg.train.epochs
                and all(math.isfinite(e[k]) for e in epochs
                        for k in ("train_loss", "val_loss",
                                  "mean_dice"))
                and os.path.exists(f"{tmp}/a/best.npz")
                and meta["step"] == cfg.train.epochs
                * cfg.train.steps_per_epoch)

    # resume: one epoch in a fresh dir, then resumed to the second
    _, r1_s = train("b", cfg.train.epochs - 1)
    _, r2_s = train("b", cfg.train.epochs)
    spe = cfg.train.steps_per_epoch
    resumes = [e["step"] for e in _jsonl(f"{tmp}/b/metrics.jsonl")
               if e["event"] == "resume"]
    last = cfg.train.epochs * spe
    full = ck.load_checkpoint(f"{tmp}/a/ckpt_{last}.npz")
    resumed = ck.load_checkpoint(f"{tmp}/b/ckpt_{last}.npz")
    params = [k for k in full if k.startswith("params/")]
    deltas = {k[len("params/"):]: float(np.abs(
        full[k].astype(np.float64) - resumed[k]).max()) for k in params}
    bit_equal = sum(full[k].tobytes() == resumed[k].tobytes()
                    for k in params)
    # train.steps_per_call 3 (one CUDA graph replay a call): one epoch in a
    # fresh dir, then resumed to the second
    n_runs_s = [_cli(["train", *base, "-o", "train.steps_per_call=3",
                      "-o", f"train.epochs={e}",
                      "-o", f"train.checkpoint_dir={tmp}/n"])[1]
                for e in (cfg.train.epochs - 1, cfg.train.epochs)]
    n_events = _jsonl(f"{tmp}/n/metrics.jsonl")
    n_epochs = [e for e in n_events if e["event"] == "epoch"]
    n_resumes = [e["step"] for e in n_events if e["event"] == "resume"]
    ok_n = (n_resumes == [spe] and len(n_epochs) == cfg.train.epochs
            and all(math.isfinite(e[k]) for e in n_epochs
                    for k in ("train_loss", "val_loss", "mean_dice"))
            and os.path.exists(f"{tmp}/n/ckpt_{last}.npz"))
    # a checkpoint loaded onto the card and saved again is byte-equal
    first = ck.load_checkpoint(f"{tmp}/b/ckpt_{spe}.npz")
    net = make_derived(cfg.model, cfg.data.num_classes,
                       default_genotype(cfg.model.n_nodes)).to(dev)
    opt = make_optimizer(net.parameters(), cfg.train.lr,
                         cfg.train.weight_decay)
    gen = torch.Generator(device=dev)
    step = ck.restore_train_state(first, net, opt, gen)
    again = ck.load_checkpoint(ck.save_checkpoint(
        f"{tmp}/c", step, ck.train_state(net, opt, step, gen)))
    resave_equal = set(again) == set(first) and all(
        again[k].tobytes() == first[k].tobytes() for k in first)
    del net, opt, gen
    repeat = grad_repeatability(dev, seed)

    # predict from the uninterrupted run's checkpoint dir (fp32 body)
    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    lines, predict_s = _cli(["predict", *base,
                             "-o", f"infer.checkpoint_dir={tmp}/a"])
    predict_launches = dict(_cuda.LAUNCHES)
    patients = [ln for ln in lines if "patient" in ln]
    done = lines[-1]
    outputs = [read_nifti(p["output"]).data for p in patients]

    # search: one warmup epoch, then resumed for one bilevel epoch
    def search(epochs):
        args = ["search", *base, "-o", f"search.epochs={epochs}",
                "-o", f"search.checkpoint_dir={tmp}/s"]
        for o in CLI_SEARCH:
            args += ["-o", o]
        return _cli(args)

    scfg = load_config(os.path.join(root, "config.json"),
                       parse_overrides(overrides + CLI_SEARCH)).search
    _, search1_s = search(1)
    search_lines, search2_s = search(2)
    search_events = _jsonl(f"{tmp}/s/metrics.jsonl")
    search_epochs = [e for e in search_events if e["event"] == "epoch"]
    search_resumes = [e["step"] for e in search_events
                      if e["event"] == "resume"]
    genotype = Genotype.load(f"{tmp}/s/genotype.json")
    genotype.validate()
    ok_search = (
        search_resumes == [scfg.steps_per_epoch]
        and [(e["epoch"], e["warmup"]) for e in search_epochs]
        == [(0, True), (1, False)]
        and all(math.isfinite(e[k]) for e in search_epochs
                for k in ("train_loss", "val_loss"))
        and math.isfinite(search_epochs[1]["eval_loss"])
        and os.path.exists(f"{tmp}/s/ckpt_{2 * scfg.steps_per_epoch}"
                           ".npz")
        and search_lines[-1] == {"event": "search_done",
                                 "genotype": f"{tmp}/s/genotype.json"})

    stride = tuple(max(1, int(round(p * (1 - cfg.infer.overlap))))
                   for p in cfg.infer.patch_size)
    # the window grid of each crop, end-padded to at least one patch
    forwards = sum(math.ceil(len(grid_coords(
        [max(n, p) for n, p in zip(c, cfg.infer.patch_size)],
        cfg.infer.patch_size, stride)) / cfg.infer.batch_size) for c in crops)
    evals = cfg.train.epochs * CLI_VAL_STEPS
    slices = cfg.data.batch_size // cfg.train.microbatch
    steps = cfg.train.epochs * spe
    per_step = _modules_per_forward(make_derived(
        cfg.model, cfg.data.num_classes, default_genotype(cfg.model.n_nodes)))
    per_fwd = _modules_per_forward(make_derived(
        cfg.model, cfg.data.num_classes, default_genotype(cfg.model.n_nodes),
        dtype_override=cfg.infer.dtype))
    expected_train = {f"{k}_bf16": n * (slices * steps + (
        evals if k in FORWARD_KERNELS else 0)) for k, n in per_step.items()}
    expected_predict = {f"{k}_f32": n * forwards for k, n in per_fwd.items()
                        if k in FORWARD_KERNELS}
    pps = [e["patches_per_sec"] for e in epochs]
    rec = {"phase": "cli", "seconds": time.perf_counter() - t_phase,
           "write_raw_s": write_s, "preprocess_s": pre_s,
           "preprocess_s_per_patient": {
               "native": pre_s / CLI_PATIENTS,
               "numpy": pre_numpy_s / CLI_PATIENTS},
           "native_ran": native_calls, "native_library": str(
               _native.library_path()) if _native.available() else None,
           "native_vs_numpy": native_vs_numpy,
           "train_s": train_s, "resume_runs_s": [r1_s, r2_s],
           "predict_s": predict_s, "raw_shape": list(RAW_SHAPE),
           "crops": [list(c) for c in crops],
           "train_losses": [e["train_loss"] for e in epochs],
           "val_losses": [e["val_loss"] for e in epochs],
           "patches_per_sec": pps,
           "train_phase_patches_per_s": train_rec["patches_per_s"],
           "s_per_patient": predict_s / len(patients),
           "patient_seconds": [p["seconds"] for p in patients],
           "slice_phase_s_per_patient": slice_s_per_patient,
           "mean_dice": done.get("mean_dice"),
           "resume_events": resumes, "resave_byte_equal": resave_equal,
           "resume_params_bit_equal": f"{bit_equal}/{len(params)}",
           "resume_max_abs_delta": max(deltas.values()),
           "resume_worst_params": sorted(deltas.items(),
                                         key=lambda kv: -kv[1])[:5],
           "grad_repeat": repeat,
           "steps_per_call_3": {
               "runs_s": n_runs_s, "resume_events": n_resumes,
               "train_losses": [e["train_loss"] for e in n_epochs],
               "val_losses": [e["val_loss"] for e in n_epochs],
               "patches_per_sec": [e["patches_per_sec"] for e in n_epochs]},
           "train_launches": train_launches,
           "expected_train_launches": expected_train,
           "search_s": [search1_s, search2_s],
           "search_resume_events": search_resumes,
           "search_epochs": [{k: e.get(k) for k in (
               "epoch", "warmup", "train_loss", "val_loss", "eval_loss",
               "patches_per_sec")} for e in search_epochs],
           "search_genotype": json.loads(genotype.to_json()),
           "predict_forwards": forwards,
           "predict_launches": predict_launches,
           "expected_predict_launches": expected_predict}
    emit(rec)
    if native_calls != {"zscore_in_mask": 4 * CLI_PATIENTS,
                        "union_foreground_bbox": CLI_PATIENTS} \
            or numpy_calls != native_calls:
        raise AssertionError(f"preprocess: native calls {native_calls}, "
                             f"then {numpy_calls} ({_native.build_error()})")
    if not all(v["crop_and_label_equal"] and v["image_max_abs"] <= 1e-5
               for v in native_vs_numpy.values()):
        raise AssertionError(f"native against numpy: {native_vs_numpy}")
    if not ok_train:
        raise AssertionError(f"train: epochs {epochs}, metadata {meta}")
    if resumes != [spe] or not resave_equal:
        raise AssertionError(f"resume events {resumes}, re-saved "
                             f"checkpoint byte-equal: {resave_equal}")
    if not ok_n:
        raise AssertionError(f"train with steps_per_call 3: epochs "
                             f"{n_epochs}, resumes {n_resumes}")
    if not ok_search:
        raise AssertionError(f"search: epochs {search_epochs}, resumes "
                             f"{search_resumes}, last line {search_lines[-1]}")
    if len(patients) != CLI_PATIENTS or done.get("event") != "predict_done":
        raise AssertionError(f"predict: {lines}")
    for p, lab in zip(patients, outputs):
        if not p["output"].endswith(".nii.gz") \
                or tuple(lab.shape) != RAW_SHAPE or lab.dtype != np.uint8 \
                or not set(np.unique(lab).tolist()) <= {0, 1, 2, 4} \
                or not all(math.isfinite(v) for v in p["dice"].values()):
            raise AssertionError(f"bad prediction {p} {lab.shape}")
    if train_launches != expected_train \
            or predict_launches != expected_predict:
        raise AssertionError(
            f"launches: train {train_launches} != {expected_train}, "
            f"predict {predict_launches} != {expected_predict}")
    return rec


# Phase "quality": the chip-scale twins of the JAX package's quality runs
# (experiments/r4_learn_chip.py, r5_genotype_chip.py): 4 patients of
# QUALITY_SHAPE, 64^3 patches, batch 1, the shipped bf16 body at base 16,
# depth 3, 3 nodes; train 4 x 50 steps at lr 1e-3; search 3 x 40 steps (1
# warmup epoch; r5's 5 x 40 took ~410 s a search on the H100, a bilevel
# step at 64^3 ~2.2 s, most of it host time) at α lr 3e-2 with 2 eval
# batches; no augmentation on the shift task (a flip reverses the shift
# the label encodes).  Each task's commands run in a child process
# beside phases "dp" and "spatial".
QUALITY_SHAPE = (96, 112, 80)
QUALITY_PATIENTS = 4
QUALITY_SHIFT = 6
QUALITY_OVERRIDES = [
    "data.patch_size=(64,64,64)", "data.batch_size=1",
    "data.val_fraction=0.25", "model.base_channels=16", "model.depth=3",
    "model.n_nodes=3", "model.gn_groups=8", "model.dtype=bfloat16",
    "model.remat=false", "train.epochs=4", "train.steps_per_epoch=50",
    "train.lr=0.001", "infer.patch_size=(64,64,64)", "infer.overlap=0.5",
    "infer.batch_size=1", "parallel.data_parallel=1"]
QUALITY_SEARCH = [
    "data.flip_prob=0", "data.intensity_shift=0", "data.intensity_scale=0",
    "search.epochs=3", "search.steps_per_epoch=40", "search.warmup_epochs=1",
    "search.alpha_lr=0.03", "search.val_steps=2", "search.batch_size=1"]
QUALITY_WT = 0.7
QUALITY_TIMEOUT = 900           # the children's commands, from their start
QUALITY_CONV_OPS = 3
QUALITY_KERNELS = ("conv3x3x3_stats_bf16", "conv3x3x3_bf16",
                   "gemm_stats_bf16", "moments_bf16", "weighted_sums_bf16")
CONV_FAMILY = {"conv3", "dil_conv3", "sep_conv3", "down_conv3",
               "down_dil_conv3", "down_sep_conv3", "up_transpose", "up_conv3",
               "up_sep_conv3"}
NORMAL_GROUPS = ("down_mid", "up_skip", "up_mid")    # the α groups with none


def write_quality_patients(raw_dir, task, seed):
    """QUALITY_PATIENTS BraTS-layout patients of QUALITY_SHAPE (`.nii`):
    "learn", r4_learn_chip.py's task (a blob in t1ce with a brighter core
    and in flair over low noise, labelled 2 with a core of 4); "shift",
    r5_genotype_chip.py's (the label is the t1ce blob shifted by
    +QUALITY_SHIFT on every axis); "noise", the shift task's control (the
    label blob placed independently of the image blob, as
    tests/helpers.py `write_shifted_h5(noise=True)` places it)."""
    from nas_3d_unet_tpu_torch.io.nifti import write_nifti

    shape = QUALITY_SHAPE
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]

    def sphere(c, r):
        return (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < r * r

    for i in range(QUALITY_PATIENTS):
        name = f"BraTS19_{task}_{i}"
        pdir = os.path.join(raw_dir, "HGG" if i % 2 == 0 else "LGG", name)
        os.makedirs(pdir)
        seg = np.zeros(shape, np.uint8)
        if task == "learn":
            c = [int(rng.integers(2 * n // 5, 3 * n // 5)) for n in shape]
            r = min(shape) // 3
            blob, core = sphere(c, r), sphere(c, r - 8)
            seg[blob], seg[core] = 2, 4
        else:
            r = min(shape) // 4
            c = [int(rng.integers(r + 2, n - r - QUALITY_SHIFT - 2))
                 for n in shape]
            blob = sphere(c, r)
            cl = ([int(rng.integers(r + 2, n - r - 2)) for n in shape]
                  if task == "noise" else [v + QUALITY_SHIFT for v in c])
            seg[sphere(cl, r)], seg[sphere(cl, r - 6)] = 2, 4
        for mod in ("t1", "t1ce", "t2", "flair"):
            vol = rng.random(shape).astype(np.float32) * 0.2 + 0.1
            if mod == "t1ce":
                vol = vol + 1.0 * blob
                if task == "learn":
                    vol = vol + 0.5 * core
            elif mod == "flair" and task == "learn":
                vol = vol + 0.8 * blob
            if task == "learn":
                vol += rng.random(shape).astype(np.float32) * 0.05
            write_nifti(os.path.join(pdir, f"{name}_{mod}.nii"), vol)
        write_nifti(os.path.join(pdir, f"{name}_seg.nii"), seg)


def _alpha_masses(alphas):
    """Mean softmax mass of the conv-family ops and of `none` over the
    α groups drawn from NORMAL_OPS (tests/test_search_quality.py's)."""
    from nas_3d_unet_tpu_torch.ops.primitives import NORMAL_OPS

    probs = []
    for g in NORMAL_GROUPS:
        a = np.asarray(alphas[g], np.float64)
        p = np.exp(a - a.max(-1, keepdims=True))
        probs.append(p / p.sum(-1, keepdims=True))
    p = np.concatenate(probs)
    conv = [i for i, o in enumerate(NORMAL_OPS) if o in CONV_FAMILY]
    return (float(p[:, conv].sum(-1).mean()),
            float(p[:, NORMAL_OPS.index("none")].mean()))


def _quality_args(dev, tmp, task, cmd):
    """The command line of `cmd` on quality task `task` under `tmp`: the
    root config.json with QUALITY_OVERRIDES (and QUALITY_SEARCH on the
    shift and noise tasks) and the task's directories."""
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(tmp, task)
    args = [cmd, "-c", os.path.join(root, "config.json"), "--device",
            str(dev)]
    for o in [*QUALITY_OVERRIDES,
              *(QUALITY_SEARCH if task != "learn" else []),
              f"data.raw_dir={d}/raw", f"data.processed_dir={d}/store",
              f"train.checkpoint_dir={d}/train",
              f"infer.checkpoint_dir={d}/train", f"infer.output_dir={d}/pred",
              f"search.checkpoint_dir={d}/search",
              f"train.genotype_path={d}/search/genotype.json"]:
        args += ["-o", o]
    return args


# commands (a JSON list of command lines) in a child process, one after
# the other, with TF32 off and cuDNN's deterministic algorithms; after
# each, a line with its seconds and the kernels it launched
_QUALITY_CHILD = """import json
import sys
import time
import torch
from nas_3d_unet_tpu_torch.cli import main
from nas_3d_unet_tpu_torch.ops import _cuda
from nas_3d_unet_tpu_torch.utils.precision import strict_fp32
torch.backends.cudnn.deterministic = True
with strict_fp32():
    for args in json.loads(sys.argv[1]):
        _cuda.LAUNCHES.clear()
        t0 = time.perf_counter()
        if main(args):
            sys.exit(1)
        torch.cuda.synchronize()
        print(json.dumps({"command": args[0],
                          "seconds": time.perf_counter() - t0,
                          "launches": dict(_cuda.LAUNCHES)}), flush=True)
"""
# each child's commands: (a), (b), (c)
QUALITY_CHILDREN = {"learn": ("train", "predict"),
                    "shift": ("search", "train", "predict"),
                    "noise": ("search",)}


def quality_start(dev, seed, tmp):
    """Phase "quality"'s first half: the three tasks' patients written
    and preprocessed here (the native path counted), then each task's
    commands started in a child process (QUALITY_CHILDREN), to run beside
    the phases that follow; `quality_finish` waits for them."""
    from nas_3d_unet_tpu_torch.data.native import _native

    t_phase = time.perf_counter()
    rec = {"phase": "quality", "cudnn_deterministic": True,
           "shape": list(QUALITY_SHAPE), "patients": QUALITY_PATIENTS,
           "search": QUALITY_SEARCH, "seconds_by_stage": {}, "launches": {}}
    secs = rec["seconds_by_stage"]
    for task in QUALITY_CHILDREN:
        t0 = time.perf_counter()
        write_quality_patients(os.path.join(tmp, task, "raw"), task, seed)
        secs[f"{task}_write"] = time.perf_counter() - t0
        _native.CALLS.clear()
        _, secs[f"{task}_preprocess"] = _cli(
            _quality_args(dev, tmp, task, "preprocess"))
        rec[f"{task}_native_calls"] = dict(_native.CALLS)
    root = os.path.dirname(os.path.abspath(__file__))
    children = {}
    try:
        for task, cmds in QUALITY_CHILDREN.items():
            path = os.path.join(tmp, task, "commands.log")
            with open(path, "w") as log:
                children[task] = (subprocess.Popen(
                    [sys.executable, "-c", _QUALITY_CHILD, json.dumps(
                        [_quality_args(dev, tmp, task, c) for c in cmds])],
                    cwd=root, stdout=log, stderr=subprocess.STDOUT), path)
    except BaseException:
        quality_stop(children)
        raise
    return {"rec": rec, "tmp": tmp, "children": children,
            "t_phase": t_phase, "t_children": time.perf_counter()}


def quality_stop(children):
    """Kill the children of `quality_start` that still run."""
    for proc, _ in children.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def quality_finish(q):
    """Phase "quality"'s second half: wait for the children, read their
    results and hold them to the bars.  Whether the port learns and
    whether its search selects signal, at chip scale, through the
    commands on NIfTI written from the seed: (a) `train` (the default
    genotype) and `predict` on the learnable task: mean WT Dice >=
    QUALITY_WT; (b) `search`, `train` of the searched genotype and
    `predict` on the shift task: WT >= QUALITY_WT and >= QUALITY_CONV_OPS
    conv-family ops in the genotype; (c) the same search on the noise
    control: the signal's final conv mass above the control's.  The
    native preprocessing ran, and every search and train launched K1,
    K1-dx, K2, K5a and K5b.  The commands run under cuDNN's
    deterministic algorithms, so the phase's numbers repeat run to run."""
    from nas_3d_unet_tpu_torch.data.native import _native
    from nas_3d_unet_tpu_torch.models.genotype import Genotype
    from nas_3d_unet_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                        load_checkpoint)

    rec, tmp = q["rec"], q["tmp"]
    secs = rec["seconds_by_stage"]
    deadline = q["t_children"] + QUALITY_TIMEOUT
    outputs = {}
    try:
        for task, (proc, path) in q["children"].items():
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            with open(path) as f:
                out = f.read()
            if rc != 0:
                raise AssertionError(f"quality {task}: the commands exited "
                                     f"{rc}:\n{out[-3000:]}")
            outputs[task] = [json.loads(ln) for ln in out.splitlines()
                             if ln.startswith("{")]
    finally:
        quality_stop(q["children"])
    secs["children_wall"] = time.perf_counter() - q["t_children"]
    for task, lines in outputs.items():
        for ln in lines:
            if "command" in ln:
                secs[f"{task}_{ln['command']}"] = ln["seconds"]
                rec["launches"][f"{task}_{ln['command']}"] = {
                    k: ln["launches"].get(k, 0) for k in QUALITY_KERNELS}
        if task != "noise":
            rec[f"{task}_train_losses"] = [
                e["train_loss"] for e in lines
                if e.get("event") == "epoch" and "mean_dice" in e]
            done = [e for e in lines if e.get("event") == "predict_done"]
            rec[f"{task}_dice"] = done[-1].get("mean_dice") if done else None
    for task in ("shift", "noise"):
        d = os.path.join(tmp, task, "search")
        genotype = Genotype.load(os.path.join(d, "genotype.json"))
        ops = [op for node in genotype.down + genotype.up for _, op in node]
        arrays = load_checkpoint(latest_checkpoint(d)[1])
        conv, none = _alpha_masses({k[len("alphas/"):]: v
                                    for k, v in arrays.items()
                                    if k.startswith("alphas/")})
        epochs = [e for e in _jsonl(os.path.join(d, "metrics.jsonl"))
                  if e.get("event") == "epoch"]
        rec[f"{task}_search"] = {
            "conv_ops": sum(op in CONV_FAMILY for op in ops),
            "ops": len(ops), "conv_mass": conv, "none_mass": none,
            "eval_dice_wt": [e.get("dice_wt") for e in epochs
                             if not e["warmup"]]}
    rec["seconds"] = time.perf_counter() - q["t_phase"]
    emit(rec)
    for task in QUALITY_CHILDREN:
        if rec[f"{task}_native_calls"] != {
                "zscore_in_mask": 4 * QUALITY_PATIENTS,
                "union_foreground_bbox": QUALITY_PATIENTS}:
            raise AssertionError(f"quality {task}: the native preprocessing "
                                 f"did not run ({_native.build_error()})")
    for stage, launches in rec["launches"].items():
        if stage.endswith(("_train", "_search")) and not all(
                launches.values()):
            raise AssertionError(f"quality {stage}: a kernel never launched "
                                 f"{launches}")
    for task in ("learn", "shift"):
        dice = rec[f"{task}_dice"]
        if not dice or not dice["WT"] >= QUALITY_WT:
            raise AssertionError(f"quality {task}: WT Dice {dice} < "
                                 f"{QUALITY_WT}")
    if rec["shift_search"]["conv_ops"] < QUALITY_CONV_OPS:
        raise AssertionError(f"quality: the searched genotype holds "
                             f"{rec['shift_search']['conv_ops']} conv ops")
    if not rec["shift_search"]["conv_mass"] > rec["noise_search"]["conv_mass"]:
        raise AssertionError("quality: the signal's conv mass is not above "
                             "the control's")
    return rec


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


# traces that came back holding no kernel and were taken again
TRACE_RETAKES = []


def kernels_launched(fn, *args, every=False, tries=3):
    """The names of the device kernels one call of `fn` launches, from a
    `torch.profiler` trace (demangled: `(anonymous namespace)::...`):
    each name once, sorted, or with `every` each launch in launch order.
    Every call traced here launches a kernel, so a trace holding none is
    the profiler's loss (seen on the card: a few consecutive traces came
    back empty): the call is traced again, up to `tries` times, and each
    retake is noted in TRACE_RETAKES."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        names = [e["name"] for e in sorted(events,
                                           key=lambda e: e.get("ts", 0))
                 if e.get("cat") == "kernel"]
        if names:
            break
        TRACE_RETAKES.append(getattr(fn, "__name__", str(fn)))
    return names if every else sorted(set(names))


# (kernel, device kernel it must launch, call): the tensor-core conv behind
# K1, K1-dx and K6 in bf16, the tensor-core GEMM behind K2, K7 and K4 in
# bf16, the FMA conv tile behind K1, K1-dx and K6 in fp32, the voxel-row
# FMA tile behind K2, K7 and K4 in fp32 (gemm_fma_kernel<BN, STATS, EPI,
# D2S>: K2 STATS alone, K7 neither STATS nor D2S, K4 D2S alone)
MMA, GMMA = "conv_mma_kernel", "gemm_mma_kernel"
K5 = "stats_sums_kernel"          # K5a, K5b and masked K5b, both dtypes
CFMA, GFMA = "conv_fma_kernel", "gemm_fma_kernel"
GFMA_K2 = GFMA + "<{}, true, false, false>"
GFMA_K7 = GFMA + "<{}, false, {}, false>"
GFMA_K4 = GFMA + "<{}, false, {}, true>"


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
            ("pointwise_conv_f32", GFMA_K7.format(16, "true"),
             conv3d.pointwise_conv, (xf, w2f, bias[:16], True)),
            ("pointwise_conv_f32", GFMA_K7.format(16, "false"),
             conv3d.pointwise_conv, (xf, w2f, None, False)),
            ("conv_transpose2x_f32", GFMA_K4.format(128, "false"),
             conv3d.conv_transpose2x, (xf, w4.float(), False)),
            ("conv_transpose2x_f32", GFMA_K4.format(128, "true"),
             conv3d.conv_transpose2x, (xf, w4.float(), True)),
            ("conv3x3x3_bf16", MMA, pgemm.conv3x3x3, (x, w, 1)),
            ("conv3d_bf16", MMA, conv3d.conv3d, (x, w, None, 1, 1, False)),
            ("conv3d_bf16", MMA, conv3d.conv3d, (x, w, bias, 2, 2, True)),
            ("conv3x3x3_stats_bf16", MMA, pgemm.conv3x3x3_stats, (x, w, 1)),
            ("gemm_stats_bf16", GMMA, pgemm.gemm_stats, (x3, w2)),
            ("conv3x3x3_stats_f32", CFMA, pgemm.conv3x3x3_stats,
             (xf, wf, 1)),
            ("gemm_stats_f32", GFMA_K2.format(16), pgemm.gemm_stats,
             (x3f, w2f)),
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
    `ops/gemm_fma.py` at the same geometries: {geometry: (library,
    mirror)} where they differ."""
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
        out = (ctypes.c_int * 5)()
        if lib.gemm_fma_plan(*g, out):
            raise AssertionError(f"gemm_fma_plan refused {g}")
        p = gemm_fma.plan(g[0], g[1], bool(g[2]), bool(g[3]))
        mirror = [p.bn, p.rows, p.nchunks, p.stages, p.smem]
        if list(out) != mirror:
            bad[str(("gemm_fma", *g))] = (list(out), mirror)
    return bad


def phase_sass(dev, gen, functions):
    """The bf16 convs (K1, K1-dx, K6) and GEMMs (K2, K7, K4) on the tensor
    cores: the kernels their wrappers launch are conv_mma_kernel or
    gemm_mma_kernel instantiations, each with HMMA in its SASS; the fp32
    convs on the FMA conv tile: they launch conv_fma_kernel, every
    instantiation of which has FFMA and no HMMA; K2, K7 and K4 in fp32 on
    the voxel-row FMA tile: they launch the gemm_fma_kernel instantiation
    of their flags (K4: D2S), every instantiation of which has FFMA and no
    HMMA; each call launches one such kernel.  And the kernels' plans are
    the ones `ops/conv_mma.py`, `ops/conv_fma.py`, `ops/gemm_mma.py` and
    `ops/gemm_fma.py` mirror; K5 launches one `stats_sums_kernel` a call,
    and refuses a plan other than `ops/stats.py`'s."""
    hmma = {kind: {fn: n for fn, n, _ in functions if kind in fn}
            for kind in (MMA, GMMA, CFMA, GFMA)}
    ffma = {kind: {fn: n for fn, _, n in functions if kind in fn}
            for kind in (CFMA, GFMA)}
    ok = all(hmma[MMA].values()) and all(hmma[GMMA].values()) \
        and bool(hmma[MMA]) and bool(hmma[GMMA]) \
        and all(bool(f) and all(f.values()) for f in ffma.values()) \
        and not any(hmma[CFMA].values()) and not any(hmma[GFMA].values())
    launched = {}
    with torch.no_grad():
        for name, want, fn, args in _sass_calls(dev, gen):
            names = kernels_launched(fn, *args, every=True)
            launched.setdefault(name, []).extend(names)
            mains = [n for n in names if any(k in n for k in hmma)]
            ok = ok and len(mains) == 1 and want in mains[0]
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
          "gemm_fma_ffma": ffma[GFMA],
          "launched": launched, "plans_differ": plans_differ,
          "k5_launched": [re.search(r"\w+_kernel<[^>]*>", n).group(0)
                          if K5 in n else n for n in k5],
          "k5_wrong_plans_accepted": k5_wrong_plans,
          "trace_retakes": TRACE_RETAKES,
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
                             "FMA conv tile, K2/K7/K4 fp32 not on their "
                             "FMA GEMM tile instantiations, or an FMA "
                             "kernel has HMMA")
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
    # one rank of phase "dp" (the script starts them itself)
    for name in ("--dp-rank", "--dp-dir", "--dp-store", "--dp-ckpt",
                 "--dp-device"):
        ap.add_argument(name, default=None, help=argparse.SUPPRESS)
    # one rank of phase "spatial"
    for name in ("--sp-rank", "--sp-dir", "--sp-device"):
        ap.add_argument(name, default=None, help=argparse.SUPPRESS)
    # phase "train"'s traced step, in a process of its own
    for name in ("--trace-dir", "--trace-device"):
        ap.add_argument(name, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_script = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    if args.dp_rank is not None:
        return dp_rank_main(args)
    if args.sp_rank is not None:
        return spatial_rank_main(args)
    if args.trace_dir is not None:
        return trace_step_main(args)
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

    # the C++ host path (data/native/), built from its source here too
    from nas_3d_unet_tpu_torch.data.native import _native

    _native.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    if not _native.available():
        raise AssertionError(f"the native preprocessing library does not "
                             f"build: {_native.build_error()}")
    emit({"phase": "build_native", "seconds": time.perf_counter() - t0,
          "library": str(_native.library_path()),
          "flags": " ".join(_native.FLAGS)})

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    summary = Summary()
    with strict_fp32():          # the twins and the plain convs: no TF32
        phase_kernels(dev, gen, summary)
        serve_launches, s_per_patient = phase_slice(dev, args.seed)
        phase_train_kernels(dev, gen, summary)
        train_launches, train = phase_train(dev, args.seed)
        train_n = phase_train_n(dev, args.seed)
        with tempfile.TemporaryDirectory() as cli_tmp:
            cli = phase_cli(dev, args.seed, s_per_patient, train, cli_tmp)
            search_kernels_s = phase_search_kernels(dev, gen, Summary())
            search = phase_search(dev, args.seed)
            unrolled, unrolled_s = phase_search_unrolled(dev, gen, args.seed)
            unrolled_p, unrolled_p_s = phase_search_unrolled_pallas(
                dev, gen, args.seed)
            pc, both, pc_s = phase_search_pc(dev, gen, args.seed)
            remat, remat_s = phase_remat(dev, args.seed)
            # phase "quality"'s commands run in child processes beside
            # phases "dp" and "spatial" (their s a step share the card)
            q = quality_start(dev, args.seed, cli_tmp)
            try:
                dp = phase_dp(dev, args.seed, cli_tmp)
                sp = phase_spatial(dev, args.seed, cli_tmp)
            except BaseException:
                quality_stop(q["children"])
                raise
            quality = quality_finish(q)
        phase_pallas_kernels(dev, gen, summary)
        p_serve_launches, p_s_per_patient = phase_slice(dev, args.seed, True)
        p_train_launches, p_train = phase_train(dev, args.seed, True)
        functions = sass_functions(so)
        probe_launches = phase_probes(dev, args.seed, summary, functions)
        phase_sass(dev, gen, functions)

    emit({"phase": "done", "s_per_patient": s_per_patient,
          "train_patches_per_s": train["patches_per_s"],
          "train_peak_mem_gb": train["peak_mem_gb"],
          **{f"train_n_{k}": train_n[k] for k in (
              "eager_step_s", "graph_step_s", "eager_peak_gb",
              "graph_peak_gb", "seconds")},
          "pallas_s_per_patient": p_s_per_patient,
          "pallas_train_patches_per_s": p_train["patches_per_s"],
          "pallas_train_peak_mem_gb": p_train["peak_mem_gb"],
          "cli_s_per_patient": cli["s_per_patient"],
          "cli_patches_per_sec": cli["patches_per_sec"],
          "cli_seconds": cli["seconds"],
          "search_step_s": search["step_s"],
          "search_patches_per_s": search["patches_per_s"],
          "search_peak_mem_gb": search["peak_mem_gb"],
          "search_kernels_s": search_kernels_s,
          "search_s": search["seconds"],
          "search_launches_per_step": search["launches_per_bilevel_step"],
          **{f"{name}_{key}": rec[key] for name, rec in (
              ("search_unrolled", unrolled),
              ("search_unrolled_pallas", unrolled_p), ("search_pc", pc),
              ("search_pc_unrolled", both))
             for key in ("step_s", "patches_per_s", "peak_mem_gb",
                         "launches_per_step")},
          "search_unrolled_s": unrolled_s,
          "search_unrolled_pallas_s": unrolled_p_s, "search_pc_s": pc_s,
          **{f"remat_{kind}_{name}_{key}": r[key]
             for kind, rec in remat.items()
             for name, r in rec.items()
             if isinstance(r, dict) and "step_s" in r
             for key in ("step_s", "peak_mem_gb")},
          "remat_s": remat_s, "dp_s": dp["seconds"],
          "dp_step_s": dp["step_s"], "dp_world": dp["world"],
          "dp_backend": dp["backend"], "spatial_s": sp["seconds"],
          "spatial_step_s": sp["steps"]["step_s"],
          "spatial_second_order_s": sp["grads_second"]["first_call_s"],
          "quality_s": quality["seconds"],
          "quality_wt": {t: quality[f"{t}_dice"]["WT"]
                         for t in ("learn", "shift")},
          "quality_conv_mass": {t: quality[f"{t}_search"]["conv_mass"]
                                for t in ("shift", "noise")},
          "remat_repeats": {k: r["repeats"] for k, r in remat.items()},
          "script_s": time.perf_counter() - t_script,
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
