#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nas_3d_unet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line:
  1. device: CUDA must be present (else exit 2); the card's name and power
     limit from nvidia-smi.
  2. build: compiles nas_3d_unet_tpu_torch/csrc/*.cu from scratch (nvcc,
     sm_90a) and times it.
  3. kernels: K1 conv3x3x3_stats and K2 gemm_stats against their plain
     PyTorch twins at every geometry the flagship net gives them (batch 2),
     plus a dilation-2 K1 case; max abs/rel differences beside the limits,
     and kernel and twin times from CUDA events.
  4. slice: the flagship derived net (default_genotype(3), base 16, depth
     3, fp32, random weights from --seed through the flax bridge) serves
     synthetic 160x192x152x4 patients through SlidingWindowPredictor +
     predict_records (128^3 windows, overlap 0.5, patch batch 2).  Checks:
     labels uint8 in {0,1,2,4}, finite Dice, K1/K2 launch counts equal to
     (launches per forward) x (forwards), one patch's logits against the
     same net forced onto the twins, and that the shapes the net hands the
     kernels are exactly phase 3's geometries.
Then the nvidia-smi line, the kernels summary line (`ms` / `plain_ms`: one
flagship forward's worth at batch 2, the sum over geometries of launches
per forward x time per launch), and as the last line
`{"ok": true, "device": {...}}`.  Any failed check raises: the script never
exits 0 after a failure.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SRC = "nas_3d_unet_tpu_torch/csrc/pgemm.cu"
K1_REPLACES = "nas_3d_unet_tpu/ops/pallas/pgemm.py:174"   # conv_pgemm
K2_REPLACES = "nas_3d_unet_tpu/ops/pallas/pgemm.py:311"   # gemm_stats

# (Cin, Cout, volume edge, dilation, launches per flagship forward)
K1_GEOMS = [(4, 48, 128, 1, 1),      # stem
            (32, 32, 64, 1, 5),      # down cell 1 (2), up cell level 1 (3)
            (64, 64, 32, 1, 5),      # down cell 2 (2), up cell level 2 (3)
            (128, 128, 16, 1, 2),    # down cell 3
            (16, 16, 128, 1, 3),     # up cell level 0
            (32, 32, 64, 2, 0)]      # dil_conv3: off the flagship path
# (K, N, volume edge, launches per flagship forward)
K2_GEOMS = [(48, 32, 128, 2),        # down cell 1: both inputs (the stem)
            (96, 64, 64, 1),         # down cell 2: s1
            (192, 128, 32, 1),       # down cell 3: s1
            (192, 64, 32, 1), (384, 64, 16, 1),    # up cell level 2
            (96, 32, 64, 1), (192, 32, 32, 1),     # up cell level 1
            (48, 16, 128, 1), (96, 16, 64, 1)]     # up cell level 0
BATCH = 2
Y_RTOL = Y_ATOL = 1e-4       # y: |k - t| <= atol + rtol·|t|
S2_RTOL = 1e-4               # Σy²: relative
S1_COND = 1e-4               # Σy: |k - t| <= 1e-4·Σ|y| (its rounding scale)
LOGIT_ATOL = 1e-3
LABEL_AGREE = 0.999
N_PATIENTS = 3               # timed patients, after one warm-up patient
SHAPE = (160, 192, 152)      # a cropped BraTS volume, as bench.py serves
PATCH, OVERLAP, PATCH_BATCH = (128, 128, 128), 0.5, 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _check_kernel(kernel, twin, args, y_abs_sum):
    """Kernel vs twin on the same inputs; returns the phase-3 record.  The
    kernel runs twice: its outputs, moments included, must be the same bits
    (no atomics, fixed reduction order)."""
    yk, s1k, s2k = kernel(*args)
    again = kernel(*args)
    yt, s1t, s2t = twin(*args)
    torch.cuda.synchronize()
    dy = (yk - yt).abs()
    rec = {
        "bitwise_repeatable": all(torch.equal(a, b) for a, b in
                                  zip((yk, s1k, s2k), again)),
        "y_max_abs": dy.max().item(),
        "y_max_rel": (dy / yt.abs().clamp_min(1e-30)).max().item(),
        "y_ok": bool((dy <= Y_ATOL + Y_RTOL * yt.abs()).all()),
        "s1_max_abs": (s1k - s1t).abs().max().item(),
        "s1_max_over_scale": ((s1k - s1t).abs()
                              / y_abs_sum(yt)).max().item(),
        "s2_max_rel": ((s2k - s2t).abs() / s2t.abs()).max().item(),
        "limits": {"y_rtol": Y_RTOL, "y_atol": Y_ATOL,
                   "s1_over_sum_abs_y": S1_COND, "s2_rtol": S2_RTOL},
    }
    rec["ok"] = (rec["y_ok"] and rec["s1_max_over_scale"] <= S1_COND
                 and rec["s2_max_rel"] <= S2_RTOL
                 and rec["bitwise_repeatable"])
    return rec


def phase_kernels(dev, gen):
    from nas_3d_unet_tpu_torch.ops import pgemm
    from nas_3d_unet_tpu_torch.utils.timing import cuda_ms

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def conv_scale(y):
        return y.abs().sum((1, 2, 3))

    def gemm_scale(y):
        return y.abs().sum(1)

    summary = {}
    for name, geoms in (("conv3x3x3_stats", K1_GEOMS),
                        ("gemm_stats", K2_GEOMS)):
        kernel = getattr(pgemm, name)
        twin = getattr(pgemm, name + "_twin")
        tot = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
        for g in geoms:
            if name == "conv3x3x3_stats":
                cin, cout, v, dil, per_fwd = g
                args = (randn(BATCH, v, v, v, cin),
                        randn(3, 3, 3, cin, cout,
                              scale=(27 * cin) ** -0.5), dil)
                geom = {"cin": cin, "cout": cout, "volume": v,
                        "dilation": dil}
                scale = conv_scale
            else:
                k, n, v, per_fwd = g
                args = (randn(BATCH, v ** 3, k),
                        randn(k, n, scale=k ** -0.5))
                geom = {"k": k, "n": n, "rows": BATCH * v ** 3}
                scale = gemm_scale
            rec = _check_kernel(kernel, twin, args, scale)
            rec["ms"] = cuda_ms(kernel, *args, iters=5, warmup=1)
            rec["plain_ms"] = cuda_ms(twin, *args, iters=5, warmup=1)
            emit({"phase": "kernel", "kernel": name, **geom, "batch": BATCH,
                  "per_forward": per_fwd, **rec})
            if not rec["ok"]:
                raise AssertionError(f"{name} disagrees with its twin at "
                                     f"{geom}")
            tot["ms"] += per_fwd * rec["ms"]
            tot["plain_ms"] += per_fwd * rec["plain_ms"]
            tot["max_abs_err"] = max(tot["max_abs_err"], rec["y_max_abs"])
            del args
        summary[name] = tot
    return summary


def _kernel_launches_per_forward(net):
    """(K1, K2) launches one forward makes, counted from the modules: every
    stride-1 ConvNormAct runs K1 (3³) or K2 (1³) once."""
    from nas_3d_unet_tpu_torch.ops.primitives import ConvNormAct

    mods = [m for m in net.modules()
            if isinstance(m, ConvNormAct) and m.stride == 1]
    return (sum(m.kernel == 3 for m in mods), sum(m.kernel == 1 for m in mods))


def flagship_predictor(dev, seed):
    """The flagship net on `dev`, random weights from `seed` at flax's
    initialiser scales, bound to the serving window settings."""
    from nas_3d_unet_tpu_torch import bridge
    from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor
    from nas_3d_unet_tpu_torch.models.genotype import default_genotype
    from nas_3d_unet_tpu_torch.models.unet import DerivedNet

    net = DerivedNet(default_genotype(3), in_channels=4, num_classes=3,
                     base_channels=16, depth=3, n_nodes=3, gn_groups=8)
    bridge.load_flax_params(net, bridge.random_flax_params(net, seed))
    return SlidingWindowPredictor(net.to(dev), PATCH, overlap=OVERLAP,
                                  batch_size=PATCH_BATCH, num_classes=3)


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


def phase_slice(dev, seed):
    from nas_3d_unet_tpu_torch.infer.predict import predict_records
    from nas_3d_unet_tpu_torch.infer.sliding import grid_coords
    from nas_3d_unet_tpu_torch.metrics.dice import regions_to_labels
    from nas_3d_unet_tpu_torch.ops import pgemm

    predictor = flagship_predictor(dev, seed)
    net = predictor.model
    t0 = time.perf_counter()
    recs = synthetic_records(dev, seed, N_PATIENTS + 1)   # +1: warm-up
    setup_s = time.perf_counter() - t0

    # one patch through the kernels (noting the shapes the net hands them,
    # which must be the geometries phase 3 checked), then through the
    # twins, same weights
    seen = collections.Counter()
    k1_fn, k2_fn = pgemm.conv3x3x3_stats, pgemm.gemm_stats

    def k1_noted(x, w, dilation=1):
        seen[(x.shape[4], w.shape[4], x.shape[1], dilation)] += 1
        return k1_fn(x, w, dilation)

    def k2_noted(x3, w):
        seen[(x3.shape[2], w.shape[1], round(x3.shape[1] ** (1 / 3)))] += 1
        return k2_fn(x3, w)

    x = recs[0]["image_dev"][:128, :128, :128].unsqueeze(0).contiguous()
    with torch.inference_mode():
        with mock.patch.object(pgemm, "conv3x3x3_stats", k1_noted), \
                mock.patch.object(pgemm, "gemm_stats", k2_noted):
            logits_k = net(x)
        with mock.patch.object(pgemm, "conv3x3x3_stats",
                               pgemm.conv3x3x3_stats_twin), \
                mock.patch.object(pgemm, "gemm_stats", pgemm.gemm_stats_twin):
            logits_t = net(x)
    torch.cuda.synchronize()
    logit_err = (logits_k - logits_t).abs().max().item()
    agree = (regions_to_labels(torch.sigmoid(logits_k))
             == regions_to_labels(torch.sigmoid(logits_t))).float().mean()
    agree = agree.item()
    tables = collections.Counter(
        {g[:4]: g[4] for g in K1_GEOMS if g[4]}) + collections.Counter(
        {g[:3]: g[3] for g in K2_GEOMS})
    emit({"phase": "slice_parity", "logits_max_abs": logit_err,
          "limit": LOGIT_ATOL, "label_agreement": agree,
          "agreement_limit": LABEL_AGREE,
          "geometries_match_phase3": seen == tables})
    if not (logit_err <= LOGIT_ATOL and agree >= LABEL_AGREE):
        raise AssertionError("kernel path disagrees with the twin path")
    if seen != tables:
        raise AssertionError(f"the net's kernel shapes {dict(seen)} are not "
                             f"the geometries checked in phase 3")
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

    pgemm.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = predict_records(predictor, [(r["patient"], r) for r in recs],
                          verbose=False)
    torch.cuda.synchronize()
    s_per_patient = (time.perf_counter() - t0) / len(recs)
    launches = dict(pgemm.LAUNCHES)

    stride = tuple(max(1, int(round(p * (1 - OVERLAP)))) for p in PATCH)
    forwards = len(recs) * math.ceil(len(grid_coords(SHAPE, PATCH, stride))
                                     / PATCH_BATCH)
    k1, k2 = _kernel_launches_per_forward(net)
    expected = {"conv3x3x3_stats": k1 * forwards,
                "gemm_stats": k2 * forwards}
    dice = [r["dice"] for r in out]
    label_sets = [sorted(torch.unique(t).tolist()) for t in labels_seen]
    emit({"phase": "slice", "patients": len(out), "volume": list(SHAPE),
          "s_per_patient": s_per_patient, "warmup_patient_s": warm_s,
          "setup_s": setup_s, "forwards": forwards,
          "launches_per_forward": {"conv3x3x3_stats": k1, "gemm_stats": k2},
          "launches": launches, "expected_launches": expected,
          "dice": dice, "label_values": label_sets,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30})
    if [r["patient"] for r in out] != [r["patient"] for r in recs]:
        raise AssertionError("results out of patient order")
    if (k1, k2) != (16, 10) or launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if len(labels_seen) != len(recs):
        raise AssertionError("a patient's labels were not seen")
    for t in labels_seen:
        if t.dtype != torch.uint8 or tuple(t.shape) != SHAPE \
                or not set(torch.unique(t).tolist()) <= {0, 1, 2, 4}:
            raise AssertionError(f"bad label volume {t.dtype} {t.shape}")
    if not all(math.isfinite(v) for d in dice for v in d.values()):
        raise AssertionError(f"non-finite Dice {dice}")
    return launches, s_per_patient


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
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "sources": [SRC],
          "flags": " ".join(_build.NVCC_FLAGS), "ptxas": ptxas})

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    with strict_fp32():          # the twins and the plain convs: no TF32
        summary = phase_kernels(dev, gen)
        launches, s_per_patient = phase_slice(dev, args.seed)

    emit({"phase": "done", "s_per_patient": s_per_patient,
          "card": smi, "build_s": build_s})
    kernels = []
    for name, replaces in (("conv3x3x3_stats", K1_REPLACES),
                           ("gemm_stats", K2_REPLACES)):
        kernels.append({"name": name, "route": "cuda", "source": SRC,
                        "replaces": replaces, "launches": launches[name],
                        **summary[name]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    loaded = {m.split(".")[0] for m in sys.modules}
    if loaded & {"jax", "flax", "nas_3d_unet_tpu"}:
        raise AssertionError("the JAX stack was imported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
