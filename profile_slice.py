#!/usr/bin/env python3
"""Where one patient's serving time, one train step's or one search
step's time goes, on one NVIDIA GPU.

    python3 profile_slice.py [--train | --search [--unrolled]
                             [--partial-channels K]] [--use-pallas]
                             [--remat {off,cells,cells_edges}]

Serving: one synthetic 160x192x152x4 patient with the flagship net (the
settings of `chip_smoke.py`) under `torch.profiler`, after one warm-up
patient and three timed unprofiled ones.  --train: one train step of the
bf16 flagship at 128^3, batch 2, microbatch 1 (chip_smoke.py's phase
"train"), after three warm-up and three timed unprofiled steps.
--search: one bilevel step (an α-step, then a w-step) of the shipped
supernet at 128^3, batch 1 (chip_smoke.py's phase "search"), after two
warm-up and three timed unprofiled steps; with --unrolled the
second-order step (phase "search_unrolled"), after one warm-up and two
timed ones; with --partial-channels K the supernet with pc_k K (phase
"search_pc").  --use-pallas: serving or
training with `DerivedNet(use_pallas=True)` (chip_smoke.py's phases
"pallas_slice" and "pallas_train").  --remat, with --train or --search:
activation checkpointing on the cells (`model.remat`), or on the cells
and the supernet's edges (`model.remat_edges`), as chip_smoke.py's phase
"remat" sets it; the recomputed forwards run inside the backward.  Every
device activity (kernel, memcpy, memset) is attributed to the innermost op
module whose forward launched it (forward hooks open a `record_function`
range per module; a kernel belongs to the range around its launch call;
the backward, launched by autograd after the forward ranges closed, falls
outside them), and classed by its kernel name.  Prints one JSON object:

  wall_s_unprofiled   host seconds per patient (per step), three runs
  window_ms           the profiled patient (step), host range around it
  device_sum_ms       sum of device activity durations
  device_busy_ms      union of device activity intervals in the window
  idle_share          1 - device_busy_ms / window_ms
  overlapped_ms_by_class, by_stream_ms   why device_sum_ms > device_busy_ms
  by_module_ms, by_module_and_class_ms, by_class_ms, top_kernels_ms
  peak_mem_gb         peak device memory allocated over the runs

Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

CLASSES = [   # (class, kernel-name pattern), first match wins
    # conv_mma_kernel<BN, STATS> (csrc/conv_mma.cuh): the bf16 3³ convs on
    # the tensor cores, K1 with its moments, K1-dx and K6 without (only
    # the default path runs K1-dx and only use_pallas K6);
    # gemm_mma_kernel<BN, STATS, EPI, D2S> (csrc/gemm_mma.cuh): K2 in bf16
    # (STATS), K7 (EPI) and K4 (EPI, D2S)
    ("K1 bf16 conv3x3x3_stats (tensor cores)",
     r"conv_mma_kernel<\d+, true"),
    ("K1-dx / K6 bf16 conv (tensor cores)", r"conv_mma_kernel<"),
    ("K2 bf16 gemm_stats (tensor cores)", r"gemm_mma_kernel<\d+, true"),
    ("K4 bf16 conv_transpose2x (tensor cores)",
     r"gemm_mma_kernel<\d+, false, true, true"),
    ("K7 bf16 pointwise_conv (tensor cores)", r"gemm_mma_kernel<"),
    # conv_fma_kernel<BN, S, DIL, STATS> (csrc/conv_fma.cuh): the fp32 3³
    # convs on the FMA units, K1 with its moments, K1-dx and K6 at stride
    # 1 without (one kernel: one class), K6 at stride 2
    ("K1 fp32 conv3x3x3_stats (FMA conv tile)",
     r"conv_fma_kernel<\d+, 1, \d, true"),
    ("K1-dx / K6 stride-1 fp32 conv (FMA conv tile)",
     r"conv_fma_kernel<\d+, 1,"),
    ("K6 stride-2 fp32 conv3d (FMA conv tile)", r"conv_fma_kernel<\d+, 2,"),
    # gemm_fma_kernel<BN, STATS, EPI, D2S> (csrc/gemm_fma.cuh): the fp32
    # voxel-row GEMMs on the FMA units, K2 with its moments (STATS), K4
    # with its depth-to-space store (D2S), K7 with neither
    ("K2 fp32 gemm_stats (FMA GEMM tile)", r"gemm_fma_kernel<\d+, true"),
    ("K4 fp32 conv_transpose2x (FMA GEMM tile)",
     r"gemm_fma_kernel<\d+, false, \w+, true>"),
    ("K7 fp32 pointwise_conv (FMA GEMM tile)", r"gemm_fma_kernel<"),
    ("K1/K2 moments reduce", r"moments_reduce_kernel"),
    ("K3 apply", r"apply_kernel<"),
    ("K3 dx", r"dx_kernel<"),
    # stats_sums_kernel<T, WEIGHTED, MASKED, VEC> (csrc/stats.cu): K5a,
    # K5b and masked K5b, one launch a call (its cross-block sum inside)
    ("K5b masked (K3 backward sums)",
     r"stats_sums_kernel<[\w:]+, true, true"),
    ("K5b weighted_sums", r"stats_sums_kernel<[\w:]+, true"),
    ("K5a moments", r"stats_sums_kernel<[\w:]+, false"),
    ("AdamW (foreach)", r"multi_tensor_apply"),
    ("cuDNN layout transform", r"nhwcToNchw|nchwToNhwc"),
    ("cuDNN conv", r"conv|xmma_fprop|cudnn"),
    ("cuBLAS gemm", r"gemm"),
    ("reduction", r"reduce_kernel"),
    ("elementwise", r"elementwise|Fill|copy|cat|index"),
]
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
OUTSIDE = ("outside the forward (serving: pad, patch stack, sigmoid, "
           "stitch, decode; training: augment, loss, backward, AdamW)")


def kernel_class(name: str, cat: str) -> str:
    if cat != "kernel":
        return cat
    for cls, pat in CLASSES:
        if re.search(pat, name):
            return cls
    return "other"


def module_tag(m) -> str | None:
    from nas_3d_unet_tpu_torch.models.unet import DerivedNet, SuperNet
    from nas_3d_unet_tpu_torch.ops.primitives import (ConvNormAct, Pool,
                                                      SepConv, UpSampleConv,
                                                      UpTranspose)
    if isinstance(m, ConvNormAct):
        return (f"ConvNormAct k{m.kernel} s{m.stride}"
                + (" d2" if m.dilation == 2 else ""))
    if isinstance(m, SepConv):
        return f"SepConv s{m.stride}"
    if isinstance(m, UpTranspose):
        return "UpTranspose"
    if isinstance(m, Pool):
        return f"Pool {m.kind} s{m.stride}"
    if isinstance(m, UpSampleConv):
        return "UpSampleConv (the upsample)"
    if isinstance(m, DerivedNet):
        return "DerivedNet (node sums, head)"
    if isinstance(m, SuperNet):
        return "SuperNet (edge terms, node sums, head)"
    return None


def annotate_modules(net) -> None:
    """Open a record_function range named `mod:<tag>` around each tagged
    module's forward."""
    open_ranges = []

    def enter(name):
        def hook(mod, args):
            rf = record_function("mod:" + name)
            rf.__enter__()
            open_ranges.append(rf)
        return hook

    def leave(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    for m in net.modules():
        tag = module_tag(m)
        if tag:
            m.register_forward_pre_hook(enter(tag))
            m.register_forward_hook(leave)


def union_ms(intervals, lo, hi) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy / 1e3


def attribute(trace, window_name: str) -> dict:
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    window = [e for e in evs if e.get("cat") == "user_annotation"
              and e["name"] == window_name]
    if len(window) != 1:
        raise AssertionError(f"{len(window)} {window_name!r} ranges in the "
                             "trace")
    lo, hi = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][4:])
                    for e in evs if e.get("cat") == "user_annotation"
                    and e["name"].startswith("mod:"))
    starts = [r[0] for r in ranges]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in evs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}

    def owner(ts):
        # ranges nest, so the innermost one holding ts starts last
        for s, e, tag in reversed(ranges[:bisect.bisect_right(starts, ts)]):
            if e >= ts:
                return tag
        return OUTSIDE

    dev = [e for e in evs if e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    if not any(e["cat"] == "kernel" for e in dev):
        raise AssertionError("no kernel ran on the device in the window")
    by_mod, by_both, by_cls = (collections.Counter() for _ in range(3))
    top, unlinked = collections.Counter(), 0
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        if corr in launch_ts:
            tag = owner(launch_ts[corr])
        else:
            tag, unlinked = "unlinked", unlinked + 1
        cls = kernel_class(e["name"], e["cat"])
        ms = e["dur"] / 1e3
        by_mod[tag] += ms
        by_both[f"{tag} | {cls}"] += ms
        by_cls[cls] += ms
        top[e["name"][:90]] += ms
    # where the sum exceeds the union: time an activity shares with the
    # ones that started before it, by its class, and each stream's share
    overlap, by_stream, end = collections.Counter(), collections.Counter(), lo
    for e in sorted(dev, key=lambda e: e["ts"]):
        shared = min(end, e["ts"] + e["dur"]) - e["ts"]
        if shared > 0:
            overlap[kernel_class(e["name"], e["cat"])] += shared / 1e3
        end = max(end, e["ts"] + e["dur"])
        by_stream[f"stream {e.get('tid')}"] += e["dur"] / 1e3
    busy = union_ms([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    return {"window_ms": (hi - lo) / 1e3,
            "device_sum_ms": sum(e["dur"] for e in dev) / 1e3,
            "device_busy_ms": busy,
            "idle_share": 1 - busy / ((hi - lo) / 1e3),
            "device_events": len(dev), "unlinked_events": unlinked,
            "overlapped_ms_by_class": dict(overlap.most_common()),
            "by_stream_ms": dict(by_stream.most_common()),
            "by_module_ms": dict(by_mod.most_common()),
            "by_module_and_class_ms": dict(by_both.most_common()),
            "by_class_ms": dict(by_cls.most_common()),
            "top_kernels_ms": dict(top.most_common(15))}


def _serving(dev, use_pallas):
    """(walls, profiled callable) for one patient."""
    from chip_smoke import flagship_predictor, synthetic_records

    predictor = flagship_predictor(dev, 0, use_pallas)
    annotate_modules(predictor.model)
    recs = synthetic_records(dev, seed=0, n=5)
    walls = []
    for rec in recs[:4]:                         # warm-up, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict_labels(rec["image_dev"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, lambda: predictor.predict_labels(recs[4]["image_dev"])


def _training(dev, use_pallas, remat="off"):
    """(walls, profiled callable) for one train step."""
    from chip_smoke import (AUGMENT, MICRO, REMAT_SETTINGS, _set_remat,
                            flagship_net, synthetic_batch)
    from nas_3d_unet_tpu_torch.train.loop import make_train_step
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer

    net = flagship_net(0, "bfloat16", use_pallas).to(dev)
    _set_remat(net, *REMAT_SETTINGS[remat])
    annotate_modules(net)
    x, y = synthetic_batch(dev, 0)
    opt = make_optimizer(net.parameters(), 3e-4, 1e-4)
    step = make_train_step(net, opt, augment=AUGMENT, microbatch=MICRO)
    walls = []
    for _ in range(6):                           # three warm-up, three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls[2:], lambda: step(x, y)


def _search(dev, use_pallas, unrolled=False, pc_k=1, remat="off"):
    """(walls, profiled callable) for one bilevel search step (`unrolled`:
    the second-order one; `pc_k`: partial channels)."""
    from chip_smoke import (AUGMENT, REMAT_SETTINGS, _set_remat,
                            search_inputs)
    from nas_3d_unet_tpu_torch.search.bilevel import (
        make_search_step, make_search_step_unrolled)
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer

    if use_pallas:
        raise SystemExit("--search profiles the shipped (default) path")
    net, alphas, batches, cfg = search_inputs(dev, 0, pc_k)
    _set_remat(net, *REMAT_SETTINGS[remat])
    annotate_modules(net)
    sc = cfg.search
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    opts = (make_optimizer(net.parameters(), sc.w_lr, sc.w_weight_decay),
            make_optimizer(alphas.values(), sc.alpha_lr,
                           sc.alpha_weight_decay))
    if unrolled:
        step = make_search_step_unrolled(net, *opts, alphas,
                                         sc.xi or sc.w_lr, AUGMENT, gen=gen)
    else:
        step = make_search_step(net, *opts, alphas, AUGMENT, gen=gen)
    walls = []
    for _ in range(4 if unrolled else 5):        # warm-up, then timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*batches)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls[1:], lambda: step(*batches)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--train", action="store_true",
                      help="profile one train step instead of one patient")
    kind.add_argument("--search", action="store_true",
                      help="profile one bilevel search step")
    ap.add_argument("--use-pallas", action="store_true",
                    help="the use_pallas configuration (K6/K7/K4, K3)")
    ap.add_argument("--unrolled", action="store_true",
                    help="with --search: the second-order step")
    ap.add_argument("--partial-channels", type=int, default=1,
                    help="with --search: PC-DARTS with this pc_k")
    ap.add_argument("--remat", default="off",
                    choices=("off", "cells", "cells_edges"),
                    help="with --train or --search: activation "
                         "checkpointing on the cells (and edges)")
    args = ap.parse_args()
    if args.remat != "off" and not (args.train or args.search):
        ap.error("--remat needs --train or --search")
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nas_3d_unet_tpu_torch.utils.precision import strict_fp32

    dev = torch.device("cuda", 0)
    window = "step" if args.train or args.search else "patient"
    torch.zeros((), device=dev)                  # the allocator, for the
    torch.cuda.reset_peak_memory_stats(dev)      # peak over the runs
    with strict_fp32():
        if args.search:
            walls, run = _search(dev, args.use_pallas, args.unrolled,
                                 args.partial_channels, args.remat)
        elif args.train:
            walls, run = _training(dev, args.use_pallas, args.remat)
        else:
            walls, run = _serving(dev, args.use_pallas)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(window):
                run()
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"card": smi, "window": window, "use_pallas": args.use_pallas,
           "search": args.search, "unrolled": args.unrolled,
           "partial_channels": args.partial_channels, "remat": args.remat,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "wall_s_unprofiled": walls[1:],
           **attribute(trace, window)}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
