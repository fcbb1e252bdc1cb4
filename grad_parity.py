#!/usr/bin/env python3
"""Readings behind `chip_smoke.py`'s gradient limits, on one NVIDIA GPU.

    python3 grad_parity.py [--seeds 0 1 2 3] [--use-pallas | --search |
                            --remat-repeats | --repeats]

For each seed: the bf16 flagship at 128^3, batch 2, microbatch 1 (weights
and batch from the seed, as chip_smoke.py's phase "train" makes them), one
step's gradients on the kernel path against the twin path, leaf by leaf
(`chip_smoke.grad_parity`).  Then the same with a fault planted in K1's
backward, on the first seed:
  dx_no_flip      K1-dx run with the kernel transposed but not flipped;
  dx_drop_a_tap   K1-dx with one of the 27 taps of the flipped kernel
                  zeroed.
--use-pallas: the `use_pallas` configuration (chip_smoke.py's phase
"pallas_train"), whose backward runs K3's dx on every GroupNorm; the
faults are planted there instead:
  gn_dx_drop_c    K3 dx without its constant term C (the group means'
                  share of the gradient);
  gn_dx_no_mask   K3 dx with the cotangent not masked by the fused ReLU.
--search: the search's α gradients, behind chip_smoke.py's α limits.  For
the shipped supernet (phase "search": bf16, batch 1 of 128^3) and for it
with partial channels (pc_k 2, phase "search_pc"), and each seed: one
first-order search step's α (and w) gradients, kernel path against twin
path, then the second-order step's α gradient (phases
"search_unrolled", "search_pc").  Then, on the first seed, with a fault
planted on the kernel path:
  alpha_lost_term   (first-order) one (edge, op) term of the α gradient
                    lost: the gradient of softmax(α)[group][row, op]
                    zeroed in every cell of the group, for one entry of
                    each group (`LOST_TERMS`: a conv op of node 0's first
                    edge);
  alpha_bf16_sum    (both) every edge term's Σ g·y summed with each
                    partial sum rounded to bf16 (rows of 64 added one
                    after another, level by level), where the port sums
                    in fp32;
  gn_stats_constant (second-order) the GroupNorm backward's mean and inv
                    held constant where its dx is differentiated;
  k1dx_raw          (second-order) K1's backward launching K1-dx outside
                    its Function, which autograd then cannot see.
The second-order step runs at chip_smoke.py's PARITY_XI.
--remat-repeats: whether a step repeats its own bits, behind chip_smoke.py's
phase "remat" (cuDNN deterministic, the shipped supernet, the first seed):
the first-order step, then the second-order step (ξ = search.w_lr, as the
phase), with remat off, on the cells and on the cells and edges in
REMAT_SEQUENCE's order; "_early": with PyTorch's early stop, which
`models/cell.py` `checkpointed` turns off.  Per run its seconds, the
digests of the α and w gradients and how many w leaves differ from the
step's first run.
Prints one JSON line per run: the largest per-leaf relative L2 distance,
the smallest cosine, the largest relative difference of the norms, and
whether chip_smoke.py's limits pass it.
--repeats: whether the first-order and second-order steps repeat their
bits (cuDNN deterministic, the shipped supernet, the first seed), with the
upsample as `F.interpolate` and as the port's stencil: the ops
`torch.use_deterministic_algorithms` names, and chip_smoke.py's
REPEAT_RUNS runs' digests and seconds.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
from unittest import mock

import torch


def _no_flip(w):
    return w.transpose(3, 4).contiguous()


def _drop_a_tap(w):
    ft = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    ft[2, 2, 2] = 0
    return ft


def _k3_fault(drop_c):
    """K3's dx with one planted fault."""
    from nas_3d_unet_tpu_torch.ops import groupnorm

    dx = groupnorm.group_norm_dx

    def faulty(g, x, y, a, b, c):
        if drop_c:
            return dx(g, x, y, a, b, torch.zeros_like(c))
        return dx(g, x, None, a, b, c)

    return mock.patch.object(groupnorm, "group_norm_dx", faulty)


def _lost_term(group="down_in", row=0, op=2):
    """softmax(α)[group][row, op]'s gradient zeroed: that (edge, op) term
    lost from the α gradient."""
    from nas_3d_unet_tpu_torch.search import bilevel

    aw = bilevel.arch_weights_from_alphas

    def faulty(alphas):
        out = aw(alphas)
        if out[group].requires_grad:
            keep = torch.ones_like(out[group])
            keep[row, op] = 0
            out[group].register_hook(lambda g: g * keep)
        return out

    return mock.patch.object(bilevel, "arch_weights_from_alphas", faulty)


def _bf16_sum(t):
    """Σt with every partial sum rounded to bf16: rows of 64 added one
    after another, level by level."""
    t = t.flatten().bfloat16()
    while t.numel() > 1:
        t = torch.nn.functional.pad(t, (0, -t.numel() % 64)).view(64, -1)
        acc = t[0]
        for r in t[1:]:
            acc = acc + r
        t = acc
    return t.reshape(())


class _Bf16SumWeighted(torch.autograd.Function):
    """An edge term w·y whose weight gradient sums g·y in bf16."""

    @staticmethod
    def forward(ctx, w, y):
        ctx.save_for_backward(w, y)
        return w.to(y.dtype) * y

    @staticmethod
    def backward(ctx, g):
        w, y = ctx.saved_tensors
        dw = _bf16_sum(g * y).to(w.dtype) if ctx.needs_input_grad[0] \
            else None
        return dw, g * w.to(y.dtype)


def _bf16_sum_fault():
    from nas_3d_unet_tpu_torch.models import cell

    return mock.patch.object(cell, "_weighted", _Bf16SumWeighted.apply)


def _gn_stats_constant():
    """The GroupNorm backward's mean and inv held constant where dx is to
    be differentiated: the second-order path through them cut."""
    from nas_3d_unet_tpu_torch.ops import groupnorm

    stats = groupnorm._grad_statistics
    return mock.patch.object(groupnorm, "_grad_statistics", lambda *a: tuple(
        t.detach() for t in stats(*a)))


def _k1dx_raw():
    """K1's backward launching K1-dx raw where its dx is to be
    differentiated: the second-order path through K1-dx cut, as a launch
    outside its Function is on the card."""
    from nas_3d_unet_tpu_torch.ops import pgemm

    class Raw:
        @staticmethod
        def apply(dy, w, dilation):
            return pgemm._k1(dy, w, dilation, False)

    return mock.patch.object(pgemm, "_Conv3x3x3", Raw)


LOST_TERMS = [("down_in", 0, 2), ("down_mid", 0, 2), ("up_skip", 0, 2),
              ("up_below", 0, 0), ("up_mid", 0, 2)]
FIRST_ORDER_FAULTS = [(f"alpha_lost_term {g}[{r}, {o}]",
                       functools.partial(_lost_term, g, r, o))
                      for g, r, o in LOST_TERMS]
FIRST_ORDER_FAULTS.append(("alpha_bf16_sum", _bf16_sum_fault))
UNROLLED_FAULTS = [("gn_stats_constant", _gn_stats_constant),
                   ("k1dx_raw", _k1dx_raw),
                   ("alpha_bf16_sum", _bf16_sum_fault)]


def search_main(seeds, smi, dev) -> None:
    """--search: the α readings behind chip_smoke.py's α limits, for the
    shipped supernet and its partial-channel (pc_k 2) twin."""
    from chip_smoke import (ALPHA_LIMITS, PC_ALPHA_LIMITS, search_grad_parity,
                            search_inputs, unrolled_parity)

    nothing = [("none", contextlib.nullcontext)]
    for pc_k in (1, 2):
        limits = PC_ALPHA_LIMITS if pc_k > 1 else ALPHA_LIMITS
        runs = [(s, "first_order", nothing) for s in seeds]
        runs += [(s, "unrolled", nothing) for s in seeds]
        runs += [(seeds[0], "first_order", FIRST_ORDER_FAULTS),
                 (seeds[0], "unrolled", UNROLLED_FAULTS)]
        for seed, step, faults in runs:
            net, alphas, batches, _ = search_inputs(dev, seed, pc_k)
            for fault, ctx in faults:
                rec = (search_grad_parity(net, alphas, batches, ctx(), limits)
                       if step == "first_order"
                       else unrolled_parity(net, alphas, batches, ctx()))
                print(json.dumps({"seed": seed, "pc_k": pc_k, "fault": fault,
                                  "step": step, "card": smi, **rec}),
                      flush=True)
            del net, alphas, batches


REMAT_SEQUENCE = {"first": ("off", "off", "cells", "cells_early", "cells",
                            "cells_early", "off", "cells_edges",
                            "cells_edges_early", "cells", "cells_early",
                            "off"),
                  "second": ("off", "cells", "cells_early", "off")}


def remat_repeats_main(seed, smi, dev) -> None:
    """--remat-repeats: each run's gradient digests, in REMAT_SEQUENCE's
    order, in one process."""
    import time

    from chip_smoke import (REMAT_SETTINGS, _digest, _remat_grads,
                            _set_remat, search_inputs)
    from nas_3d_unet_tpu_torch.models import cell

    def early_stop_kept(enable):
        return contextlib.nullcontext()

    torch.backends.cudnn.deterministic = True
    net, alphas, batches, cfg = search_inputs(dev, seed)
    names = [n for n, _ in net.named_parameters()]
    for kind, settings in REMAT_SEQUENCE.items():
        first = None
        for setting in settings:
            _set_remat(net, *REMAT_SETTINGS[setting.split("_early")[0]])
            early = (mock.patch.object(cell, "set_checkpoint_early_stop",
                                       early_stop_kept)
                     if setting.endswith("_early")
                     else contextlib.nullcontext())
            t0 = time.perf_counter()
            with early:
                _, ga, gw = _remat_grads(kind, net, alphas, batches,
                                         cfg.search.w_lr)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            _set_remat(net, False, False)
            net.zero_grad(set_to_none=True)
            gw = [g.cpu() for g in gw]
            first = first or gw
            differ = [n for n, a, b in zip(names, gw, first)
                      if not torch.equal(a, b)]
            print(json.dumps({"step": kind, "remat": setting, "seed": seed,
                              "s": secs, "alpha_digest": _digest(ga)[:16],
                              "w_digest": _digest(gw)[:16],
                              "w_leaves_differing_from_first": len(differ),
                              "of": len(names), "first_differing":
                              differ[:3], "card": smi}), flush=True)


def _interpolate_upsample(x):
    """The port's trilinear 2× upsample before it became a stencil of
    slices: `F.interpolate` on the NCDHW view in fp32, rounded once (one
    process only: no slab)."""
    from nas_3d_unet_tpu_torch.ops.stats import _acc

    y = torch.nn.functional.interpolate(
        _acc(x).permute(0, 4, 1, 2, 3), scale_factor=2, mode="trilinear",
        align_corners=False)
    return y.to(x.dtype).permute(0, 2, 3, 4, 1).contiguous()


def repeats_main(seed, smi, dev) -> None:
    """--repeats: whether the search steps repeat their bits (cuDNN
    deterministic, the shipped supernet at 128^3, the first seed), with
    the upsample as `F.interpolate` (whose CUDA backward adds with
    atomics) and as the port's stencil of slices: per step the ops
    `torch.use_deterministic_algorithms(True, warn_only=True)` names in
    one run, then REPEAT_RUNS runs' gradient digests and seconds."""
    import time

    from chip_smoke import (REPEAT_RUNS, _digest, _remat_grads,
                            nondeterministic_ops, search_inputs)
    from nas_3d_unet_tpu_torch.ops import pool

    torch.backends.cudnn.deterministic = True
    net, alphas, batches, cfg = search_inputs(dev, seed)
    xi = cfg.search.xi or cfg.search.w_lr
    for variant, up in (("interpolate", _interpolate_upsample),
                        ("stencil", pool.upsample2x)):
        with mock.patch.object(pool, "upsample2x", up):
            for kind in ("first", "second"):
                def step():
                    out = _remat_grads(kind, net, alphas, batches, xi)
                    net.zero_grad(set_to_none=True)
                    return out

                ops = nondeterministic_ops(step)
                digests, secs = [], []
                for _ in range(REPEAT_RUNS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses, ga, gw = step()
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    digests.append(_digest([*ga, *gw,
                                            torch.tensor(losses)])[:16])
                    del ga, gw
                print(json.dumps({"upsample": variant, "step": kind,
                                  "seed": seed, "nondeterministic_ops": ops,
                                  "digests": digests,
                                  "distinct": len(set(digests)), "s": secs,
                                  "card": smi}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--use-pallas", action="store_true",
                    help="the use_pallas configuration, faults in K3's dx")
    ap.add_argument("--search", action="store_true",
                    help="the search's α gradients, faults in α's terms")
    ap.add_argument("--remat-repeats", action="store_true",
                    help="the search steps' bits, run after run, remat "
                    "off and on")
    ap.add_argument("--repeats", action="store_true",
                    help="the search steps' bits and the ops PyTorch "
                    "names as nondeterministic, with either upsample")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_parity: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import flagship_net, grad_parity, synthetic_batch
    from nas_3d_unet_tpu_torch.ops import pgemm
    from nas_3d_unet_tpu_torch.utils.precision import strict_fp32

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    if args.search:
        with strict_fp32():
            search_main(args.seeds, smi, dev)
        return 0
    if args.remat_repeats:
        with strict_fp32():
            remat_repeats_main(args.seeds[0], smi, dev)
        return 0
    if args.repeats:
        with strict_fp32():
            repeats_main(args.seeds[0], smi, dev)
        return 0
    runs = [(s, "none", None) for s in args.seeds]
    if args.use_pallas:
        runs += [(args.seeds[0], "gn_dx_drop_c", lambda: _k3_fault(True)),
                 (args.seeds[0], "gn_dx_no_mask", lambda: _k3_fault(False))]
    else:
        runs += [(args.seeds[0], name,
                  lambda fn=fn: mock.patch.object(pgemm, "flip_transpose",
                                                  fn))
                 for name, fn in (("dx_no_flip", _no_flip),
                                  ("dx_drop_a_tap", _drop_a_tap))]
    with strict_fp32():
        for seed, fault, ctx in runs:
            net = flagship_net(seed, "bfloat16", args.use_pallas).to(dev)
            x, y = synthetic_batch(dev, seed)
            rec = grad_parity(net, x, y, ctx and ctx(), args.use_pallas)
            print(json.dumps({"seed": seed, "fault": fault,
                              "use_pallas": args.use_pallas, "card": smi,
                              **rec}), flush=True)
            del net, x, y
    return 0


if __name__ == "__main__":
    sys.exit(main())
