#!/usr/bin/env python3
"""Readings behind `chip_smoke.py`'s gradient limits, on one NVIDIA GPU.

    python3 grad_parity.py [--seeds 0 1 2 3] [--use-pallas]

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
Prints one JSON line per run: the largest per-leaf relative L2 distance,
the smallest cosine, the largest relative difference of the norms, and
whether chip_smoke.py's limits pass it.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--use-pallas", action="store_true",
                    help="the use_pallas configuration, faults in K3's dx")
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
