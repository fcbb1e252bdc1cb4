#!/usr/bin/env python3
"""Readings behind `chip_smoke.py`'s gradient limits, on one NVIDIA GPU.

    python3 grad_parity.py [--seeds 0 1 2 3]

For each seed: the bf16 flagship at 128^3, batch 2, microbatch 1 (weights
and batch from the seed, as chip_smoke.py's phase "train" makes them), one
step's gradients on the kernel path against the twin path, leaf by leaf
(`chip_smoke.grad_parity`).  Then the same with a fault planted in K1's
backward, on the first seed:
  dx_no_flip      K1-dx run with the kernel transposed but not flipped;
  dx_drop_a_tap   K1-dx with one of the 27 taps of the flipped kernel
                  zeroed.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
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
    runs += [(args.seeds[0], name, fn) for name, fn in
             (("dx_no_flip", _no_flip), ("dx_drop_a_tap", _drop_a_tap))]
    with strict_fp32():
        for seed, fault, fn in runs:
            net = flagship_net(seed, "bfloat16").to(dev)
            x, y = synthetic_batch(dev, seed)
            ctx = (mock.patch.object(pgemm, "flip_transpose", fn) if fn
                   else None)
            rec = grad_parity(net, x, y, ctx)
            print(json.dumps({"seed": seed, "fault": fault, "card": smi,
                              **rec}), flush=True)
            del net, x, y
    return 0


if __name__ == "__main__":
    sys.exit(main())
