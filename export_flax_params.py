#!/usr/bin/env python3
"""Bring a JAX checkpoint's parameters over to the PyTorch port.

    python3 export_flax_params.py ckpt/train/best.msgpack ckpt_torch/best.npz

Reads a `ckpt_<step>.msgpack` or `best.msgpack` written by
`nas_3d_unet_tpu`'s `save_checkpoint` (flax's msgpack, restored without a
template), takes its parameters, and writes a params-only `.npz` whose keys
are `params/<flax path with "." for "/">`: the port's `state_dict` keys, as
in the port's own checkpoints.  The port's `predict` loads it from its
`infer.checkpoint_dir` (as `best.npz` or `ckpt_<step>.npz`).

This script runs where flax is installed; the port itself never imports
it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Mapping

import numpy as np
from flax import serialization


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(flatten(val, f"{prefix}{key}."))
        else:
            out[f"params/{prefix}{key}"] = np.asarray(val, np.float32)
    return out


def export(src: str, dst: str) -> int:
    """Write `dst` from the JAX checkpoint `src`; returns the leaf count."""
    with open(src, "rb") as f:
        state = serialization.msgpack_restore(f.read())
    # a TrainState: its `params` is what flax's `init` returns
    arrays = flatten(state["params"]["params"])
    tmp = dst + ".tmp"
    with open(tmp, "wb") as f:              # np.savez would rename a bare tmp
        np.savez(f, **arrays)
    os.replace(tmp, dst)
    return len(arrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="JAX ckpt_<step>.msgpack or best.msgpack")
    ap.add_argument("dst", help="the port's .npz to write")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)
    n = export(args.src, args.dst)
    print(f"{args.dst}: {n} parameter arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
