"""Step-exact training checkpoints, one `.npz` each, written atomically.

Counterpart of `nas_3d_unet_tpu/train/checkpoint.py`: `save_checkpoint`
(tmp + `os.replace`, keep the newest N, an optional stable `best` copy and
`metadata.json`), `latest_checkpoint` and `load_checkpoint`.  A checkpoint
is a flat dict of numpy arrays, never a pickle:

    params/<key>           the net's `state_dict` keys, which are the flax
                           parameter paths with "." for "/" (bridge.py)
    opt/mu/<key>, opt/nu/<key>, opt/count, opt/lr    the AdamW state
    step                   the global step
    rng/augment            the augmentation generator's `get_state()` bytes

A search checkpoint (`search/bilevel.py`) adds α and its AdamW state:
`alphas/<group>`, `a_opt/mu/<group>`, `a_opt/nu/<group>`, `a_opt/count`,
`a_opt/lr`.

A params-only file with the same `params/...` keys (what
`export_flax_params.py` writes from a JAX checkpoint) loads through
`load_params` too.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import bridge
from ..utils.logging import is_primary_process
from .optim import AdamW

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _write_npz(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    # through a file handle: np.savez appends ".npz" to a name lacking it
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_checkpoint(directory: str, step: int,
                    state: Mapping[str, np.ndarray], keep: int = 3,
                    metadata: Optional[dict] = None,
                    best: bool = False) -> str:
    """Write `state` to directory/ckpt_{step}.npz atomically; `best=True`
    also publishes `best.npz`.  Only the primary process writes."""
    path = os.path.join(directory, f"ckpt_{step}.npz")
    if not is_primary_process():
        return path
    os.makedirs(directory, exist_ok=True)
    _write_npz(path, state)
    if metadata is not None:
        mtmp = os.path.join(directory, "metadata.json.tmp")
        with open(mtmp, "w") as f:
            json.dump({"step": step, **metadata}, f, indent=2)
        os.replace(mtmp, os.path.join(directory, "metadata.json"))
    if best:
        _write_npz(os.path.join(directory, "best.npz"), state)
    # prune old step checkpoints (never the best copy)
    for _, p in sorted(_list_ckpts(directory))[:-keep]:
        os.remove(p)
    return path


def _list_ckpts(directory: str):
    out = []
    for p in glob.glob(os.path.join(directory, "ckpt_*.npz")):
        m = _CKPT_RE.search(p)
        if m:
            out.append((int(m.group(1)), p))
    return out


def latest_checkpoint(directory: str) -> Optional[Tuple[int, str]]:
    ckpts = _list_ckpts(directory)
    return max(ckpts) if ckpts else None


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's arrays, by key."""
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _cpu(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def optimizer_state(opt: AdamW, keys, prefix: str) -> Dict[str, np.ndarray]:
    """AdamW's moments (by `keys`, one a parameter, in order), count and lr
    as `<prefix>/mu/<key>`, `<prefix>/nu/<key>`, `<prefix>/count`,
    `<prefix>/lr`."""
    keys = list(keys)
    if len(keys) != len(opt.params):
        raise ValueError("the optimizer does not hold these parameters")
    out = {}
    for name, moments in (("mu", opt.mu), ("nu", opt.nu)):
        out.update({f"{prefix}/{name}/{k}": _cpu(m)
                    for k, m in zip(keys, moments)})
    out[f"{prefix}/count"] = np.asarray(opt.count, np.int64)
    out[f"{prefix}/lr"] = np.asarray(opt.lr, np.float64)
    return out


def restore_optimizer_state(arrays: Mapping[str, np.ndarray], opt: AdamW,
                            keys, prefix: str) -> None:
    """Load `optimizer_state`'s arrays back into `opt`."""
    with torch.no_grad():
        for name, moments in (("mu", opt.mu), ("nu", opt.nu)):
            for k, m in zip(keys, moments):
                m.copy_(torch.from_numpy(arrays[f"{prefix}/{name}/{k}"]))
    opt.count = int(arrays[f"{prefix}/count"])
    opt.lr = float(arrays[f"{prefix}/lr"])


def train_state(net: nn.Module, opt: AdamW, step: int,
                gen: torch.Generator) -> Dict[str, np.ndarray]:
    """The arrays of a training checkpoint (see the module docstring)."""
    out = {f"params/{k}": _cpu(v) for k, v in net.state_dict().items()}
    out.update(optimizer_state(opt, net.state_dict(), "opt"))
    out["step"] = np.asarray(step, np.int64)
    out["rng/augment"] = _cpu(gen.get_state())
    return out


def restore_train_state(arrays: Mapping[str, np.ndarray], net: nn.Module,
                        opt: AdamW, gen: torch.Generator) -> int:
    """Load a training checkpoint into `net`, `opt` and `gen` (strictly);
    returns its step."""
    load_params(net, arrays)
    restore_optimizer_state(arrays, opt, list(net.state_dict()), "opt")
    gen.set_state(torch.from_numpy(arrays["rng/augment"]))
    return int(arrays["step"])


def load_params(net: nn.Module, arrays: Mapping[str, np.ndarray]) -> None:
    """Copy the `params/...` arrays into `net`; every parameter must be
    there with its shape, and nothing else (`bridge.load_flax_params`)."""
    flat = {k[len("params/"):]: torch.from_numpy(np.asarray(v))
            for k, v in arrays.items() if k.startswith("params/")}
    bridge.load_flax_params(net, bridge.params_to_flax(flat))
