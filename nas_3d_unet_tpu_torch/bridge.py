"""Flax parameter trees ⇄ the port's `state_dict`s.

The port's modules carry flax's names and its parameters flax's shapes, so
the mapping is a rename: the flax path `A/B/kernel` is the `state_dict` key
`A.B.kernel`, and the arrays are the same.  Which keys exist comes from the
module structure itself (`net.state_dict()`), never from a list kept here;
`load_flax_params` refuses a tree with a missing, extra or misshapen leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _inner(tree: Mapping) -> Mapping:
    """Accept `{"params": {...}}` (what `Module.init` returns) or its body."""
    return tree["params"] if set(tree) == {"params"} else tree


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (array-likes) → flat `{dotted.path: fp32 tensor}`."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = torch.from_numpy(
                    np.array(v, dtype=np.float32))

    walk(_inner(tree), "")
    return flat


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """`state_dict` → `{"params": nested dict of fp32 numpy arrays}`."""
    root: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    return {"params": root}


def load_flax_params(net: nn.Module, tree: Mapping) -> None:
    """Copy a flax tree into `net`; every leaf must match one parameter."""
    sd = params_from_flax(tree)
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"flax tree does not fit the net: missing {missing}, "
                         f"extra {extra}, misshapen {shapes}")
    net.load_state_dict(sd)


def random_flax_params(net: nn.Module, seed: int) -> Dict[str, Any]:
    """A flax-shaped tree for `net` from `seed`, with flax's initialisers'
    scales: conv kernels `lecun_normal` (truncated normal, fan_in = all axes
    but the last), GroupNorm scales 1, biases 0."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, t in net.state_dict().items():
        shape = tuple(t.shape)
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            z = rng.standard_normal(shape)
            while (bad := np.abs(z) > 2).any():       # truncate at ±2σ
                z[bad] = rng.standard_normal(int(bad.sum()))
            # flax scales by 1/0.8796 so the truncated draw has unit variance
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            flat[key] = torch.from_numpy((z * std).astype(np.float32))
        elif leaf == "scale":
            flat[key] = torch.ones(shape)
        else:
            flat[key] = torch.zeros(shape)
    return params_to_flax(flat)
