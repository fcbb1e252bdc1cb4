"""Model operations of one unit of work, counted from the shapes by
`torch.utils.flop_counter` over the plain reference on the meta device:
the convolutions and matmuls of the forward and of what the backward
computes (no recompute), each multiply-add as two.

Units: a train sample (forward and backward to the weights), a search
step (the α-step's forward and backward to α with the weights fixed, the
w-step's forward and backward to the weights), a served window (forward).
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import train as rt
from ..reference.net import Net, Params, arch_shapes, arch_weights, param_spec


def per_unit(cfg: Mapping, kind: str, patch: int) -> float:
    """FLOPs of one unit of `kind` ("train", "search", "serve") at
    patch³."""
    dev = "meta"
    spec = param_spec(cfg)
    weights = {n: torch.zeros(s, device=dev) for n, (s, _) in spec.items()}
    net = Net(cfg)
    x = torch.zeros((1, patch, patch, patch, cfg["in_channels"]), device=dev)
    y = torch.zeros((1, patch, patch, patch, cfg["num_classes"]), device=dev)
    with FlopCounterMode(display=False) as fc:
        if kind == "serve":
            with torch.no_grad():
                net.forward(Params(weights), x)
        elif kind == "train":
            params = rt.leaves(list(weights), weights, dev)
            loss = rt.loss_fn(net.forward(Params(params), x), y)
            torch.autograd.grad(loss, list(params.values()))
        elif kind == "search":
            alphas = {k: torch.zeros(s, device=dev, requires_grad=True)
                      for k, s in arch_shapes(cfg["n_nodes"]).items()}
            params = rt.leaves(list(weights), weights, dev)
            fixed = Params({k: v.detach() for k, v in params.items()})
            val = rt.loss_fn(net.forward(fixed, x, arch_weights(alphas)), y)
            torch.autograd.grad(val, list(alphas.values()))
            arch = {k: v.detach() for k, v in arch_weights(alphas).items()}
            loss = rt.loss_fn(net.forward(Params(params), x, arch), y)
            torch.autograd.grad(loss, list(params.values()))
        else:
            raise ValueError(kind)
    return float(fc.get_total_flops())
