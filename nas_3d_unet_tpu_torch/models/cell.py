"""Derived cells (the DAG bodies of the U-shape), in PyTorch.

Counterpart of `DerivedDownCell` / `DerivedUpCell` in
`nas_3d_unet_tpu/models/cell.py` (:260-356, :457-507).

`use_pallas` goes to the edge ops (`make_op`), as the reference passes it
(`cell.py:288-290`, `:338-339`); the input projections take it for their
GroupNorm only.

Resolution contract:
  DerivedDownCell: inputs s0, s1 → output at half s1's resolution (s0 may
    be one level above s1; its 1³ projection then has stride 2).
  DerivedUpCell: skip at R, below at R/2 → output at R.
Channel contract: every state inside a cell carries `features` channels;
the cell output concatenates the node outputs → n_nodes·features.

Submodules are named the way flax auto-names them in the JAX cell, in the
same creation order: `_pre` of the first input, `_pre` of the second, the
merged ops, then the per-edge ops in gene order (`ConvNormAct_0`,
`SepConv_0`, …).  That makes `state_dict()` keys the flax parameter paths.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

import torch
from torch import nn

from ..ops.primitives import ConvNormAct, _gn_groups_for, make_op

# Ops whose output channels can be widened so edges sharing (source, op) run
# as ONE op: independent kernel slices, GN groups aligned to the channel
# split, so the math is exactly that of separate ops.  Separable convs are
# excluded: merging would share the depthwise kernel.
_MERGEABLE = {"conv3", "dil_conv3", "down_conv3", "down_dil_conv3",
              "up_transpose", "up_conv3"}

Gene = Tuple[Tuple[Tuple[str, str], ...], ...]


class _DerivedCell(nn.Module):
    """Shared body: two input projections, then the gene's edges."""

    def __init__(self, in_channels: Tuple[int, int], features: int,
                 gene: Gene, gn_groups: int, merge_ops: bool,
                 pre_strides: Tuple[int, int], use_pallas: bool):
        super().__init__()
        self.features = features
        self.gene = gene
        self._names: Counter = Counter()
        # the reference builds the projections without use_pallas
        # (`cell.py:271-274`): their GroupNorm still rounds once under it
        self.pre = [self._add(ConvNormAct(ci, features, 1, s, 1, gn_groups,
                                          use_pallas, pallas_conv=False))
                    for ci, s in zip(in_channels, pre_strides)]
        # (src, op) used k ≥ 2 times → one k·C-wide op (`_merged_edges`)
        self.merged: Dict[Tuple[str, str], str] = {}
        if merge_ops:
            counts = Counter(e for node in gene for e in node
                             if e[1] in _MERGEABLE)
            g_eff = _gn_groups_for(features, gn_groups)
            for key, k in counts.items():
                if k >= 2:
                    self.merged[key] = self._add(
                        make_op(key[1], features, k * features, k * g_eff,
                                use_pallas))
        self.edges = [[None if e in self.merged else
                       self._add(make_op(e[1], features, features, gn_groups,
                                         use_pallas))
                       for e in node] for node in gene]

    def _add(self, mod: nn.Module) -> str:
        """Register `mod` under flax's auto-name; return the name."""
        cls = type(mod).__name__
        name = f"{cls}_{self._names[cls]}"
        self._names[cls] += 1
        self.add_module(name, mod)
        return name

    def _nodes(self, states: Dict[str, torch.Tensor]) -> torch.Tensor:
        c = self.features
        wide: Dict[Tuple[str, str], torch.Tensor] = {}
        used: Counter = Counter()
        nodes = []
        for i, node in enumerate(self.gene):
            acc = None
            for e, name in zip(node, self.edges[i]):
                src = e[0]
                if name is not None:
                    y = getattr(self, name)(states[src])
                else:
                    if e not in wide:   # one wide op, computed once
                        wide[e] = getattr(self, self.merged[e])(states[src])
                    j = used[e]
                    used[e] += 1
                    y = wide[e][..., j * c:(j + 1) * c]
                acc = y if acc is None else acc + y
            states[f"n{i}"] = acc
            nodes.append(acc)
        return torch.cat(nodes, dim=-1)


class DerivedDownCell(_DerivedCell):
    """Encoder cell with genotype-fixed edges; `s0_stride` is 2 when s0 is
    one level above s1."""

    def __init__(self, c_pp: int, c_p: int, features: int, gene: Gene,
                 gn_groups: int = 8, merge_ops: bool = True,
                 s0_stride: int = 1, use_pallas: bool = False):
        super().__init__((c_pp, c_p), features, gene, gn_groups, merge_ops,
                         (s0_stride, 1), use_pallas)

    def forward(self, s0: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
        p0, p1 = (getattr(self, n) for n in self.pre)
        return self._nodes({"in0": p0(s0), "in1": p1(s1)})


class DerivedUpCell(_DerivedCell):
    """Decoder cell with genotype-fixed edges; edges from "below" use UP
    ops, so every path from the R/2 input is upsampled to R."""

    def __init__(self, c_skip: int, c_below: int, features: int, gene: Gene,
                 gn_groups: int = 8, merge_ops: bool = True,
                 use_pallas: bool = False):
        super().__init__((c_skip, c_below), features, gene, gn_groups,
                         merge_ops, (1, 1), use_pallas)

    def forward(self, skip: torch.Tensor, below: torch.Tensor) -> torch.Tensor:
        p0, p1 = (getattr(self, n) for n in self.pre)
        return self._nodes({"skip": p0(skip), "below": p1(below)})
