"""Supernet and derived cells (the DAG bodies of the U-shape), in PyTorch.

Counterpart of `nas_3d_unet_tpu/models/cell.py`: the supernet's `MixedOp`
(:225, the per-edge form), `_SourceOps` (:145, the source-major merged
form), `SuperDownCell` (:359) and `SuperUpCell` (:406), and the derived
`DerivedDownCell` / `DerivedUpCell` (:260-356, :457-507).

Supernet edge: out = Σ_o w_o · op_o(x), w = softmax(α) computed once a
step outside the cell.  Each weight is cast to the activations' dtype
first and the terms are chained in registry order (`none` included, as
w·0), which in bf16 is the rounding order.  Two equivalent forms:
  * merge_ops=True (the default, `_SourceOps`): per source state, every
    conv-family candidate (`_MERGEABLE`) runs once as a k·C-wide op for its
    k outgoing edges (independent kernel slices, k·g GroupNorm groups
    aligned to the split), each parameter-free candidate runs once, `none`
    is skipped, and the separable convs keep per-edge parameters; per edge
    the terms accumulate in op order;
  * merge_ops=False (`MixedOp`): the literal per-edge chain, the oracle.
The nodes accumulate in the reference's order: in0, in1, then the earlier
nodes (down cell); below, skip, then the earlier nodes (up cell).
Partial channels (PC-DARTS, `pc_k` > 1, search only): each edge runs its
candidates on the first C/pc_k channels of its source, at that width
(GroupNorm groups as `_gn_groups_for` gives them there); the other
channels bypass (a stride-2 max pool on down edges, the trilinear 2×
upsample on up edges), are concatenated after the candidates' sum and
channel-shuffled (`_pc_shuffle`).  The
reference's per-edge and per-source remat is not ported (`ROADMAP.md`
queue 1, item 10).

`use_pallas` goes to the edge ops (`make_op`), as the reference passes it
(`cell.py:288-290`, `:338-339`); the input projections take it for their
GroupNorm only.

Resolution contract:
  down cells: inputs s0, s1 → output at half s1's resolution (s0 may be
    one level above s1; its 1³ projection then has stride 2).
  up cells: skip at R, below at R/2 → output at R.
Channel contract: every state inside a cell carries `features` channels;
the cell output concatenates the node outputs → n_nodes·features.

Submodules are named the way flax names them in the JAX cell, in the same
creation order (`_Named`): `_pre` of the first input, `_pre` of the second
(`ConvNormAct_0`, `ConvNormAct_1`); then, derived, the merged ops and the
per-edge ops in gene order; supernet, the sources `src_in0`, `src_in1`,
`src_n0`, … (`src_below`, `src_skip`, … up), or the per-edge
`CheckpointMixedOp_<i>`, and inside each, its ops by class (`ConvNormAct_0`,
`SepConv_1`, `UpSampleConv_0`, …).  That makes `state_dict()` keys the
flax parameter paths.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..ops import pool
from ..ops.primitives import (DOWN_OPS, NORMAL_OPS, UP_OPS, ConvNormAct,
                              _gn_groups_for, make_op)
from .genotype import mid_index

# Ops whose output channels can be widened so edges sharing (source, op) run
# as ONE op: independent kernel slices, GN groups aligned to the channel
# split, so the math is exactly that of separate ops.  Separable convs are
# excluded: merging would share the depthwise kernel.
_MERGEABLE = {"conv3", "dil_conv3", "down_conv3", "down_dil_conv3",
              "up_transpose", "up_conv3"}

# Parameter-free ops: the same output on every edge leaving a source, so
# the supernet computes them once per source.  "none" is skipped: its
# weighted term is exactly zero.
_NONPARAM = {"identity", "avg_pool3", "max_pool3", "down_avg_pool",
             "down_max_pool"}

Gene = Tuple[Tuple[Tuple[str, str], ...], ...]


def _wide_groups(features: int, gn_groups: int, norm: str) -> int:
    """GroupNorm groups of one edge's slice of a merged op."""
    return _gn_groups_for(features, gn_groups) if norm != "none" \
        else gn_groups


class _Named(nn.Module):
    """Children registered under flax's auto-names: `<class>_<n>`, n
    counting that class's children in creation order."""

    def __init__(self):
        super().__init__()
        self._names: Counter = Counter()

    def _add(self, mod: nn.Module, cls: str | None = None) -> str:
        """Register `mod` as `<cls>_<n>` (cls: its class name); return the
        name."""
        cls = cls or type(mod).__name__
        name = f"{cls}_{self._names[cls]}"
        self._names[cls] += 1
        self.add_module(name, mod)
        return name


class _DerivedCell(_Named):
    """Shared body: two input projections, then the gene's edges."""

    def __init__(self, in_channels: Tuple[int, int], features: int,
                 gene: Gene, gn_groups: int, merge_ops: bool,
                 pre_strides: Tuple[int, int], use_pallas: bool, norm: str):
        super().__init__()
        self.features = features
        self.gene = gene
        # the reference builds the projections without use_pallas
        # (`cell.py:271-274`): their GroupNorm still rounds once under it
        self.pre = [self._add(ConvNormAct(ci, features, 1, s, 1, gn_groups,
                                          use_pallas, pallas_conv=False,
                                          norm=norm))
                    for ci, s in zip(in_channels, pre_strides)]
        # (src, op) used k ≥ 2 times → one k·C-wide op (`_merged_edges`)
        self.merged: Dict[Tuple[str, str], str] = {}
        if merge_ops:
            counts = Counter(e for node in gene for e in node
                             if e[1] in _MERGEABLE)
            g_eff = _wide_groups(features, gn_groups, norm)
            for key, k in counts.items():
                if k >= 2:
                    self.merged[key] = self._add(
                        make_op(key[1], features, k * features, k * g_eff,
                                use_pallas, norm))
        self.edges = [[None if e in self.merged else
                       self._add(make_op(e[1], features, features, gn_groups,
                                         use_pallas, norm))
                       for e in node] for node in gene]

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
                 s0_stride: int = 1, use_pallas: bool = False,
                 norm: str = "group"):
        super().__init__((c_pp, c_p), features, gene, gn_groups, merge_ops,
                         (s0_stride, 1), use_pallas, norm)

    def forward(self, s0: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
        p0, p1 = (getattr(self, n) for n in self.pre)
        return self._nodes({"in0": p0(s0), "in1": p1(s1)})


class DerivedUpCell(_DerivedCell):
    """Decoder cell with genotype-fixed edges; edges from "below" use UP
    ops, so every path from the R/2 input is upsampled to R."""

    def __init__(self, c_skip: int, c_below: int, features: int, gene: Gene,
                 gn_groups: int = 8, merge_ops: bool = True,
                 use_pallas: bool = False, norm: str = "group"):
        super().__init__((c_skip, c_below), features, gene, gn_groups,
                         merge_ops, (1, 1), use_pallas, norm)

    def forward(self, skip: torch.Tensor, below: torch.Tensor) -> torch.Tensor:
        p0, p1 = (getattr(self, n) for n in self.pre)
        return self._nodes({"skip": p0(skip), "below": p1(below)})


# ---------------------------------------------------------------------------
# Supernet
# ---------------------------------------------------------------------------


def _weighted(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One edge term w·y, the weight cast to y's dtype first."""
    return w.to(y.dtype) * y


# ---------------------------------------------------------------------------
# Partial channels (PC-DARTS, the reference's `cell.py:70-143`), search only.
# With pc_k = K > 1 an edge sends the first C/K channels of its input
# through the candidate ops; the other (K−1)/K bypass them, matched to the
# output's resolution, and a channel shuffle remixes the two so the next
# edge samples other channels.  K = 1 is full DARTS.
# ---------------------------------------------------------------------------


def _pc_shuffle(t: torch.Tensor, k: int) -> torch.Tensor:
    """The channel shuffle over k groups, out[i·k+g] = in[g·(C/k)+i]: the
    reference's unpacked reshape-transpose, as an explicit copy (the port
    has no packed layout whose metadata could permute instead)."""
    *lead, c = t.shape
    return t.reshape(*lead, k, c // k).transpose(-2, -1).reshape(*lead, c)


def _pc_bypass(xb: torch.Tensor, op_names: Sequence[str]) -> torch.Tensor:
    """The bypassed channels at the candidates' output resolution: a
    stride-2 max pool on down edges (the reference's `Pool("max", 2)`),
    the trilinear 2× upsample on up edges, as they are on normal edges."""
    if any(n.startswith("down_") for n in op_names):
        return pool.max_pool3(xb, 2)
    if any(n.startswith("up_") for n in op_names):
        return pool.upsample2x(xb)
    return xb


def _pc_split(x: torch.Tensor, cp: int):
    """(the active first cp channels, the bypassed rest)."""
    return x[..., :cp], x[..., cp:]


class MixedOp(_Named):
    """One supernet edge, literally: Σ_o w_o · op_o(x) over `op_names`, a
    chain of multiply-adds in registry order; with `pc_k` > 1 on the first
    C/pc_k channels, the rest bypassed and shuffled back in."""

    def __init__(self, features: int, op_names: Sequence[str],
                 norm: str = "group", gn_groups: int = 8,
                 use_pallas: bool = False, pc_k: int = 1):
        super().__init__()
        self.op_names, self.pc_k = tuple(op_names), pc_k
        self.cp = cp = features // pc_k
        self.ops = [self._add(make_op(name, cp, cp, gn_groups, use_pallas,
                                      norm))
                    for name in op_names]

    def forward(self, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """weights: the edge's softmax(α) row (n_ops,)."""
        if self.pc_k > 1:
            x, xb = _pc_split(x, self.cp)
            xb = _pc_bypass(xb, self.op_names)
        acc = None
        for o, name in enumerate(self.ops):
            term = _weighted(weights[o], getattr(self, name)(x))
            acc = term if acc is None else acc + term
        if self.pc_k > 1:
            return _pc_shuffle(torch.cat([acc, xb], dim=-1), self.pc_k)
        return acc


class _SourceOps(_Named):
    """Every outgoing supernet edge of one source state, source-major: the
    same sums as one `MixedOp` per edge (see the module docstring).  With
    `pc_k` > 1 the ops run at C/pc_k channels and the bypass is computed
    once for every edge."""

    def __init__(self, op_names: Sequence[str], features: int, n_edges: int,
                 norm: str = "group", gn_groups: int = 8,
                 use_pallas: bool = False, pc_k: int = 1):
        super().__init__()
        k = n_edges
        cp = features // pc_k
        self.op_names, self.pc_k = tuple(op_names), pc_k
        self.cp, self.n_edges = cp, k
        # (op index, "shared" | "wide" | "edges", child name(s))
        self.plan: List[tuple] = []
        for o, name in enumerate(op_names):
            if name == "none":
                continue
            if name in _NONPARAM:
                self.plan.append((o, "shared", self._add(
                    make_op(name, cp, cp, gn_groups, use_pallas, norm))))
            elif name in _MERGEABLE:
                g_eff = _wide_groups(cp, gn_groups, norm)
                self.plan.append((o, "wide", self._add(
                    make_op(name, cp, k * cp, k * g_eff, use_pallas, norm))))
            else:   # per-edge parameters (separable convs)
                self.plan.append((o, "edges", [
                    self._add(make_op(name, cp, cp, gn_groups, use_pallas,
                                      norm)) for _ in range(k)]))

    def forward(self, x: torch.Tensor,
                weights: torch.Tensor) -> List[torch.Tensor]:
        """weights: (k, n_ops) softmax(α) rows, one per outgoing edge.
        Returns the k edge contributions, in edge order."""
        c, k = self.cp, self.n_edges
        if self.pc_k > 1:
            x, xb = _pc_split(x, c)
            xb = _pc_bypass(xb, self.op_names)    # once, for every edge
        outs: List[torch.Tensor | None] = [None] * k

        def acc(e: int, term: torch.Tensor) -> None:
            outs[e] = term if outs[e] is None else outs[e] + term

        for o, kind, names in self.plan:
            if kind == "shared":
                y = getattr(self, names)(x)
                for e in range(k):
                    acc(e, _weighted(weights[e, o], y))
            elif kind == "wide":
                y = getattr(self, names)(x)
                for e in range(k):
                    acc(e, _weighted(weights[e, o],
                                     y[..., e * c:(e + 1) * c]))
            else:
                for e, name in enumerate(names):
                    acc(e, _weighted(weights[e, o], getattr(self, name)(x)))
        if self.pc_k > 1:
            outs = [_pc_shuffle(torch.cat([t, xb], dim=-1), self.pc_k)
                    for t in outs]
        return outs


class _SuperCell(_Named):
    """Two input projections, then every edge of the cell: as one
    `_SourceOps` per source (merge_ops) or one `MixedOp` per edge.

    `in_srcs`: the names of the two inputs, in the order their edges
    accumulate into a node; `in_ops`: their op sets.  Node i's edges are
    in_srcs[0] (weight row `in_rows[0](i)`), in_srcs[1] (`in_rows[1](i)`),
    then n_j for j < i (NORMAL_OPS, `w_mid[mid_index(i, j)]`)."""

    def __init__(self, in_channels: Tuple[int, int],
                 pre_strides: Tuple[int, int], features: int, n_nodes: int,
                 in_srcs: Tuple[str, str], in_ops: Tuple[Sequence[str], ...],
                 norm: str, gn_groups: int, merge_ops: bool,
                 use_pallas: bool, pc_k: int):
        super().__init__()
        self.n_nodes, self.merge_ops = n_nodes, merge_ops
        self.in_srcs = in_srcs
        self.pre = [self._add(ConvNormAct(ci, features, 1, s, 1, gn_groups,
                                          use_pallas, pallas_conv=False,
                                          norm=norm))
                    for ci, s in zip(in_channels, pre_strides)]
        op_kw = dict(norm=norm, gn_groups=gn_groups, use_pallas=use_pallas,
                     pc_k=pc_k)
        n = n_nodes
        if merge_ops:
            for src, ops in zip(in_srcs, in_ops):
                self.add_module(f"src_{src}",
                                _SourceOps(ops, features, n, **op_kw))
            for j in range(n - 1):
                self.add_module(f"src_n{j}", _SourceOps(
                    NORMAL_OPS, features, n - 1 - j, **op_kw))
        else:
            # per node: the two inputs' edges, then the earlier nodes'
            self.edges = [[self._add(MixedOp(features, ops, **op_kw),
                                     "CheckpointMixedOp")
                           for ops in (*in_ops, *[NORMAL_OPS] * i)]
                          for i in range(n)]

    def _cell(self, x0: torch.Tensor, x1: torch.Tensor,
              in_rows: Tuple[torch.Tensor, torch.Tensor],
              w_mid: torch.Tensor) -> torch.Tensor:
        """The nodes from the projected inputs; `in_rows[s]` (n, n_ops):
        the weight rows of input s's edges, node by node."""
        n = self.n_nodes
        if not self.merge_ops:
            nodes = []
            for i in range(n):
                srcs = (x0, x1, *nodes)
                rows = (in_rows[0][i], in_rows[1][i],
                        *(w_mid[mid_index(i, j)] for j in range(i)))
                acc = None
                for name, x, w in zip(self.edges[i], srcs, rows):
                    t = getattr(self, name)(x, w)
                    acc = t if acc is None else acc + t
                nodes.append(acc)
            return torch.cat(nodes, dim=-1)

        accs: List[torch.Tensor | None] = [None] * n

        def add(i: int, t: torch.Tensor) -> None:
            accs[i] = t if accs[i] is None else accs[i] + t

        for src, x, rows in zip(self.in_srcs, (x0, x1), in_rows):
            for e, t in enumerate(getattr(self, f"src_{src}")(x, rows)):
                add(e, t)
        nodes = []
        for j in range(n):
            node = accs[j]      # complete: its sources are the inputs, n_<j
            nodes.append(node)
            tgts = range(j + 1, n)
            if tgts:
                rows = torch.stack([w_mid[mid_index(i, j)] for i in tgts])
                for i, t in zip(tgts, getattr(self, f"src_n{j}")(node, rows)):
                    add(i, t)
        return torch.cat(nodes, dim=-1)


class SuperDownCell(_SuperCell):
    """Encoder supernet cell: stride-2 DOWN_OPS edges from in0 and in1,
    NORMAL_OPS mid edges; `s0_stride` is 2 when s0 is one level above
    s1."""

    def __init__(self, c_pp: int, c_p: int, features: int, n_nodes: int,
                 norm: str = "group", gn_groups: int = 8,
                 merge_ops: bool = True, s0_stride: int = 1,
                 use_pallas: bool = False, pc_k: int = 1):
        super().__init__((c_pp, c_p), (s0_stride, 1), features, n_nodes,
                         ("in0", "in1"), (DOWN_OPS, DOWN_OPS), norm,
                         gn_groups, merge_ops, use_pallas, pc_k)

    def forward(self, s0: torch.Tensor, s1: torch.Tensor, w_in: torch.Tensor,
                w_mid: torch.Tensor) -> torch.Tensor:
        """w_in (2·n, |DOWN_OPS|): node i ← in0 at row 2i, ← in1 at 2i+1."""
        p0, p1 = (getattr(self, n) for n in self.pre)
        return self._cell(p0(s0), p1(s1), (w_in[0::2], w_in[1::2]), w_mid)


class SuperUpCell(_SuperCell):
    """Decoder supernet cell: UP_OPS edges from `below` (at R/2), NORMAL_OPS
    from `skip` (at R) and between nodes."""

    def __init__(self, c_skip: int, c_below: int, features: int,
                 n_nodes: int, norm: str = "group", gn_groups: int = 8,
                 merge_ops: bool = True, use_pallas: bool = False,
                 pc_k: int = 1):
        super().__init__((c_skip, c_below), (1, 1), features, n_nodes,
                         ("below", "skip"), (UP_OPS, NORMAL_OPS), norm,
                         gn_groups, merge_ops, use_pallas, pc_k)

    def forward(self, skip: torch.Tensor, below: torch.Tensor,
                w_skip: torch.Tensor, w_below: torch.Tensor,
                w_mid: torch.Tensor) -> torch.Tensor:
        p_skip, p_below = (getattr(self, n) for n in self.pre)
        return self._cell(p_below(below), p_skip(skip), (w_below, w_skip),
                          w_mid)
