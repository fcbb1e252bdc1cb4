"""Architecture parameters (α) and decoded architectures (genotypes).

Counterpart of `nas_3d_unet_tpu/models/genotype.py`: α's shapes and its
near-uniform init (`:45-68`), the same JSON document, validation, flagship
genotype and top-2 α parse.  α is a dict of fp32 tensors, one per edge
group, shared by every cell of its kind:

    down_in  (2·N, |DOWN_OPS|)     node i ← in0 (row 2i), in1 (row 2i+1)
    down_mid (N(N−1)/2, |NORMAL|)  node i ← node j < i (row mid_index(i, j))
    up_below (N, |UP_OPS|)         node i ← below
    up_skip  (N, |NORMAL|)         node i ← skip
    up_mid   (N(N−1)/2, |NORMAL|)

`init_alphas` draws from a `torch.Generator`; `jax.random` streams are not
reproduced, so a test hands both packages the same α as numpy arrays.
`parse_alphas` takes any mapping of array-likes.

Edge sources: down cell — "in0" | "in1" | "n{j}"; up cell — "skip" |
"below" | "n{j}".  Mid-edge flat index for (node i ← node j): i·(i−1)/2 + j.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..ops.primitives import DOWN_OPS, NORMAL_OPS, UP_OPS

# Edges per node are capped at 2 in the decoded architecture (DARTS-style).
EDGES_PER_NODE = 2


def mid_index(i: int, j: int) -> int:
    """Flat index of the mid edge node_i ← node_j (j < i)."""
    return i * (i - 1) // 2 + j


def num_mid_edges(n_nodes: int) -> int:
    return n_nodes * (n_nodes - 1) // 2


def alpha_shapes(n_nodes: int) -> Dict[str, Tuple[int, int]]:
    m = num_mid_edges(n_nodes)
    return {
        "down_in": (2 * n_nodes, len(DOWN_OPS)),
        "down_mid": (m, len(NORMAL_OPS)),
        "up_below": (n_nodes, len(UP_OPS)),
        "up_skip": (n_nodes, len(NORMAL_OPS)),
        "up_mid": (m, len(NORMAL_OPS)),
    }


def init_alphas(gen: torch.Generator, n_nodes: int,
                scale: float = 1e-3) -> Dict[str, torch.Tensor]:
    """Near-uniform α, as in DARTS: `scale` times standard normal logits,
    drawn from `gen` (on its device) group by group in sorted name
    order."""
    return {name: scale * torch.randn(shape, generator=gen,
                                      device=gen.device)
            for name, shape in sorted(alpha_shapes(n_nodes).items())}


@dataclass(frozen=True)
class Genotype:
    """Per cell kind, per node, the chosen (src, op) pairs."""

    n_nodes: int
    down: Tuple[Tuple[Tuple[str, str], ...], ...]
    up: Tuple[Tuple[Tuple[str, str], ...], ...]

    def to_json(self) -> str:
        return json.dumps(
            {"n_nodes": self.n_nodes,
             "down": [[list(e) for e in node] for node in self.down],
             "up": [[list(e) for e in node] for node in self.up]},
            indent=2,
        )

    @staticmethod
    def from_json(text: str) -> "Genotype":
        raw = json.loads(text)

        def to_tup(nodes):
            return tuple(tuple((str(s), str(o)) for s, o in node)
                         for node in nodes)

        return Genotype(n_nodes=int(raw["n_nodes"]), down=to_tup(raw["down"]),
                        up=to_tup(raw["up"]))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "Genotype":
        with open(path) as f:
            return Genotype.from_json(f.read())

    def validate(self) -> None:
        for kind, nodes in (("down", self.down), ("up", self.up)):
            if len(nodes) != self.n_nodes:
                raise ValueError(f"{kind}: expected {self.n_nodes} nodes")
            for i, node in enumerate(nodes):
                if len(node) != EDGES_PER_NODE:
                    raise ValueError(
                        f"{kind} node {i}: expected {EDGES_PER_NODE} edges")
                srcs = [s for s, _ in node]
                if len(set(srcs)) != len(srcs):
                    raise ValueError(
                        f"{kind} node {i}: duplicate sources {srcs}")
                for src, op in node:
                    if src.startswith("n"):
                        j = int(src[1:])
                        if not 0 <= j < i:
                            raise ValueError(
                                f"{kind} node {i}: bad source {src}")
                        if op not in NORMAL_OPS:
                            raise ValueError(
                                f"{kind} node {i}: {op} not a normal op")
                    elif kind == "down":
                        if src not in ("in0", "in1") or op not in DOWN_OPS:
                            raise ValueError(
                                f"down node {i}: bad edge ({src}, {op})")
                    elif src == "skip":
                        if op not in NORMAL_OPS:
                            raise ValueError(
                                f"up node {i}: skip edge op {op} not normal")
                    elif src == "below":
                        if op not in UP_OPS:
                            raise ValueError(
                                f"up node {i}: below edge op {op} not an up op")
                    else:
                        raise ValueError(f"up node {i}: bad source {src}")


def default_genotype(n_nodes: int = 3) -> Genotype:
    """The flagship derived net's architecture: node 0 reads both inputs,
    node i>0 reads input 0 and the previous node."""
    down = []
    up = []
    for i in range(n_nodes):
        if i == 0:
            down.append((("in0", "down_conv3"), ("in1", "down_sep_conv3")))
            up.append((("below", "up_transpose"), ("skip", "conv3")))
        else:
            down.append((("in1", "down_conv3"), (f"n{i-1}", "conv3")))
            up.append((("skip", "sep_conv3"), (f"n{i-1}", "conv3")))
    g = Genotype(n_nodes=n_nodes, down=tuple(down), up=tuple(up))
    g.validate()
    return g


def _edge_strength(row: np.ndarray, op_names,
                   exclude_none: bool) -> Tuple[float, str]:
    """(score, best_op) for one edge: softmax over its op set."""
    probs = np.exp(row - row.max())
    probs /= probs.sum()
    best_score, best_op = -1.0, op_names[0]
    for k, name in enumerate(op_names):
        if exclude_none and name == "none":
            continue
        if probs[k] > best_score:
            best_score, best_op = float(probs[k]), name
    return best_score, best_op


def parse_alphas(alphas: Mapping, n_nodes: int) -> Genotype:
    """Decode α → genotype: per node keep the top-2 strongest incoming edges,
    each labelled with its argmax non-`none` op (the DARTS parse)."""
    a = {k: np.asarray(v, dtype=np.float64) for k, v in alphas.items()}

    down_nodes: List[Tuple[Tuple[str, str], ...]] = []
    for i in range(n_nodes):
        cands = []
        for k, src in enumerate(("in0", "in1")):
            s, op = _edge_strength(a["down_in"][2 * i + k], DOWN_OPS, False)
            cands.append((src, op, s))
        for j in range(i):
            s, op = _edge_strength(a["down_mid"][mid_index(i, j)], NORMAL_OPS,
                                   True)
            cands.append((f"n{j}", op, s))
        cands.sort(key=lambda t: -t[2])
        down_nodes.append(tuple((src, op)
                                for src, op, _ in cands[:EDGES_PER_NODE]))

    up_nodes: List[Tuple[Tuple[str, str], ...]] = []
    for i in range(n_nodes):
        s_skip, op_skip = _edge_strength(a["up_skip"][i], NORMAL_OPS, True)
        s_below, op_below = _edge_strength(a["up_below"][i], UP_OPS, False)
        cands = [("skip", op_skip, s_skip), ("below", op_below, s_below)]
        for j in range(i):
            s, op = _edge_strength(a["up_mid"][mid_index(i, j)], NORMAL_OPS,
                                   True)
            cands.append((f"n{j}", op, s))
        cands.sort(key=lambda t: -t[2])
        up_nodes.append(tuple((src, op)
                              for src, op, _ in cands[:EDGES_PER_NODE]))

    g = Genotype(n_nodes=n_nodes, down=tuple(down_nodes), up=tuple(up_nodes))
    g.validate()
    return g
