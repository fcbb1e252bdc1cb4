"""Decoded architectures (genotypes), without JAX.

Counterpart of `nas_3d_unet_tpu/models/genotype.py`: the same JSON
document, validation, flagship genotype and top-2 α parse.  α itself (and
its `jax.random` init) belongs to the search, which is not ported yet;
`parse_alphas` takes any mapping of array-likes.

Edge sources: down cell — "in0" | "in1" | "n{j}"; up cell — "skip" |
"below" | "n{j}".  Mid-edge flat index for (node i ← node j): i·(i−1)/2 + j.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Mapping, Tuple

import numpy as np

from ..ops.primitives import DOWN_OPS, NORMAL_OPS, UP_OPS

# Edges per node are capped at 2 in the decoded architecture (DARTS-style).
EDGES_PER_NODE = 2


def mid_index(i: int, j: int) -> int:
    """Flat index of the mid edge node_i ← node_j (j < i)."""
    return i * (i - 1) // 2 + j


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
