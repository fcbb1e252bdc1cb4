"""The plain reference of the DARTS 3D U-Net: the derived net of a
genotype and the supernet, fp32, as functions of a parameter dict.

The U-shape (github.com/woodywff/nas_3d_unet; DARTS, arXiv:1806.09055): a
stem conv → `depth` down cells → `depth` up cells, each reading the
encoder state of its level → a 1³ head with bias.  A cell projects its
two inputs to `features` channels (1³ conv → GroupNorm → ReLU), builds
`n_nodes` nodes, each the sum of its incoming edges, and outputs the
nodes' concatenation.  Down cells halve the resolution on the edges from
their inputs; up cells take the state below at half resolution through an
up op.  Every conv-family op is conv → GroupNorm → ReLU.

Parameter names follow the flax modules' paths, which is how a trained
checkpoint of this model names them: `<Module>_<n>` in creation order per
class inside each module.  An op that several edges of a cell apply to
one source (a conv of the same kind) is held as one kernel of k·features
outputs, edge e taking outputs [e·features, (e+1)·features) with its own
GroupNorm groups; each separable conv keeps its own kernels.  The
arithmetic is that of k separate ops.

`Params` hands out the tensors by name and checks their shapes; with no
tensors it records the names and shapes instead (`param_spec`), from a
forward on the meta device.  Tensors are NCDHW inside; `forward` takes
and returns NDHWC.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Mapping, Optional

import torch

from . import ops
from .ops import FP32, Precision

NORMAL_OPS = ("none", "identity", "conv3", "dil_conv3", "sep_conv3",
              "avg_pool3", "max_pool3")
DOWN_OPS = ("down_avg_pool", "down_max_pool", "down_conv3",
            "down_dil_conv3", "down_sep_conv3")
UP_OPS = ("up_transpose", "up_conv3", "up_sep_conv3")
WIDE = {"conv3", "dil_conv3", "down_conv3", "down_dil_conv3",
        "up_transpose", "up_conv3"}
CLASS = {"identity": "Identity", "avg_pool3": "Pool", "max_pool3": "Pool",
         "down_avg_pool": "Pool", "down_max_pool": "Pool",
         "conv3": "ConvNormAct", "dil_conv3": "ConvNormAct",
         "down_conv3": "ConvNormAct", "down_dil_conv3": "ConvNormAct",
         "sep_conv3": "SepConv", "down_sep_conv3": "SepConv",
         "up_transpose": "UpTranspose", "up_conv3": "UpSampleConv",
         "up_sep_conv3": "UpSampleConv"}


class Params:
    """Parameters by name.  `tensors` None: record every request's shape
    and kind ("kernel", "scale", "bias") in `spec` and hand out meta
    tensors."""

    def __init__(self, tensors: Optional[Mapping[str, torch.Tensor]] = None):
        self.tensors = tensors
        self.spec: Dict[str, tuple] = {}

    def __call__(self, name: str, shape, kind: str) -> torch.Tensor:
        shape = tuple(shape)
        if self.tensors is None:
            self.spec[name] = (shape, kind)
            return torch.zeros(shape, device="meta")
        t = self.tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the model "
                             f"needs {shape}")
        return t


class _Names:
    """flax's auto-names inside one module: `<class>_<n>`."""

    def __init__(self, prefix: str):
        self.prefix, self.count = prefix, Counter()

    def __call__(self, cls: str) -> str:
        name = f"{self.prefix}{cls}_{self.count[cls]}"
        self.count[cls] += 1
        return name


class Net:
    """One configuration's net: `cfg` holds in_channels, num_classes,
    base_channels, depth, n_nodes, gn_groups, and for a derived net its
    genotype ({"down": [[[src, op], ...], ...], "up": ...})."""

    def __init__(self, cfg: Mapping, prec: Precision = FP32):
        self.cfg, self.prec = cfg, prec
        self.supernet = "genotype" not in cfg

    # -- ops ----------------------------------------------------------
    def conv_norm(self, p, name, x, cout, k=3, stride=1, dilation=1,
                  groups=None):
        w = p(f"{name}.conv.kernel", (k, k, k, x.shape[1], cout), "kernel")
        y = ops.conv(x, w, self.prec, stride, dilation)
        return self.norm(p, name, y, groups)

    def norm(self, p, name, y, groups=None):
        c = y.shape[1]
        g = groups or ops.gn_groups(c, self.cfg["gn_groups"])
        return ops.group_norm_relu(y, p(f"{name}.norm.scale", (c,), "scale"),
                                   p(f"{name}.norm.bias", (c,), "bias"), g)

    def sep_conv(self, p, name, x, cout, stride=1):
        c = x.shape[1]
        dw = p(f"{name}.dw.kernel", (3, 3, 3, 1, c), "kernel")
        pw = p(f"{name}.pw.kernel", (1, 1, 1, c, cout), "kernel")
        y = ops.conv(x, dw, self.prec, stride, groups=c)
        return self.norm(p, name, ops.conv(y, pw, self.prec))

    def op(self, p, name, kind, x, cout, groups=None):
        """Candidate op `kind` on x (cout outputs; the parameter-free ops
        keep x's channels)."""
        if kind == "identity":
            return x
        if kind in ("avg_pool3", "down_avg_pool"):
            return ops.avg_pool3(x, 2 if kind.startswith("down") else 1)
        if kind in ("max_pool3", "down_max_pool"):
            return ops.max_pool3(x, 2 if kind.startswith("down") else 1)
        if kind in ("conv3", "dil_conv3", "down_conv3", "down_dil_conv3"):
            return self.conv_norm(p, name, x, cout,
                                  stride=2 if kind.startswith("down") else 1,
                                  dilation=2 if "dil" in kind else 1,
                                  groups=groups)
        if kind in ("sep_conv3", "down_sep_conv3"):
            return self.sep_conv(p, name, x, cout,
                                 2 if kind.startswith("down") else 1)
        if kind == "up_transpose":
            w = p(f"{name}.deconv.kernel", (2, 2, 2, x.shape[1], cout),
                  "kernel")
            return self.norm(p, name, ops.conv_transpose2x(x, w, self.prec),
                             groups)
        if kind == "up_conv3":
            return self.conv_norm(p, f"{name}.ConvNormAct_0",
                                  ops.upsample2x(x), cout, groups=groups)
        if kind == "up_sep_conv3":
            return self.sep_conv(p, f"{name}.SepConv_0", ops.upsample2x(x),
                                 cout)
        raise KeyError(kind)

    def wide(self, p, name, kind, x, c, k):
        """A conv-family op of k edges held as one of k·c outputs: the k
        edges' outputs."""
        g = k * ops.gn_groups(c, self.cfg["gn_groups"])
        y = self.op(p, name, kind, x, k * c, groups=g)
        return [y[:, e * c:(e + 1) * c] for e in range(k)]

    # -- cells --------------------------------------------------------
    def derived_cell(self, p, name, s0, s1, c, gene, stride0, kind):
        names = _Names(name + ".")
        x0 = self.conv_norm(p, names("ConvNormAct"), s0, c, k=1,
                            stride=stride0)
        x1 = self.conv_norm(p, names("ConvNormAct"), s1, c, k=1)
        states = ({"in0": x0, "in1": x1} if kind == "down"
                  else {"skip": x0, "below": x1})
        edges = [tuple(e) for node in gene for e in node]
        uses = Counter(e for e in edges if e[1] in WIDE)
        wide = {e: names(CLASS[e[1]]) for e, n in uses.items() if n >= 2}
        own = {}
        for i, node in enumerate(gene):
            for j, e in enumerate(node):
                if tuple(e) not in wide:
                    own[(i, j)] = names(CLASS[e[1]])
        outs, taken, nodes = {}, Counter(), []
        for i, node in enumerate(gene):
            acc = 0
            for j, (src, kind_) in enumerate(node):
                e = (src, kind_)
                if e in wide:
                    if e not in outs:
                        outs[e] = self.wide(p, wide[e], kind_, states[src], c,
                                            uses[e])
                    y = outs[e][taken[e]]
                    taken[e] += 1
                else:
                    y = self.op(p, own[(i, j)], kind_, states[src], c)
                acc = acc + y
            states[f"n{i}"] = acc
            nodes.append(acc)
        return torch.cat(nodes, 1)

    def source(self, p, name, x, op_names, c, rows):
        """Every edge leaving one source in the supernet: edge e's
        Σ_o rows[e, o]·op_o(x)."""
        names = _Names(name + ".")
        k = rows.shape[0]
        outs = [0] * k
        for o, kind in enumerate(op_names):
            if kind == "none":
                continue
            if kind in WIDE:
                ys = self.wide(p, names(CLASS[kind]), kind, x, c, k)
            elif CLASS[kind] in ("SepConv", "UpSampleConv"):
                ys = [self.op(p, names(CLASS[kind]), kind, x, c)
                      for _ in range(k)]
            else:
                names(CLASS[kind])
                ys = [self.op(p, None, kind, x, c)] * k
            for e in range(k):
                outs[e] = outs[e] + rows[e, o] * ys[e]
        return outs

    def super_cell(self, p, name, s0, s1, c, arch, stride0, kind):
        n = self.cfg["n_nodes"]
        names = _Names(name + ".")
        x0 = self.conv_norm(p, names("ConvNormAct"), s0, c, k=1,
                            stride=stride0)
        x1 = self.conv_norm(p, names("ConvNormAct"), s1, c, k=1)
        if kind == "down":
            srcs = [("in0", x0, DOWN_OPS, arch["down_in"][0::2]),
                    ("in1", x1, DOWN_OPS, arch["down_in"][1::2])]
            mid = arch["down_mid"]
        else:
            srcs = [("below", x1, UP_OPS, arch["up_below"]),
                    ("skip", x0, NORMAL_OPS, arch["up_skip"])]
            mid = arch["up_mid"]
        acc = [0] * n
        for src, x, op_names, rows in srcs:
            for i, t in enumerate(self.source(p, f"{name}.src_{src}", x,
                                              op_names, c, rows)):
                acc[i] = acc[i] + t
        for j in range(n - 1):
            tgts = range(j + 1, n)
            rows = torch.stack([mid[i * (i - 1) // 2 + j] for i in tgts])
            for i, t in zip(tgts, self.source(p, f"{name}.src_n{j}", acc[j],
                                              NORMAL_OPS, c, rows)):
                acc[i] = acc[i] + t
        return torch.cat(acc, 1)

    # -- the U-net ----------------------------------------------------
    def forward(self, p: Params, x: torch.Tensor,
                arch: Optional[Mapping[str, torch.Tensor]] = None):
        """x (B, D, H, W, in_channels) → fp32 logits (B, D, H, W,
        num_classes).  `arch`: the supernet's softmax(α) by group."""
        cfg = self.cfg
        base, depth, n = cfg["base_channels"], cfg["depth"], cfg["n_nodes"]
        kind = "Super" if self.supernet else "Derived"
        x = x.float().permute(0, 4, 1, 2, 3)
        stem = self.conv_norm(p, "ConvNormAct_0", x, n * base)
        feats, s_pp, s_p = [stem], stem, stem
        for i in range(depth):
            level = i + 1
            name, c = f"Checkpoint{kind}DownCell_{i}", base * 2 ** level
            stride0 = 1 if level == 1 else 2
            if self.supernet:
                out = self.super_cell(p, name, s_pp, s_p, c, arch, stride0,
                                      "down")
            else:
                out = self.derived_cell(p, name, s_pp, s_p, c,
                                        cfg["genotype"]["down"], stride0,
                                        "down")
            s_pp, s_p = s_p, out
            feats.append(out)
        below = feats[-1]
        for i, level in enumerate(range(depth - 1, -1, -1)):
            name, c = f"Checkpoint{kind}UpCell_{i}", base * 2 ** level
            if self.supernet:
                below = self.super_cell(p, name, feats[level], below, c,
                                        arch, 1, "up")
            else:
                below = self.derived_cell(p, name, feats[level], below, c,
                                          cfg["genotype"]["up"], 1, "up")
        w = p("Conv_0.kernel", (1, 1, 1, below.shape[1],
                                cfg["num_classes"]), "kernel")
        b = p("Conv_0.bias", (cfg["num_classes"],), "bias")
        feat = self.prec.operand(below.permute(0, 2, 3, 4, 1))
        return feat @ self.prec.operand(w.view(below.shape[1], -1)) + b


def arch_shapes(n_nodes: int) -> Dict[str, tuple]:
    """α's groups: rows are edges, columns that group's candidate ops."""
    m = n_nodes * (n_nodes - 1) // 2
    return {"down_in": (2 * n_nodes, len(DOWN_OPS)),
            "down_mid": (m, len(NORMAL_OPS)),
            "up_below": (n_nodes, len(UP_OPS)),
            "up_skip": (n_nodes, len(NORMAL_OPS)),
            "up_mid": (m, len(NORMAL_OPS))}


def arch_weights(alphas: Mapping[str, torch.Tensor]):
    """softmax(α) over each group's ops."""
    return {k: torch.softmax(v.float(), -1) for k, v in alphas.items()}


def param_spec(cfg: Mapping) -> Dict[str, tuple]:
    """{name: (shape, kind)} of every parameter, in the order the forward
    asks for them."""
    net, p = Net(cfg), Params()
    side = 2 ** cfg["depth"]
    x = torch.zeros((1, side, side, side, cfg["in_channels"]),
                    device="meta")
    arch = None
    if net.supernet:
        arch = {k: torch.zeros(s, device="meta")
                for k, s in arch_shapes(cfg["n_nodes"]).items()}
    net.forward(p, x, arch)
    return p.spec
