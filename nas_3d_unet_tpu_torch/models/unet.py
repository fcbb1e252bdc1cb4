"""The U-shaped supernet and derived network, in PyTorch.

Counterpart of `SuperNet` and `DerivedNet` in
`nas_3d_unet_tpu/models/unet.py` (:73-100, :118-190): stem ConvNormAct →
`depth` down cells → `depth` up cells with encoder skips → fp32 1³ head
with bias → region logits.  Activations are NDHWC in the compute dtype
(`dtype`: "float32", or "bfloat16" as training and the search run);
parameters stay fp32 and each op casts them, and the head runs in fp32 on
fp32-cast features (`unet.py:90-100`).  Node channels double per level
(c·2^l) and a cell outputs n_nodes·c_l channels.

The supernet's forward takes `(x, arch_weights)`: softmax(α) per edge
group (`arch_weights_from_alphas`), shared by every cell of a kind.  α
lives outside the module, so a supernet's `state_dict()` holds the same
keys as the flax supernet's `params`.

`use_pallas=True` is the reference's `packed=False, use_pallas=True`
configuration (`config.py:88`): the cells' edge ops run the `use_pallas`
kernels (K6, K7, K4) and every GroupNorm is K3 (`ops/primitives.py`); the
parameters are the same either way.

Children carry flax's names (`ConvNormAct_0` for the stem,
`CheckpointDerivedDownCell_i` / `CheckpointDerivedUpCell_i`, or
`CheckpointSuperDownCell_i` / `CheckpointSuperUpCell_i` — the prefix is
`nn.remat`'s — and `Conv_0` for the head), so `state_dict()` keys are the
flax parameter paths.  Up cells are numbered in creation order, so up cell
0 is the deepest level.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
from torch import nn

from ..ops.primitives import ConvNormAct, Kernel
from .cell import DerivedDownCell, DerivedUpCell, SuperDownCell, SuperUpCell
from .genotype import Genotype

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _UNet(nn.Module):
    """The U-shape around its cells: `down(c_pp, c_p, features, s0_stride)`
    and `up(c_skip, c_below, features)` build them, registered as
    `Checkpoint<kind>DownCell_i` / `Checkpoint<kind>UpCell_i`."""

    def __init__(self, kind: str, down: Callable, up: Callable,
                 in_channels: int, num_classes: int, base_channels: int,
                 depth: int, n_nodes: int, gn_groups: int, norm: str,
                 dtype: str, use_pallas: bool):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {sorted(DTYPES)}")
        self.compute_dtype = DTYPES[dtype]
        self.depth = depth
        self._down = [f"Checkpoint{kind}DownCell_{i}" for i in range(depth)]
        self._up = [f"Checkpoint{kind}UpCell_{i}" for i in range(depth)]
        c_out = [n_nodes * base_channels]            # channels of each level
        self.ConvNormAct_0 = ConvNormAct(in_channels, c_out[0], 3, 1, 1,
                                         gn_groups, use_pallas,
                                         pallas_conv=False, norm=norm)
        c_pp = c_p = c_out[0]
        for level in range(1, depth + 1):
            self.add_module(self._down[level - 1], down(
                c_pp, c_p, base_channels * 2 ** level,
                1 if level == 1 else 2))
            c_out.append(n_nodes * base_channels * 2 ** level)
            c_pp, c_p = c_p, c_out[-1]
        c_below = c_out[-1]
        for i, level in enumerate(range(depth - 1, -1, -1)):
            self.add_module(self._up[i], up(c_out[level], c_below,
                                            base_channels * 2 ** level))
            c_below = n_nodes * base_channels * 2 ** level
        self.Conv_0 = Kernel((1, 1, 1, c_below, num_classes), bias=True)

    def _run(self, x: torch.Tensor, down_args: tuple,
             up_args: tuple) -> torch.Tensor:
        """x (B, D, H, W, in_channels) → fp32 logits (B, D, H, W,
        num_classes); D, H, W divisible by 2**depth.  The cells take their
        inputs, then `down_args` / `up_args`."""
        stem = self.ConvNormAct_0(x.to(self.compute_dtype))
        feats = [stem]
        s_pp = s_p = stem
        for name in self._down:
            out = getattr(self, name)(s_pp, s_p, *down_args)
            s_pp, s_p = s_p, out
            feats.append(out)
        below = feats[-1]
        for name, level in zip(self._up, range(self.depth - 1, -1, -1)):
            below = getattr(self, name)(feats[level], below, *up_args)
        head = self.Conv_0
        return below.float() @ head.kernel.view(below.shape[-1], -1) \
            + head.bias


class DerivedNet(_UNet):
    """Fixed-architecture network rebuilt from a genotype."""

    def __init__(self, genotype: Genotype, in_channels: int = 4,
                 num_classes: int = 3, base_channels: int = 16,
                 depth: int = 3, n_nodes: int = 3, gn_groups: int = 8,
                 merge_ops: bool = True, dtype: str = "float32",
                 use_pallas: bool = False, norm: str = "group"):
        if genotype.n_nodes != n_nodes:
            raise ValueError(f"genotype has {genotype.n_nodes} nodes, "
                             f"net {n_nodes}")
        kw = dict(gn_groups=gn_groups, merge_ops=merge_ops,
                  use_pallas=use_pallas, norm=norm)
        super().__init__(
            "Derived",
            lambda c_pp, c_p, c, s: DerivedDownCell(
                c_pp, c_p, c, genotype.down, s0_stride=s, **kw),
            lambda c_skip, c_below, c: DerivedUpCell(
                c_skip, c_below, c, genotype.up, **kw),
            in_channels, num_classes, base_channels, depth, n_nodes,
            gn_groups, norm, dtype, use_pallas)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, (), ())


class SuperNet(_UNet):
    """The DARTS supernet: every edge holds every candidate op of its set,
    weighted by softmax(α).  `pc_k` > 1: partial channels (PC-DARTS,
    `models/cell.py`), C/pc_k channels of each edge through its candidate
    ops; it must divide `base_channels` (`unet.py:131-134`)."""

    def __init__(self, in_channels: int = 4, num_classes: int = 3,
                 base_channels: int = 16, depth: int = 3, n_nodes: int = 3,
                 gn_groups: int = 8, merge_ops: bool = True,
                 dtype: str = "float32", use_pallas: bool = False,
                 norm: str = "group", pc_k: int = 1):
        if pc_k > 1 and base_channels % pc_k:
            raise ValueError(f"partial_channels={pc_k} must divide "
                             f"base_channels={base_channels}")
        settings = dict(in_channels=in_channels, num_classes=num_classes,
                        base_channels=base_channels, depth=depth,
                        n_nodes=n_nodes, gn_groups=gn_groups,
                        merge_ops=merge_ops, dtype=dtype,
                        use_pallas=use_pallas, norm=norm, pc_k=pc_k)
        kw = dict(norm=norm, gn_groups=gn_groups, merge_ops=merge_ops,
                  use_pallas=use_pallas, pc_k=pc_k)
        super().__init__(
            "Super",
            lambda c_pp, c_p, c, s: SuperDownCell(c_pp, c_p, c, n_nodes,
                                                  s0_stride=s, **kw),
            lambda c_skip, c_below, c: SuperUpCell(c_skip, c_below, c,
                                                   n_nodes, **kw),
            in_channels, num_classes, base_channels, depth, n_nodes,
            gn_groups, norm, dtype, use_pallas)
        self.settings = settings

    def clone(self, **overrides) -> "SuperNet":
        """A new supernet with this one's settings but `overrides` (flax's
        `Module.clone`), its parameters fresh."""
        return SuperNet(**{**self.settings, **overrides})

    def forward(self, x: torch.Tensor,
                arch_weights: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """x as `DerivedNet`'s; `arch_weights`: softmax(α) by group (see
        `arch_weights_from_alphas`)."""
        w = arch_weights
        return self._run(x, (w["down_in"], w["down_mid"]),
                         (w["up_skip"], w["up_below"], w["up_mid"]))


def arch_weights_from_alphas(
        alphas: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """softmax over the op axis of every α tensor, in fp32."""
    return {k: torch.softmax(v.float(), dim=-1) for k, v in alphas.items()}


def make_supernet(model_cfg, num_classes: int) -> SuperNet:
    """The supernet of a `ModelConfig` (`utils/config.py`).  `packed` has
    no effect; the `Searcher` rebuilds it with `search.partial_channels`
    (`SuperNet.clone`)."""
    return SuperNet(in_channels=model_cfg.in_channels,
                    num_classes=num_classes,
                    base_channels=model_cfg.base_channels,
                    depth=model_cfg.depth, n_nodes=model_cfg.n_nodes,
                    gn_groups=model_cfg.gn_groups,
                    merge_ops=model_cfg.merge_ops, dtype=model_cfg.dtype,
                    use_pallas=model_cfg.use_pallas, norm=model_cfg.norm)


def make_derived(model_cfg, num_classes: int, genotype: Genotype,
                 dtype_override: str | None = None) -> DerivedNet:
    """The derived net of a `ModelConfig` (`utils/config.py`, which refuses
    the settings the port does not run); `dtype_override` replaces
    `model_cfg.dtype` (serving's `infer.dtype`).  `packed` has no effect."""
    return DerivedNet(genotype, in_channels=model_cfg.in_channels,
                      num_classes=num_classes,
                      base_channels=model_cfg.base_channels,
                      depth=model_cfg.depth, n_nodes=model_cfg.n_nodes,
                      gn_groups=model_cfg.gn_groups,
                      merge_ops=model_cfg.merge_ops,
                      dtype=dtype_override or model_cfg.dtype,
                      use_pallas=model_cfg.use_pallas, norm=model_cfg.norm)
