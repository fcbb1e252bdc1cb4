"""The derived U-shaped network, in PyTorch.

Counterpart of `DerivedNet` in `nas_3d_unet_tpu/models/unet.py`
(:73-100, :162-190): stem ConvNormAct → `depth` down cells → `depth` up
cells with encoder skips → fp32 1³ head with bias → region logits.
Activations are NDHWC in the compute dtype (`dtype`: "float32", or
"bfloat16" as the training path runs); parameters stay fp32 and each op
casts them, and the head runs in fp32 on fp32-cast features
(`unet.py:90-100`).  Node channels double per level (c·2^l) and a cell
outputs n_nodes·c_l channels.

`use_pallas=True` is the reference's `packed=False, use_pallas=True`
configuration (`config.py:88`): the cells' edge ops run the `use_pallas`
kernels (K6, K7, K4) and every GroupNorm is K3 (`ops/primitives.py`); the
parameters are the same either way.

Children carry flax's names (`ConvNormAct_0` for the stem,
`CheckpointDerivedDownCell_i` / `CheckpointDerivedUpCell_i` — the prefix
is `nn.remat`'s — and `Conv_0` for the head), so `state_dict()` keys are
the flax parameter paths.  Up cells are numbered in creation order, so
`CheckpointDerivedUpCell_0` is the deepest level.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.primitives import ConvNormAct, Kernel
from .cell import DerivedDownCell, DerivedUpCell
from .genotype import Genotype

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DerivedNet(nn.Module):
    """Fixed-architecture network rebuilt from a genotype."""

    def __init__(self, genotype: Genotype, in_channels: int = 4,
                 num_classes: int = 3, base_channels: int = 16,
                 depth: int = 3, n_nodes: int = 3, gn_groups: int = 8,
                 merge_ops: bool = True, dtype: str = "float32",
                 use_pallas: bool = False):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {sorted(DTYPES)}")
        self.compute_dtype = DTYPES[dtype]
        if genotype.n_nodes != n_nodes:
            raise ValueError(f"genotype has {genotype.n_nodes} nodes, "
                             f"net {n_nodes}")
        self.depth = depth
        c_out = [n_nodes * base_channels]            # channels of each level
        self.ConvNormAct_0 = ConvNormAct(in_channels, c_out[0], 3, 1, 1,
                                         gn_groups, use_pallas,
                                         pallas_conv=False)
        c_pp = c_p = c_out[0]
        for level in range(1, depth + 1):
            cell = DerivedDownCell(c_pp, c_p, base_channels * 2 ** level,
                                   genotype.down, gn_groups, merge_ops,
                                   s0_stride=1 if level == 1 else 2,
                                   use_pallas=use_pallas)
            self.add_module(f"CheckpointDerivedDownCell_{level - 1}", cell)
            c_out.append(n_nodes * base_channels * 2 ** level)
            c_pp, c_p = c_p, c_out[-1]
        c_below = c_out[-1]
        for i, level in enumerate(range(depth - 1, -1, -1)):
            cell = DerivedUpCell(c_out[level], c_below,
                                 base_channels * 2 ** level, genotype.up,
                                 gn_groups, merge_ops, use_pallas)
            self.add_module(f"CheckpointDerivedUpCell_{i}", cell)
            c_below = n_nodes * base_channels * 2 ** level
        self.Conv_0 = Kernel((1, 1, 1, c_below, num_classes), bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, D, H, W, in_channels) → fp32 logits (B, D, H, W,
        num_classes); D, H, W divisible by 2**depth."""
        stem = self.ConvNormAct_0(x.to(self.compute_dtype))
        feats = [stem]
        s_pp = s_p = stem
        for i in range(self.depth):
            out = getattr(self, f"CheckpointDerivedDownCell_{i}")(s_pp, s_p)
            s_pp, s_p = s_p, out
            feats.append(out)
        below = feats[-1]
        for i, level in enumerate(range(self.depth - 1, -1, -1)):
            below = getattr(self, f"CheckpointDerivedUpCell_{i}")(
                feats[level], below)
        head = self.Conv_0
        return below.float() @ head.kernel.view(below.shape[-1], -1) \
            + head.bias


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
                      use_pallas=model_cfg.use_pallas)
