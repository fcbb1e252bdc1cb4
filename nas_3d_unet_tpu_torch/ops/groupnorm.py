"""GroupNorm(+ReLU) on NDHWC from raw moments, in plain PyTorch.

Counterpart of the JAX package's packed GroupNorm (`ops/packed.py`):
`_fold_stats` / `_affine` / `gn_s` (:772-787, :870-876) for producers whose
kernel already emitted Σy and Σy², and `packed_group_norm` (:911-925) for
producers without them.  The numerics follow the reference, not
`torch.nn.GroupNorm`: eps 1e-6, variance `E[x²] − mean²` from the raw
moments with no clamp, and the normalize as one `x·a + b` with
`a = inv·γ`, `b = β − mean·inv·γ`.
"""

from __future__ import annotations

import torch

from .pgemm import moments

EPS = 1e-6


def group_norm_from_moments(x: torch.Tensor, s1: torch.Tensor,
                            s2: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, groups: int, relu: bool,
                            eps: float = EPS) -> torch.Tensor:
    """x (B, ..., C); s1 = Σx, s2 = Σx² (B, C) over the voxels of each
    batch item.  Per-(batch, group) statistics over voxels and the group's
    channels."""
    b, c = x.shape[0], x.shape[-1]
    gsize = c // groups
    n = (x.numel() // (b * c)) * gsize
    mean = s1.view(b, groups, gsize).sum(-1) / n
    var = s2.view(b, groups, gsize).sum(-1) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(gsize, dim=1) * scale               # (B, C)
    shift = bias - mean.repeat_interleave(gsize, dim=1) * a
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    y = torch.addcmul(shift.view(shape), x, a.view(shape))   # one pass
    return y.relu_() if relu else y


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, relu: bool, eps: float = EPS) -> torch.Tensor:
    """GroupNorm(+ReLU) for a producer that emits no moments."""
    return group_norm_from_moments(x, *moments(x), scale, bias, groups, relu,
                                   eps)
