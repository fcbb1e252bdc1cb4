"""Candidate ops of the NAS edges, in PyTorch on NDHWC tensors.

Counterpart of `nas_3d_unet_tpu/ops/primitives.py` for the ops the flagship
derived net runs.  Parameters keep flax's names and shapes (`kernel` in
DHWIO, depthwise `(3, 3, 3, 1, C)`, GroupNorm `scale`/`bias`), so a flax
tree maps onto `state_dict()` by renaming "/" to "." (see `bridge.py`).

Which path each conv takes mirrors where the JAX package runs Pallas.
By default (`use_pallas=False`, the reference's shipped `packed=True`
path, `ConvNormAct` → `conv_stats_fused_viable`, `ops/packed.py:356`):
  * stride-1 3³ `ConvNormAct` → K1 `pgemm.conv3x3x3_stats` (conv + moments);
  * stride-1 1³ `ConvNormAct` → K2 `pgemm.gemm_stats`;
  * everything else (stride-2 convs, the depthwise conv, the pointwise conv
    of `SepConv`, the k2s2 transpose conv) is plain PyTorch with autograd
    (cuDNN / cuBLAS), as the JAX package leaves it to XLA, followed by
    GroupNorm from K5a's moments (`ops/stats.py`).
With `use_pallas=True` (the reference's `packed=False, use_pallas=True`,
`primitives.py:277,331,452`), the edge ops take the `ops/conv3d.py`
kernels and every GroupNorm is K3 (`groupnorm.pallas_group_norm`: one
rounding, ReLU fused):
  * 3³ `ConvNormAct` (stride 1 or 2) → K6 `conv3d` → K3;
  * `SepConv` → cuDNN depthwise → K7 `pointwise_conv` → K3;
  * `UpTranspose` → K4 `conv_transpose2x` → K3;
  * the stem and the cells' 1³ projections, which the reference builds
    without `use_pallas` (`unet.py:73-75`, `cell.py:271-274`), keep K1 / K2
    / cuDNN (`pallas_conv=False`) with K3's one-rounding GroupNorm on their
    moments, as flax's `nn.GroupNorm` rounds once.
The op order is conv → GroupNorm → ReLU throughout.

Precision, as flax's `dtype` / `param_dtype`: parameters stay fp32 and each
op casts its kernel to the activations' dtype (fp32 or bf16) before use;
GroupNorm's statistics and affine are fp32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from . import conv3d as pconv
from . import groupnorm, pgemm
from .conv3d import conv3d_same
from .groupnorm import group_norm, group_norm_from_moments

NORMAL_OPS: Sequence[str] = (
    "none",
    "identity",
    "conv3",
    "dil_conv3",
    "sep_conv3",
    "avg_pool3",
    "max_pool3",
)

DOWN_OPS: Sequence[str] = (
    "down_avg_pool",
    "down_max_pool",
    "down_conv3",
    "down_dil_conv3",
    "down_sep_conv3",
)

UP_OPS: Sequence[str] = (
    "up_transpose",
    "up_conv3",
    "up_sep_conv3",
)


def _gn_groups_for(channels: int, groups: int) -> int:
    g = min(groups, channels)
    while channels % g != 0:
        g -= 1
    return g


class Kernel(nn.Module):
    """A conv kernel in flax's shape (`kernel`), with an optional `bias`."""

    def __init__(self, shape: Tuple[int, ...], bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(shape))
        if bias:
            self.bias = nn.Parameter(torch.zeros(shape[-1]))


class Norm(nn.Module):
    """GroupNorm(+ReLU) parameters (`scale`, `bias`), the group count, and
    which GroupNorm runs: K3 under `use_pallas`, else the default path's
    (`group_norm_from_moments`, on K5a's moments when the producer has
    none)."""

    def __init__(self, channels: int, groups: int, use_pallas: bool = False):
        super().__init__()
        self.groups = groups
        self.use_pallas = use_pallas
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, y: torch.Tensor, moments=None) -> torch.Tensor:
        """GroupNorm + ReLU of y; `moments` = (Σy, Σy²) when the producer
        emitted them."""
        if self.use_pallas:
            return groupnorm.pallas_group_norm(y, self.scale, self.bias,
                                               self.groups, relu=True,
                                               moments=moments)
        if moments is None:
            return group_norm(y, self.scale, self.bias, self.groups,
                              relu=True)
        return group_norm_from_moments(y, *moments, self.scale, self.bias,
                                       self.groups, relu=True)


class ConvNormAct(nn.Module):
    """conv3d (kernel 1 or 3, stride 1 or 2, dilation 1 or 2) → GroupNorm →
    ReLU.  `use_pallas`: K3 GroupNorm, and the 3³ conv on K6 unless
    `pallas_conv` is False (the stem and the cells' projections)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, gn_groups: int = 8,
                 use_pallas: bool = False, pallas_conv: bool = True):
        super().__init__()
        if kernel not in (1, 3) or stride not in (1, 2) \
                or dilation not in (1, 2):
            raise ValueError(f"ConvNormAct: kernel {kernel} stride {stride} "
                             f"dilation {dilation}")
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.k6 = use_pallas and pallas_conv and kernel == 3
        self.conv = Kernel((kernel,) * 3 + (in_channels, features))
        self.norm = Norm(features, _gn_groups_for(features, gn_groups),
                         use_pallas)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.kernel.to(x.dtype)
        if self.k6:
            return self.norm(pconv.conv3d(x, w, None, self.stride,
                                          self.dilation))
        if self.stride == 2:
            return self.norm(conv3d_same(x, w, self.stride, self.dilation))
        x = x.contiguous()
        if self.kernel == 3:
            y, s1, s2 = pgemm.conv3x3x3_stats(x, w, self.dilation)
        else:
            b, cin = x.shape[0], x.shape[-1]
            y, s1, s2 = pgemm.gemm_stats(x.view(b, -1, cin), w.view(cin, -1))
            y = y.view(*x.shape[:-1], -1)
        return self.norm(y, (s1, s2))


class SepConv(nn.Module):
    """Depthwise 3³ conv (stride 1 or 2) → pointwise 1³ conv → GroupNorm →
    ReLU.  `use_pallas`: K7 pointwise conv and K3 GroupNorm."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 gn_groups: int = 8, use_pallas: bool = False):
        super().__init__()
        self.stride = stride
        self.dw = Kernel((3, 3, 3, 1, in_channels))
        self.pw = Kernel((1, 1, 1, in_channels, features))
        self.norm = Norm(features, _gn_groups_for(features, gn_groups),
                         use_pallas)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        y = conv3d_same(x, self.dw.kernel.to(x.dtype), self.stride, groups=c)
        pw = self.pw.kernel.to(x.dtype).view(c, -1)
        if self.norm.use_pallas:
            return self.norm(pconv.pointwise_conv(y, pw))
        return self.norm(y @ pw)


class UpTranspose(nn.Module):
    """2× transpose conv (kernel 2, stride 2) → GroupNorm → ReLU.
    `use_pallas`: K4 transpose conv and K3 GroupNorm."""

    def __init__(self, in_channels: int, features: int, gn_groups: int = 8,
                 use_pallas: bool = False):
        super().__init__()
        self.deconv = Kernel((2, 2, 2, in_channels, features))
        self.norm = Norm(features, _gn_groups_for(features, gn_groups),
                         use_pallas)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.deconv.kernel.to(x.dtype)
        if self.norm.use_pallas:
            return self.norm(pconv.conv_transpose2x(x, w))
        return self.norm(pconv.conv_transpose2x_twin(x, w))


# Factory signature: (in_channels, features, gn_groups, use_pallas) →
# module.
_FACTORIES = {
    "conv3": lambda ci, c, g, up: ConvNormAct(ci, c, 3, 1, 1, g, up),
    "dil_conv3": lambda ci, c, g, up: ConvNormAct(ci, c, 3, 1, 2, g, up),
    "sep_conv3": lambda ci, c, g, up: SepConv(ci, c, 1, g, up),
    "down_conv3": lambda ci, c, g, up: ConvNormAct(ci, c, 3, 2, 1, g, up),
    "down_dil_conv3": lambda ci, c, g, up: ConvNormAct(ci, c, 3, 2, 2, g, up),
    "down_sep_conv3": lambda ci, c, g, up: SepConv(ci, c, 2, g, up),
    "up_transpose": lambda ci, c, g, up: UpTranspose(ci, c, g, up),
}


def make_op(name: str, in_channels: int, features: int,
            gn_groups: int = 8, use_pallas: bool = False) -> nn.Module:
    """Instantiate a candidate op by registry name."""
    if name in _FACTORIES:
        return _FACTORIES[name](in_channels, features, gn_groups, use_pallas)
    if name in (*NORMAL_OPS, *DOWN_OPS, *UP_OPS):
        raise NotImplementedError(f"op {name!r} is not ported yet")
    raise KeyError(f"unknown op {name!r}")
