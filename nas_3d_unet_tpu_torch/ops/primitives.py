"""Candidate ops of the NAS edges, in PyTorch on NDHWC tensors.

Counterpart of `nas_3d_unet_tpu/ops/primitives.py` for the ops the flagship
derived net runs.  Parameters keep flax's names and shapes (`kernel` in
DHWIO, depthwise `(3, 3, 3, 1, C)`, GroupNorm `scale`/`bias`), so a flax
tree maps onto `state_dict()` by renaming "/" to "." (see `bridge.py`).

Which path each conv takes mirrors where the JAX package runs Pallas on
this path (`ConvNormAct` → `conv_stats_fused_viable`, `ops/packed.py:356`):
  * stride-1 3³ `ConvNormAct` → K1 `pgemm.conv3x3x3_stats` (conv + moments);
  * stride-1 1³ `ConvNormAct` → K2 `pgemm.gemm_stats`;
  * everything else (stride-2 convs, the depthwise conv, the pointwise conv
    of `SepConv`, the k2s2 transpose conv) is plain PyTorch with autograd
    (cuDNN / cuBLAS), as the JAX package leaves it to XLA, followed by
    GroupNorm from K5a's moments (`ops/stats.py`).
The op order is conv → GroupNorm → ReLU throughout.

Precision, as flax's `dtype` / `param_dtype`: parameters stay fp32 and each
op casts its kernel to the activations' dtype (fp32 or bf16) before use;
GroupNorm's statistics and affine are fp32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import pgemm
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


def same_pad(in_size: int, kernel: int, stride: int,
             dilation: int) -> Tuple[int, int]:
    """lax 'SAME' padding (lo, hi) for one axis: the odd pad goes high."""
    out = -(-in_size // stride)
    k_eff = dilation * (kernel - 1) + 1
    total = max(0, (out - 1) * stride + k_eff - in_size)
    return total // 2, total - total // 2


def conv3d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Plain SAME conv on NDHWC with a DHWIO kernel (cuDNN).  The pad is
    explicit because torch's `padding=` is symmetric and lax's is not."""
    k = w.shape[0]
    pads = []
    for size in reversed(x.shape[1:4]):                  # F.pad wants W first
        pads += same_pad(size, k, stride, dilation)
    xt = x.permute(0, 4, 1, 2, 3)
    if any(pads):
        xt = F.pad(xt, pads)
    y = F.conv3d(xt, w.permute(4, 3, 0, 1, 2), stride=stride,
                 dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 4, 1)


class Kernel(nn.Module):
    """A conv kernel in flax's shape (`kernel`), with an optional `bias`."""

    def __init__(self, shape: Tuple[int, ...], bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(shape))
        if bias:
            self.bias = nn.Parameter(torch.zeros(shape[-1]))


class Norm(nn.Module):
    """GroupNorm parameters (`scale`, `bias`) and the group count."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class ConvNormAct(nn.Module):
    """conv3d (kernel 1 or 3, stride 1 or 2, dilation 1 or 2) → GroupNorm →
    ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, gn_groups: int = 8):
        super().__init__()
        if kernel not in (1, 3) or stride not in (1, 2) \
                or dilation not in (1, 2):
            raise ValueError(f"ConvNormAct: kernel {kernel} stride {stride} "
                             f"dilation {dilation}")
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.conv = Kernel((kernel,) * 3 + (in_channels, features))
        self.norm = Norm(features, _gn_groups_for(features, gn_groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.kernel.to(x.dtype)
        n = self.norm
        if self.stride == 1:
            x = x.contiguous()
            if self.kernel == 3:
                y, s1, s2 = pgemm.conv3x3x3_stats(x, w, self.dilation)
            else:
                b, cin = x.shape[0], x.shape[-1]
                y, s1, s2 = pgemm.gemm_stats(x.view(b, -1, cin),
                                             w.view(cin, -1))
                y = y.view(*x.shape[:-1], -1)
            return group_norm_from_moments(y, s1, s2, n.scale, n.bias,
                                           n.groups, relu=True)
        y = conv3d_same(x, w, self.stride, self.dilation)
        return group_norm(y, n.scale, n.bias, n.groups, relu=True)


class SepConv(nn.Module):
    """Depthwise 3³ conv (stride 1 or 2) → pointwise 1³ conv → GroupNorm →
    ReLU."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 gn_groups: int = 8):
        super().__init__()
        self.stride = stride
        self.dw = Kernel((3, 3, 3, 1, in_channels))
        self.pw = Kernel((1, 1, 1, in_channels, features))
        self.norm = Norm(features, _gn_groups_for(features, gn_groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        y = conv3d_same(x, self.dw.kernel.to(x.dtype), self.stride, groups=c)
        y = y @ self.pw.kernel.to(x.dtype).view(c, -1)
        n = self.norm
        return group_norm(y, n.scale, n.bias, n.groups, relu=True)


class UpTranspose(nn.Module):
    """2× transpose conv (kernel 2, stride 2) → GroupNorm → ReLU."""

    def __init__(self, in_channels: int, features: int, gn_groups: int = 8):
        super().__init__()
        self.deconv = Kernel((2, 2, 2, in_channels, features))
        self.norm = Norm(features, _gn_groups_for(features, gn_groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # lax.conv_transpose (flax ConvTranspose, transpose_kernel=False)
        # puts kernel tap 1−δ at output offset δ on each axis; torch puts
        # tap δ there, hence the flip (`packed.py:644-656`)
        w = self.deconv.kernel.to(x.dtype).flip(0, 1, 2).permute(3, 4, 0, 1,
                                                                 2)
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w, stride=2)
        n = self.norm
        return group_norm(y.permute(0, 2, 3, 4, 1), n.scale, n.bias, n.groups,
                          relu=True)


# Factory signature: (in_channels, features, gn_groups) → module.
_FACTORIES = {
    "conv3": lambda ci, c, g: ConvNormAct(ci, c, 3, 1, 1, g),
    "dil_conv3": lambda ci, c, g: ConvNormAct(ci, c, 3, 1, 2, g),
    "sep_conv3": lambda ci, c, g: SepConv(ci, c, 1, g),
    "down_conv3": lambda ci, c, g: ConvNormAct(ci, c, 3, 2, 1, g),
    "down_dil_conv3": lambda ci, c, g: ConvNormAct(ci, c, 3, 2, 2, g),
    "down_sep_conv3": lambda ci, c, g: SepConv(ci, c, 2, g),
    "up_transpose": lambda ci, c, g: UpTranspose(ci, c, g),
}


def make_op(name: str, in_channels: int, features: int,
            gn_groups: int = 8) -> nn.Module:
    """Instantiate a candidate op by registry name."""
    if name in _FACTORIES:
        return _FACTORIES[name](in_channels, features, gn_groups)
    if name in (*NORMAL_OPS, *DOWN_OPS, *UP_OPS):
        raise NotImplementedError(f"op {name!r} is not ported yet")
    raise KeyError(f"unknown op {name!r}")
