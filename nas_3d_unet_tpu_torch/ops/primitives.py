"""Candidate ops of the NAS edges, in PyTorch on NDHWC tensors.

Counterpart of `nas_3d_unet_tpu/ops/primitives.py`: every candidate op of
`NORMAL_OPS`, `DOWN_OPS` and `UP_OPS`, and the norms "group", "instance"
(GroupNorm with one group a channel, on the same routes) and "none" (no
norm, the ReLU still applied).  Parameters keep flax's names and shapes (`kernel` in
DHWIO, depthwise `(3, 3, 3, 1, C)`, GroupNorm `scale`/`bias`), so a flax
tree maps onto `state_dict()` by renaming "/" to "." (see `bridge.py`).

Which path each conv takes mirrors where the JAX package runs Pallas.
By default (`use_pallas=False`, the reference's shipped `packed=True`
path, `ConvNormAct` → `conv_stats_fused_viable`, `ops/packed.py:356`):
  * stride-1 3³ `ConvNormAct` → K1 `pgemm.conv3x3x3_stats` (conv + moments);
  * stride-1 1³ `ConvNormAct` → K2 `pgemm.gemm_stats`;
  * `SepConv`'s depthwise 3³ conv → `depthwise.depthwise3`, the port's
    own kernels (`csrc/depthwise.cu`) on every path, where the JAX package
    leaves it to XLA;
  * everything else (stride-2 convs, the pointwise conv of `SepConv`, the
    k2s2 transpose conv) is plain PyTorch with autograd (cuDNN / cuBLAS),
    as the JAX package leaves it to XLA, followed by GroupNorm from K5a's
    moments (`ops/stats.py`).
With `use_pallas=True` (the reference's `packed=False, use_pallas=True`,
`primitives.py:277,331,452`), the edge ops take the `ops/conv3d.py`
kernels and every GroupNorm is K3 (`groupnorm.pallas_group_norm`: one
rounding, ReLU fused):
  * 3³ `ConvNormAct` (stride 1 or 2) → K6 `conv3d` → K3;
  * `SepConv` → `depthwise3` → K7 `pointwise_conv` → K3;
  * `UpTranspose` → K4 `conv_transpose2x` → K3;
  * the stem and the cells' 1³ projections, which the reference builds
    without `use_pallas` (`unet.py:73-75`, `cell.py:271-274`), keep K1 / K2
    / cuDNN (`pallas_conv=False`) with K3's one-rounding GroupNorm on their
    moments, as flax's `nn.GroupNorm` rounds once.
The op order is conv → GroupNorm → ReLU throughout.  The parameter-free
ops (`Zero`, `Identity`, `Pool`) are plain PyTorch on every path, as the
reference leaves them to XLA (`ops/pool.py`).

Precision, as flax's `dtype` / `param_dtype`: parameters stay fp32 and each
op casts its kernel to the activations' dtype (fp32 or bf16) before use;
GroupNorm's statistics and affine are fp32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..parallel import spatial
from . import conv3d as pconv
from . import depthwise, groupnorm, pgemm, pool
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

NORMS = ("group", "instance", "none")


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


def make_norm(kind: str, channels: int, gn_groups: int,
              use_pallas: bool = False) -> Norm | None:
    """The norm of an op (`primitives.py:100 _norm`): GroupNorm with
    `gn_groups` groups ("group", fewer where they do not divide the
    channels), one group a channel ("instance"), or None ("none": the op
    applies its ReLU alone, and has no `norm` parameters)."""
    if kind == "group":
        return Norm(channels, _gn_groups_for(channels, gn_groups), use_pallas)
    if kind == "instance":
        return Norm(channels, channels, use_pallas)
    if kind == "none":
        return None
    raise ValueError(f"unknown norm {kind!r}")


def _norm_relu(norm: Norm | None, y: torch.Tensor,
               moments=None) -> torch.Tensor:
    """The op's norm and ReLU; without a norm, the ReLU alone."""
    return y.relu() if norm is None else norm(y, moments)


class ConvNormAct(nn.Module):
    """conv3d (kernel 1 or 3, stride 1 or 2, dilation 1 or 2) → norm →
    ReLU.  `use_pallas`: K3 GroupNorm, and the 3³ conv on K6 unless
    `pallas_conv` is False (the stem and the cells' projections)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, gn_groups: int = 8,
                 use_pallas: bool = False, pallas_conv: bool = True,
                 norm: str = "group"):
        super().__init__()
        if kernel not in (1, 3) or stride not in (1, 2) \
                or dilation not in (1, 2):
            raise ValueError(f"ConvNormAct: kernel {kernel} stride {stride} "
                             f"dilation {dilation}")
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.k6 = use_pallas and pallas_conv and kernel == 3
        self.conv = Kernel((kernel,) * 3 + (in_channels, features))
        self.norm = make_norm(norm, features, gn_groups, use_pallas)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.kernel.to(x.dtype)
        if self.k6:
            return _norm_relu(self.norm, pconv.conv3d(x, w, None, self.stride,
                                                      self.dilation))
        if self.stride == 2:
            return _norm_relu(self.norm, conv3d_same(x, w, self.stride,
                                                     self.dilation))
        x = x.contiguous()
        if self.kernel == 3 and spatial.current() is not None:
            y, s1, s2 = pgemm.conv3x3x3_stats_slab(x, w, self.dilation)
        elif self.kernel == 3:
            y, s1, s2 = pgemm.conv3x3x3_stats(x, w, self.dilation)
        else:
            b, cin = x.shape[0], x.shape[-1]
            y, s1, s2 = pgemm.gemm_stats(x.view(b, -1, cin), w.view(cin, -1))
            y = y.view(*x.shape[:-1], -1)
        return _norm_relu(self.norm, y, (s1, s2))


class SepConv(nn.Module):
    """Depthwise 3³ conv (stride 1 or 2; `depthwise.depthwise3`) →
    pointwise 1³ conv → norm → ReLU.  `use_pallas`: K7 pointwise conv and
    K3 GroupNorm."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 gn_groups: int = 8, use_pallas: bool = False,
                 norm: str = "group"):
        super().__init__()
        self.stride = stride
        self.use_pallas = use_pallas
        self.dw = Kernel((3, 3, 3, 1, in_channels))
        self.pw = Kernel((1, 1, 1, in_channels, features))
        self.norm = make_norm(norm, features, gn_groups, use_pallas)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        y = depthwise.depthwise3(x, self.dw.kernel.to(x.dtype), self.stride)
        pw = self.pw.kernel.to(x.dtype).view(c, -1)
        if self.use_pallas:
            return _norm_relu(self.norm, pconv.pointwise_conv(y, pw))
        return _norm_relu(self.norm, y @ pw)


class UpTranspose(nn.Module):
    """2× transpose conv (kernel 2, stride 2) → norm → ReLU.
    `use_pallas`: K4 transpose conv and K3 GroupNorm."""

    def __init__(self, in_channels: int, features: int, gn_groups: int = 8,
                 use_pallas: bool = False, norm: str = "group"):
        super().__init__()
        self.use_pallas = use_pallas
        self.deconv = Kernel((2, 2, 2, in_channels, features))
        self.norm = make_norm(norm, features, gn_groups, use_pallas)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.deconv.kernel.to(x.dtype)
        if self.use_pallas:
            return _norm_relu(self.norm, pconv.conv_transpose2x(x, w))
        return _norm_relu(self.norm, pconv.conv_transpose2x_twin(x, w))


class UpSampleConv(nn.Module):
    """Trilinear 2× upsample (`ops/pool.py`), then a stride-1 3³
    `ConvNormAct` or a `SepConv`, named as flax auto-names the one child
    (`ConvNormAct_0` / `SepConv_0`)."""

    def __init__(self, in_channels: int, features: int,
                 separable: bool = False, gn_groups: int = 8,
                 use_pallas: bool = False, norm: str = "group"):
        super().__init__()
        if separable:
            self.SepConv_0 = SepConv(in_channels, features, 1, gn_groups,
                                     use_pallas, norm)
        else:
            self.ConvNormAct_0 = ConvNormAct(in_channels, features, 3, 1, 1,
                                             gn_groups, use_pallas,
                                             norm=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (op,) = self.children()
        return op(pool.upsample2x(x))


class Zero(nn.Module):
    """The `none` op: zeros shaped like x (stride 1) or like
    `x[:, ::2, ::2, ::2]` (stride 2)."""

    def __init__(self, stride: int = 1):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        if s == 1:
            return torch.zeros_like(x)
        return x.new_zeros((x.shape[0], *(-(-n // s) for n in x.shape[1:4]),
                            x.shape[4]))


class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Pool(nn.Module):
    """3³ avg or max pool, SAME, stride 1 (normal) or 2 (down)."""

    def __init__(self, kind: str, stride: int = 1):
        super().__init__()
        if kind not in ("avg", "max"):
            raise ValueError(f"Pool: kind {kind!r}")
        self.kind, self.stride = kind, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "avg":
            return pool.avg_pool3(x, self.stride)
        return pool.max_pool3(x, self.stride)


# Factory signature: (in_channels, features, gn_groups, use_pallas, norm)
# → module.  The parameter-free ops keep their input's channels.
_FACTORIES = {
    # normal (stride 1)
    "none": lambda ci, c, g, up, n: Zero(1),
    "identity": lambda ci, c, g, up, n: Identity(),
    "conv3": lambda ci, c, g, up, n: ConvNormAct(ci, c, 3, 1, 1, g, up,
                                                 norm=n),
    "dil_conv3": lambda ci, c, g, up, n: ConvNormAct(ci, c, 3, 1, 2, g, up,
                                                     norm=n),
    "sep_conv3": lambda ci, c, g, up, n: SepConv(ci, c, 1, g, up, n),
    "avg_pool3": lambda ci, c, g, up, n: Pool("avg", 1),
    "max_pool3": lambda ci, c, g, up, n: Pool("max", 1),
    # down (stride 2)
    "down_avg_pool": lambda ci, c, g, up, n: Pool("avg", 2),
    "down_max_pool": lambda ci, c, g, up, n: Pool("max", 2),
    "down_conv3": lambda ci, c, g, up, n: ConvNormAct(ci, c, 3, 2, 1, g, up,
                                                      norm=n),
    "down_dil_conv3": lambda ci, c, g, up, n: ConvNormAct(ci, c, 3, 2, 2, g,
                                                          up, norm=n),
    "down_sep_conv3": lambda ci, c, g, up, n: SepConv(ci, c, 2, g, up, n),
    # up (2×)
    "up_transpose": lambda ci, c, g, up, n: UpTranspose(ci, c, g, up, n),
    "up_conv3": lambda ci, c, g, up, n: UpSampleConv(ci, c, False, g, up, n),
    "up_sep_conv3": lambda ci, c, g, up, n: UpSampleConv(ci, c, True, g, up,
                                                         n),
}


def make_op(name: str, in_channels: int, features: int,
            gn_groups: int = 8, use_pallas: bool = False,
            norm: str = "group") -> nn.Module:
    """Instantiate a candidate op by registry name."""
    if name not in _FACTORIES:
        raise KeyError(f"unknown op {name!r}")
    return _FACTORIES[name](in_channels, features, gn_groups, use_pallas,
                            norm)
