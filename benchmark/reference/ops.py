"""The plain reference's operations: fp32 PyTorch on NCDHW tensors.

Written from the model's description (DARTS' candidate ops in 3D, lax's
SAME padding, GroupNorm with eps 1e-6, half-pixel trilinear upsampling)
and imports nothing of the program under test.  Convolutions and matmuls
take their operands through `Precision.operand`, which is the identity in
the reference and, in a control, rounds them one precision down: to
TF32's 10-bit mantissa (`TF32`) or to scaled fp8 (`FP8`), as a GEMM in
that precision takes its inputs, accumulating in fp32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's and cuBLAS's TF32 switches set to `enabled` for the block,
    restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class Precision:
    """fp32: operands as they are."""

    name = "fp32"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t


class _ScaledRound(torch.autograd.Function):
    """t rounded to fp8 e4m3 with one scale a tensor (its absolute maximum
    onto the format's largest value); the gradient rounded to e5m2 the
    same way, as fp8 training rounds its backward."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class ScaledFP8(Precision):
    """The control: every conv and matmul operand in scaled fp8."""

    name = "fp8"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return _ScaledRound.apply(t)


class _TF32Round(torch.autograd.Function):
    """fp32 rounded to the nearest TF32 value (10 mantissa bits, ties to
    even), forward and backward."""

    @staticmethod
    def forward(ctx, t):
        return _tf32(t)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32).to(t.dtype)


class RoundedTF32(Precision):
    """The control of an fp32 configuration: operands in TF32, as the
    tensor cores' TF32 mode rounds them."""

    name = "tf32"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return _TF32Round.apply(t)


FP32 = Precision()
FP8 = ScaledFP8()
TF32 = RoundedTF32()


def same_pad(n: int, k: int, stride: int, dilation: int) -> tuple:
    """lax's SAME padding (lo, hi) of one axis of n planes: the odd plane
    of the total goes on the high side."""
    out = -(-n // stride)
    total = max(0, (out - 1) * stride + dilation * (k - 1) + 1 - n)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, stride: int, dilation: int) -> list:
    """F.pad's list (W, H, D pairs) of SAME pads for NCDHW x."""
    out = []
    for n in reversed(x.shape[2:]):
        out += same_pad(n, k, stride, dilation)
    return out


def conv(x, w, prec: Precision, stride=1, dilation=1, groups=1):
    """SAME 3D convolution of NCDHW x with a DHWIO kernel w (I = Cin /
    groups), no bias."""
    k = w.shape[0]
    x = F.pad(x, _pads(x, k, stride, dilation))
    wt = w.permute(4, 3, 0, 1, 2)
    return F.conv3d(prec.operand(x), prec.operand(wt), stride=stride,
                    dilation=dilation, groups=groups)


def conv_transpose2x(x, w, prec: Precision):
    """The k2 s2 transposed convolution with a DHWIO (2, 2, 2, Cin, Cout)
    kernel in lax's convention: output offset δ of input voxel i takes
    tap 1 − δ on each axis."""
    wt = w.flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    return F.conv_transpose3d(prec.operand(x), prec.operand(wt), stride=2)


def group_norm_relu(x, scale, bias, groups: int):
    """GroupNorm (biased variance, eps 1e-6) with per-channel scale and
    bias, then ReLU."""
    return F.relu(F.group_norm(x, groups, scale, bias, eps=1e-6))


def gn_groups(channels: int, groups: int) -> int:
    """The largest count ≤ `groups` that divides `channels`."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def _shifted(x, axis: int, stride: int, fill: float):
    """The three taps of a 3-wide SAME window along `axis`, strided."""
    n = x.shape[axis]
    out = -(-n // stride)
    lo, hi = same_pad(n, 3, stride, 1)
    pad = [0, 0] * (x.dim() - 1 - axis) + [lo, hi]
    xp = F.pad(x, pad, value=fill)
    idx = [slice(None)] * x.dim()
    taps = []
    for o in range(3):
        idx[axis] = slice(o, o + stride * (out - 1) + 1, stride)
        taps.append(xp[tuple(idx)])
    return taps


def max_pool3(x, stride: int):
    """3³ SAME max pool as three axis maxima (D, H, W), each the maximum
    of the window's three taps in order: a tie splits its gradient evenly
    between the two sides of each maximum, as lax.max's does."""
    for axis in (2, 3, 4):
        a, b, c = _shifted(x, axis, stride, float("-inf"))
        x = torch.maximum(torch.maximum(a, b), c)
    return x


def avg_pool3(x, stride: int):
    """3³ SAME average pool; the divisor counts the window's taps inside
    the volume."""
    s, ones = x, torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype,
                            device=x.device)
    for axis in (2, 3, 4):
        a, b, c = _shifted(s, axis, stride, 0.0)
        s = a + b + c
        a, b, c = _shifted(ones, axis, stride, 0.0)
        ones = a + b + c
    return s / ones


def upsample2x(x):
    """Half-pixel trilinear 2× upsample with clamped edges."""
    return F.interpolate(x, scale_factor=2, mode="trilinear",
                         align_corners=False)
