"""GroupNorm(+ReLU) on NDHWC from raw moments, with the reference's
hand-written backward.

Counterpart of the JAX package's packed GroupNorm (`ops/packed.py`
`_gn_core`, :716-895): `gn_s` for producers whose kernel already emitted
Σy and Σy² (K1, K2), and `gn` for producers without them, whose moments
come from K5a (`ops/stats.py`).  The numerics follow the reference, not
`torch.nn.GroupNorm`: eps 1e-6, variance `E[x²] − mean²` from the raw
moments with no clamp, and the normalize as `x·a + b` with
`a = inv·γ`, `b = β − mean·inv·γ` computed in fp32 and cast to the
activation dtype first; in bf16 the product is rounded before the sum, as
the reference's two bf16 ops round it (`packed.py:794,875`).

The backward (`packed.py:806-859`) needs two reductions, Σdy and Σdy·x,
which K5b computes in one pass; everything else is (B, C) algebra and one
fused pass for `dx = dy·a + x·c2 + c1`, in fp32, rounded once to the input
dtype.  The ReLU mask is recomputed from the affine, so y is not kept.  The
moments' gradients are zero by contract (`packed.py:888-891`): the
backward through dy is already complete.
"""

from __future__ import annotations

import torch

from . import stats

EPS = 1e-6


def _by_channel(v: torch.Tensor, gsize: int) -> torch.Tensor:
    """(B, G) per-group values → (B, C)."""
    return v.repeat_interleave(gsize, dim=1)


def _fold(s1, s2, groups: int, n: int, eps: float):
    """Per-(batch, group) mean and inverse std from per-channel moments."""
    b = s1.shape[0]
    mean = s1.view(b, groups, -1).sum(-1) / n
    var = s2.view(b, groups, -1).sum(-1) / n - mean * mean
    return mean, torch.rsqrt(var + eps)


def _affine(x, mean, inv, scale, bias, gsize):
    """(a, b) in fp32 (B, C), broadcastable against x."""
    inv_c, mean_c = _by_channel(inv, gsize), _by_channel(mean, gsize)
    a = inv_c * scale
    b = bias - mean_c * inv_c * scale
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return a.view(shape), b.view(shape)


def _normalize(x, a, b):
    """x·a + b as the reference writes it: in bf16, a and b are cast to
    bf16 and the product is rounded to bf16 before the sum; in fp32, one
    fused pass."""
    if x.dtype == torch.float32:
        return torch.addcmul(b, x, a)
    return (x * a.to(x.dtype)).add_(b.to(x.dtype))


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, s1, s2, groups, relu, eps):
        c = x.shape[-1]
        gsize = c // groups
        n = (x.numel() // (x.shape[0] * c)) * gsize
        mean, inv = _fold(s1, s2, groups, n, eps)
        a, b = _affine(x, mean, inv, scale, bias, gsize)
        y = _normalize(x, a, b)
        if relu:
            y = y.relu_()
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.gsize, ctx.n, ctx.relu = gsize, n, relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, inv = ctx.saved_tensors
        gsize, n = ctx.gsize, ctx.n
        bsz = x.shape[0]
        dy = dy.contiguous()
        if ctx.relu:
            a0, b0 = _affine(x, mean, inv, scale, bias, gsize)
            dy = torch.where(_normalize(x, a0, b0) > 0, dy, 0)
        r1, r2 = stats.weighted_sums(dy, x)                  # K5b, (B, C)
        t1 = (scale * r1).view(bsz, -1, gsize).sum(-1)       # Σ γ·dy
        t2 = (scale * r2).view(bsz, -1, gsize).sum(-1)       # Σ γ·dy·x
        s_tx = inv * (t2 - mean * t1)                        # Σ γ·dy·x̂
        c2 = -(inv * inv) * s_tx / n
        c1 = -inv * t1 / n - c2 * mean
        shape = (bsz,) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        inv_c, mean_c = _by_channel(inv, gsize), _by_channel(mean, gsize)
        a = (inv_c * scale).view(shape)
        # one pass in fp32, rounded once: dy·a + x·c2 + c1
        dx = dy * a
        dx.addcmul_(x, _by_channel(c2, gsize).view(shape))
        dx += _by_channel(c1, gsize).view(shape)
        dgamma = (inv_c * (r2 - mean_c * r1)).sum(0)
        dbeta = r1.sum(0)
        return dx.to(x.dtype), dgamma, dbeta, None, None, None, None, None


def group_norm_from_moments(x: torch.Tensor, s1: torch.Tensor,
                            s2: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, groups: int, relu: bool,
                            eps: float = EPS) -> torch.Tensor:
    """x (B, ..., C) in fp32 or bf16; s1 = Σx, s2 = Σx² (B, C) fp32 over
    the voxels of each batch item.  Per-(batch, group) statistics over
    voxels and the group's channels.  The moments get no gradient."""
    return _GroupNorm.apply(x, scale, bias, s1, s2, groups, relu, eps)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, relu: bool, eps: float = EPS) -> torch.Tensor:
    """GroupNorm(+ReLU) for a producer that emits no moments: K5a takes
    them first."""
    x = x.contiguous()      # the kernels take dense NDHWC
    with torch.no_grad():
        s1, s2 = stats.moments(x)
    return group_norm_from_moments(x, s1, s2, scale, bias, groups, relu, eps)
