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

That backward is exact to first order although mean and inv are saved as
constants: the formula folds their share into c1 and c2 by hand.  A
second derivative (the second-order search step, which runs the backward
with `create_graph`) also needs dx's dependence on x through them, so
with grad mode on the backward rebuilds mean and inv from x through K5a's
autograd Function and writes dx from differentiable ops
(`_differentiable_backward`); the ReLU mask is the forward's.  Without a
graph the backward is the first-order one above, launch for launch and
bit for bit.

On a D-slab (`parallel/spatial.py`) both GroupNorms sum the forward's
moments and the backward's Σdy, Σdy·x over the spatial group before the
(B, C) algebra, with the global voxel count; dγ and dβ stay the slab's
own sums, which the step's gradient reduction adds up.

`pallas_group_norm` is the `use_pallas` path's GroupNorm (K3), the
counterpart of `nas_3d_unet_tpu/ops/pallas/groupnorm.py` `group_norm`
(:184): forward Σx, Σx² (K5a, or the producer's moments), the fold, and
`y = x·s + t` with `s = γ·rstd`, `t = β − s·mean` in fp32, rounded once
(`_gn_fwd`, :191-219); backward Σg, Σg·x (K5b, masked by y > 0 when the
ReLU is fused), the (B, C) algebra of `_gn_bwd` (:222-268) and one pass
`dx = A·g + B·x + C` in fp32, rounded once.  The cotangent is cast to x's
dtype first (:238).  Its two elementwise passes are kernels
(`csrc/groupnorm.cu`): `group_norm_apply` and `group_norm_dx`.  The
reference takes its lane-packed Pallas path only where C divides 128 and
its two-pass XLA reference elsewhere; the port takes every shape through
the one formula (variance `E[x²] − mean²`, eps 1e-6).
"""

from __future__ import annotations

import torch

from ..parallel import spatial
from . import _cuda, stats
from .stats import _bcast

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


def _count(x: torch.Tensor, gsize: int, slab) -> int:
    """Voxels × channels of one (batch item, group): over the global D on
    a slab."""
    n = (x.numel() // (x.shape[0] * x.shape[-1])) * gsize
    return n if slab is None else n * slab.size


def _global_sums(r1, r2, slab):
    """(Σ, Σ) (B, C) of the whole volume: on a slab, each slab's summed
    over the spatial group."""
    if slab is None:
        return r1, r2
    return tuple(spatial.all_reduce_sums((r1, r2), slab))


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, s1, s2, groups, relu, eps, slab):
        gsize = x.shape[-1] // groups
        n = _count(x, gsize, slab)
        mean, inv = _fold(s1, s2, groups, n, eps)
        a, b = _affine(x, mean, inv, scale, bias, gsize)
        y = _normalize(x, a, b)
        if relu:
            y = y.relu_()
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.gsize, ctx.n, ctx.relu, ctx.eps = gsize, n, relu, eps
        ctx.slab = slab
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, inv = ctx.saved_tensors
        gsize, n = ctx.gsize, ctx.n
        bsz = x.shape[0]
        dy = dy.contiguous()
        if ctx.relu:
            with torch.no_grad():   # the forward's mask, from its statistics
                a0, b0 = _affine(x, mean, inv, scale, bias, gsize)
                keep = _normalize(x, a0, b0) > 0
            dy = torch.where(keep, dy, 0)
        if torch.is_grad_enabled():     # create_graph: dx is differentiated
            if ctx.slab is not None:
                raise RuntimeError(
                    "a differentiated GroupNorm backward on a D-slab (the "
                    "second-order search under spatial sharding, ROADMAP.md "
                    "queue 1, item 9c)")
            return (*_differentiable_backward(dy, x, scale, gsize, n,
                                              ctx.eps),
                    None, None, None, None, None, None)
        r1, r2 = stats.weighted_sums(dy, x)                  # K5b, (B, C)
        # c1, c2 from the whole volume's sums; dγ, dβ from this slab's,
        # which the step's gradient reduction sums over the group
        c1, c2, inv_c, _ = _dx_terms(*_global_sums(r1, r2, ctx.slab), scale,
                                     mean, inv, gsize, n)
        dgamma = _dgamma(r1, r2, mean, inv, gsize)
        shape = (bsz,) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        # one pass in fp32, rounded once: dy·a + x·c2 + c1
        dx = dy * (inv_c * scale).view(shape)
        dx.addcmul_(x, c2.view(shape))
        dx += c1.view(shape)
        return (dx.to(x.dtype), dgamma, r1.sum(0), None, None, None, None,
                None, None)


def _dgamma(r1, r2, mean, inv, gsize: int):
    """dγ from Σdy, Σdy·x: Σ over the batch of inv·(Σdy·x − mean·Σdy)."""
    inv_c, mean_c = _by_channel(inv, gsize), _by_channel(mean, gsize)
    return (inv_c * (r2 - mean_c * r1)).sum(0)


def _dx_terms(r1, r2, scale, mean, inv, gsize: int, n: int):
    """The backward's (B, C) algebra from K5b's Σdy, Σdy·x: c1 and c2 by
    channel (dx = dy·inv·γ + x·c2 + c1), inv by channel, and dγ."""
    bsz = r1.shape[0]
    t1 = (scale * r1).view(bsz, -1, gsize).sum(-1)           # Σ γ·dy
    t2 = (scale * r2).view(bsz, -1, gsize).sum(-1)           # Σ γ·dy·x
    s_tx = inv * (t2 - mean * t1)                            # Σ γ·dy·x̂
    c2 = -(inv * inv) * s_tx / n
    c1 = -inv * t1 / n - c2 * mean
    return (_by_channel(c1, gsize), _by_channel(c2, gsize),
            _by_channel(inv, gsize), _dgamma(r1, r2, mean, inv, gsize))


def _grad_statistics(x, groups: int, n: int, eps: float):
    """Per-(batch, group) mean and inverse std of x as differentiable
    functions of x: K5a's moments through its autograd Function."""
    return _fold(*stats.moments(x), groups, n, eps)


def _differentiable_backward(dy, x, scale, gsize: int, n: int, eps: float):
    """(dx, dγ, dβ) of the GroupNorm from differentiable ops: the
    first-order formula with mean and inv rebuilt from x
    (`_grad_statistics`) and K5b through its Function, so that autograd
    also sees dx's dependence on x through the statistics.  dy is masked
    already."""
    mean, inv = _grad_statistics(x, x.shape[-1] // gsize, n, eps)
    r1, r2 = stats.weighted_sums(dy, x)                      # K5b, (B, C)
    c1, c2, inv_c, dgamma = _dx_terms(r1, r2, scale, mean, inv, gsize, n)
    dx = dy * _bcast(inv_c * scale, x) + x * _bcast(c2, x) + _bcast(c1, x)
    return dx.to(x.dtype), dgamma, r1.sum(0)


def group_norm_from_moments(x: torch.Tensor, s1: torch.Tensor,
                            s2: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, groups: int, relu: bool,
                            eps: float = EPS) -> torch.Tensor:
    """x (B, ..., C) in fp32 or bf16; s1 = Σx, s2 = Σx² (B, C) fp32 over
    the voxels of each batch item.  Per-(batch, group) statistics over
    voxels and the group's channels.  The moments get no gradient.  On a
    D-slab (`parallel/spatial.py`) x and the moments are the slab's: the
    moments are summed over the spatial group before the fold, and the
    backward's Σdy, Σdy·x too."""
    slab = spatial.current()
    s1, s2 = _global_sums(s1, s2, slab)
    return _GroupNorm.apply(x, scale, bias, s1, s2, groups, relu, eps, slab)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, relu: bool, eps: float = EPS) -> torch.Tensor:
    """GroupNorm(+ReLU) for a producer that emits no moments: K5a takes
    them first."""
    x = x.contiguous()      # the kernels take dense NDHWC
    with torch.no_grad():
        s1, s2 = stats.moments(x)
    return group_norm_from_moments(x, s1, s2, scale, bias, groups, relu, eps)


# ---------------------------------------------------------------------------
# K3: the use_pallas GroupNorm (+ReLU), one rounding, hand-written backward
# ---------------------------------------------------------------------------


def _vec_ok(c: int, *ts: torch.Tensor) -> int:
    """1 when the 8-wide kernel variant applies: C % 8 == 0 and every
    tensor 16-byte aligned."""
    return int(c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def group_norm_apply_twin(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                          relu: bool) -> torch.Tensor:
    """Plain K3 apply: `x·s + t` in fp32 per (batch, channel), optional
    ReLU, rounded once to x's dtype."""
    y = torch.addcmul(_bcast(t, x), x.float(), _bcast(s, x))
    return (y.relu_() if relu else y).to(x.dtype)


def group_norm_apply(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                     relu: bool) -> torch.Tensor:
    """K3 apply: x (B, ..., C) contiguous, s, t (B, C) fp32 → y in x's
    dtype.  Not differentiable (the K3 Function's forward)."""
    if _cuda.dispatch("group_norm_apply", x):
        return group_norm_apply_twin(x, s, t, relu)
    t_ = _cuda.check("group_norm_apply", x)
    b, c = x.shape[0], x.shape[-1]
    s, t = s.contiguous(), t.contiguous()
    y = torch.empty_like(x)
    _cuda.run(f"group_norm_apply_{t_}", x.device, x.data_ptr(), s.data_ptr(),
              t.data_ptr(), y.data_ptr(), b, x.numel() // (b * c), c,
              int(relu), _vec_ok(c, x, y, s, t))
    return y


def group_norm_dx_twin(g: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor | None, a: torch.Tensor,
                       bc: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    """Plain K3 dx: `a·g + b·x + c` in fp32 (g masked by y > 0 when y is
    given), rounded once to x's dtype."""
    gf = g.float()
    if y is not None:
        gf = torch.where(y > 0, gf, 0.0)
    dx = _bcast(a, x) * gf + _bcast(bc, x) * x.float() + _bcast(cc, x)
    return dx.to(x.dtype)


def group_norm_dx(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor | None,
                  a: torch.Tensor, bc: torch.Tensor,
                  cc: torch.Tensor) -> torch.Tensor:
    """K3 dx: g, x (and y, whose `y > 0` masks g when the ReLU was fused)
    (B, ..., C) contiguous in one dtype, a, b, c (B, C) fp32 → dx in x's
    dtype."""
    ts = (g, x) if y is None else (g, x, y)
    if _cuda.dispatch("group_norm_dx", *ts):
        return group_norm_dx_twin(g, x, y, a, bc, cc)
    t_ = _cuda.check("group_norm_dx", *ts)
    b, c = x.shape[0], x.shape[-1]
    a, bc, cc = (v.contiguous() for v in (a, bc, cc))
    dx = torch.empty_like(x)
    _cuda.run(f"group_norm_dx_{t_}", x.device, g.data_ptr(), x.data_ptr(),
              _cuda.ptr(y), a.data_ptr(), bc.data_ptr(), cc.data_ptr(),
              dx.data_ptr(), b, x.numel() // (b * c), c, int(y is not None),
              _vec_ok(c, *ts, dx, a, bc, cc))
    return dx


def _k3_affine(mean, rstd, scale, bias, gsize):
    """(s, t) (B, C) fp32: s = γ·rstd, t = β − s·mean (`_gn_fwd`)."""
    s = scale.float() * _by_channel(rstd, gsize)
    return s, bias.float() - s * _by_channel(mean, gsize)


class _PallasGroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, s1, s2, groups, relu, eps, slab):
        gsize = x.shape[-1] // groups
        n = _count(x, gsize, slab)
        mean, rstd = _fold(s1, s2, groups, n, eps)
        y = group_norm_apply(x, *_k3_affine(mean, rstd, scale, bias, gsize),
                             relu)
        ctx.save_for_backward(x, scale, mean, rstd, y if relu else None)
        ctx.gsize, ctx.n, ctx.slab = gsize, n, slab
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rstd, y = ctx.saved_tensors
        gsize, n = ctx.gsize, ctx.n
        bsz = x.shape[0]
        g = g.to(x.dtype).contiguous()
        r1, r2 = stats.weighted_sums(g, x, y)        # Σg, Σg·x (B, C)
        mean_c, rstd_c = _by_channel(mean, gsize), _by_channel(rstd, gsize)
        # dγ, dβ from this slab's sums (the step sums them over the
        # group), the dx terms from the whole volume's
        dgamma = ((r2 - mean_c * r1) * rstd_c).sum(0)
        dbeta = r1.sum(0)
        r1, r2 = _global_sums(r1, r2, ctx.slab)
        # ĝ = γ·g:  dx = rstd·(ĝ − S1/n − x̂·S2/n), S1 = Σ ĝ over the group,
        # S2 = Σ ĝ·x̂ = (Σ ĝ·x − mean·S1)·rstd  (`_gn_bwd`)
        gamma = scale.float()
        t1 = (gamma * r1).view(bsz, -1, gsize).sum(-1)
        t2 = (gamma * r2).view(bsz, -1, gsize).sum(-1)
        t2 = (t2 - mean * t1) * rstd
        s1n, s2n = _by_channel(t1 / n, gsize), _by_channel(t2 / n, gsize)
        a = gamma * rstd_c
        bc = -rstd_c * rstd_c * s2n
        cc = -rstd_c * s1n + rstd_c * rstd_c * mean_c * s2n
        dx = group_norm_dx(g, x, y, a, bc, cc)
        return (dx, dgamma.to(scale.dtype), dbeta.to(scale.dtype), None,
                None, None, None, None, None)


def pallas_group_norm(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, groups: int, relu: bool = False,
                      eps: float = EPS,
                      moments: tuple | None = None) -> torch.Tensor:
    """K3: GroupNorm(+ReLU) of x (B, ..., C) in fp32 or bf16, y in x's
    dtype.  `moments` = (Σx, Σx²) (B, C) fp32 when the producer emitted
    them (K1, K2), else K5a takes them.  Differentiable in x, scale and
    bias; the moments get no gradient.  On a D-slab the sums are summed
    over the spatial group, as `group_norm_from_moments`'s are."""
    x = x.contiguous()      # the kernels take dense NDHWC
    if moments is None:
        with torch.no_grad():
            moments = stats.moments(x)
    slab = spatial.current()
    return _PallasGroupNorm.apply(x, scale, bias,
                                  *_global_sums(*moments, slab), groups,
                                  relu, eps, slab)


def pallas_group_norm_twin(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, groups: int,
                           relu: bool = False, eps: float = EPS,
                           moments: tuple | None = None) -> torch.Tensor:
    """Plain PyTorch K3 with autograd throughout: the moments (the given
    ones, or the twin's of x, differentiable either way), the same fold,
    the apply twin."""
    c = x.shape[-1]
    gsize = c // groups
    n = (x.numel() // (x.shape[0] * c)) * gsize
    mean, rstd = _fold(*(moments or stats.moments_twin(x)), groups, n, eps)
    return group_norm_apply_twin(x, *_k3_affine(mean, rstd, scale, bias,
                                                gsize), relu)
