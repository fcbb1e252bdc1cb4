"""3³ max and average pools (SAME, stride 1 or 2) and the trilinear 2×
upsample, on NDHWC tensors.

Counterpart of `nas_3d_unet_tpu/ops/primitives.py` `Pool` (:403) and of the
front half of `UpSampleConv` (:474).  The reference runs these in XLA, so
they are plain PyTorch here: no kernel of the port replaces them.

Max pool: the reference's shifted maxima (`ops/packed.py:986 _axis_max3`,
`:1007 max_pool3_shifted`), not a `reduce_window`: per axis, D then H then
W, pad with −inf by lax's SAME pads (the odd pad on the high side at stride
2) and take `maximum(maximum(p0, p1), p2)` of the three strided slices.
`torch.maximum`'s gradient splits a tie 0.5 / 0.5 as `lax.max`'s does,
where `F.max_pool3d` routes it to the first maximum; ties are common on
post-ReLU zero plateaus (`PARITY.md` §2b).  The pool is recomputed in the
backward (`torch.utils.checkpoint`, non-reentrant: a second derivative
goes through it), as the reference's `jax.checkpoint` does: the chain would otherwise keep every padded slice and partial
maximum, ~4 full-size buffers a pool.  The shipped packed path
(`packed.py:1097 packed_max_pool3`) takes W first, then D, then H: the
same forward, another split of tied gradients (`ROADMAP.md` queue 3).

Average pool: `count_include_pad=False` with the same asymmetric pads, so
a window's divisor is its count of in-bounds taps, the outer product of
the per-axis counts.  The sum runs in fp32 (W, then D, then H) and is
rounded once to the input's dtype after the division, as the shipped
packed path (`packed.py:1025 packed_avg_pool3`) does; the unpacked flax
pool sums bf16 in bf16 first (`primitives.py:424-431`), which the port
does not follow.  float64 input stays float64 (for the tests that hold
exact math in float64); fp32 and bf16 sum in fp32.

Upsample: `F.interpolate(..., mode="trilinear", align_corners=False)` on
the NCDHW view, which is `jax.image.resize`'s half-pixel trilinear with
clamped edges; it runs in fp32 and is rounded once, as `packed.py:1176
packed_resize2x` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .conv3d import same_pad
from .stats import _acc


def _shifted(x: torch.Tensor, axis: int, stride: int, fill: float):
    """The three strided slices of x padded along `axis` with `fill` by
    lax's SAME pads of a 3-wide window: slice o holds tap o of every
    output's window."""
    n = x.shape[axis]
    lo, hi = same_pad(n, 3, stride, 1)
    out = -(-n // stride)
    pads = [0, 0] * (x.dim() - 1 - axis) + [lo, hi]
    xp = F.pad(x, pads, value=fill)
    return [xp.narrow(axis, o, stride * (out - 1) + 1)[
        (slice(None),) * axis + (slice(None, None, stride),)]
        for o in range(3)]


def _max_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    for axis in (1, 2, 3):
        p0, p1, p2 = _shifted(x, axis, stride, float("-inf"))
        x = torch.maximum(torch.maximum(p0, p1), p2)
    return x


def max_pool3(x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """3³ SAME max pool of NDHWC x, stride 1 or 2, in x's dtype (a maximum
    never rounds); recomputed in the backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(_max_pool, x, stride, use_reentrant=False,
                          preserve_rng_state=False)
    return _max_pool(x, stride)


def _counts(n: int, stride: int) -> list:
    """In-bounds taps of each output's 3-wide SAME window along an axis."""
    lo, _ = same_pad(n, 3, stride, 1)
    return [sum(0 <= o * stride - lo + k < n for k in range(3))
            for o in range(-(-n // stride))]


def avg_pool3(x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """3³ SAME average pool of NDHWC x, stride 1 or 2, without counting
    the pad: fp32 sums, one division, rounded once to x's dtype."""
    dims = x.shape[1:4]
    s = _acc(x)
    for axis in (3, 1, 2):
        p0, p1, p2 = _shifted(s, axis, stride, 0.0)
        s = p0 + p1 + p2
    cd, ch, cw = (torch.tensor(_counts(n, stride), dtype=s.dtype,
                               device=x.device) for n in dims)
    div = cd.view(-1, 1, 1, 1) * ch.view(1, -1, 1, 1) * cw.view(1, 1, -1, 1)
    return (s / div).to(x.dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Trilinear 2× upsample of NDHWC x (half-pixel, edges clamped), in
    fp32, rounded once to x's dtype; NDHWC contiguous."""
    y = F.interpolate(_acc(x).permute(0, 4, 1, 2, 3), scale_factor=2,
                      mode="trilinear", align_corners=False)
    return y.to(x.dtype).permute(0, 2, 3, 4, 1).contiguous()
