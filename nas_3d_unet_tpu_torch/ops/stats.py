"""GroupNorm's two full-volume reductions: the counterpart of
`nas_3d_unet_tpu/ops/pallas/stats.py`.

Kernels (`csrc/stats.cu`), fp32 or bf16 inputs, each with its plain twin:

  K5a `moments(x)` → (Σx, Σx²): the statistics of a GroupNorm whose
      producer emits no moments (replaces `moments`);
  K5b `weighted_sums(g, x)` → (Σg, Σg·x): the reductions of every
      GroupNorm's backward (replaces `weighted_sums`);
      `weighted_sums(g, x, y)` counts g only where y > 0: the backward
      sums of K3 with its ReLU fused (replaces `groupnorm.py`
      `_grad_lane_sums`, whose unmasked form is K5b and whose forward
      twin `_lane_sums` is K5a).

Both sum over every axis but the first and the last and return (B, C)
fp32, reading the volume once.  The JAX package runs them on packed lanes
under `NAS3D_GN_STATS=pallas`; the port runs them on logical NDHWC
wherever a GroupNorm needs them.  The twins upcast to fp32 before they
multiply, as the reference's converting reduces do (`packed.py:768-769`,
`:837-839`).

They are CUDA C++, not Triton: one implementation route for all of the
port's kernels, and the build stays one `nvcc` call per source.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _cuda


def _dims(x: torch.Tensor):
    return tuple(range(1, x.dim() - 1))


def moments_twin(x: torch.Tensor):
    """Plain (Σx, Σx²) in fp32."""
    xf = x.float()
    return xf.sum(_dims(x)), (xf * xf).sum(_dims(x))


def weighted_sums_twin(g: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor | None = None):
    """Plain (Σg, Σg·x) in fp32; with y, g counts only where y > 0."""
    gf = g.float()
    if y is not None:
        gf = torch.where(y > 0, gf, 0.0)
    return gf.sum(_dims(g)), (gf * x.float()).sum(_dims(g))


def _launch(name: str, *ts: torch.Tensor):
    t = _cuda.check(name, *ts)
    x = ts[-1]
    b, c = x.shape[0], x.shape[-1]
    v = x.numel() // (b * c)
    nchunk = _cuda.lib().stats_chunks(b, v, c)
    partial = torch.empty((b, nchunk, 2, c), dtype=torch.float64,
                          device=x.device)
    out1 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    out2 = torch.empty_like(out1)
    _cuda.run(f"{name}_{t}", x.device, *(u.data_ptr() for u in ts),
              partial.data_ptr(), out1.data_ptr(), out2.data_ptr(), b, v, c)
    return out1, out2


def moments(x: torch.Tensor):
    """K5a: x (B, ..., C) → (Σx, Σx²), (B, C) fp32.  Not differentiable."""
    if x.dim() < 3:
        raise ValueError(f"moments: x {tuple(x.shape)}")
    if _cuda.dispatch("moments", x):
        return moments_twin(x)
    return _launch("moments", x)


def weighted_sums(g: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor | None = None):
    """K5b: g, x (B, ..., C) → (Σg, Σg·x), (B, C) fp32; with y (same
    shape), g counts only where y > 0 (`weighted_sums_masked`).  Not
    differentiable."""
    if x.dim() < 3 or g.shape != x.shape or (y is not None
                                             and y.shape != x.shape):
        raise ValueError(f"weighted_sums: g {tuple(g.shape)} "
                         f"x {tuple(x.shape)}")
    if y is None:
        if _cuda.dispatch("weighted_sums", g, x):
            return weighted_sums_twin(g, x)
        return _launch("weighted_sums", g, x)
    if _cuda.dispatch("weighted_sums_masked", g, x, y):
        return weighted_sums_twin(g, x, y)
    return _launch("weighted_sums_masked", g, x, y)
