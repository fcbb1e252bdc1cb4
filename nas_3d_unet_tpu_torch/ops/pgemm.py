"""Conv / GEMM with GroupNorm raw moments: the counterpart of
`nas_3d_unet_tpu/ops/pallas/pgemm.py` and of the custom VJPs around it
(`ops/packed.py` `_pg_stats_fn`, `_gemm_stats_fn`).

Kernels (`csrc/pgemm.cu`), each in fp32 or bf16 with fp32 accumulation,
each with its plain PyTorch twin.  fp32 (serving) runs on the FMA units,
bf16 (training) on the tensor cores:

  K1 `conv3x3x3_stats(x, w, dilation)`: stride-1 3³ SAME conv on NDHWC with
     a DHWIO kernel plus the moments (replaces `conv_pgemm`); fp32 on the
     FMA conv tile with its moments epilogue (`csrc/conv_fma.cuh`, plan and
     algorithm mirrored by `ops/conv_fma.py`), bf16 on the tensor-core conv
     with its moments epilogue (`csrc/conv_mma.cuh`, `ops/conv_mma.py`);
  K1-dx `conv3x3x3(x, w, dilation)`: the same conv without the moments,
     which K1's backward runs for dx (`conv_pgemm(..., with_stats=False)`);
     on the same two conv tiles;
  K2 `gemm_stats(x3, w)`: `y = x3 @ w` over voxel rows, the 1³ conv, plus
     the moments (replaces `gemm_stats`); fp32 on the voxel-row FMA tile
     with its per-tile moments (`csrc/gemm_fma.cuh`, plan and algorithm
     mirrored by `ops/gemm_fma.py`), bf16 on the tensor-core GEMM
     (`csrc/gemm_mma.cuh`, mirrored by `ops/gemm_mma.py`).

K1 and K2 return `(y, s1, s2)`: y in the input's dtype, `s1 = Σy` and
`s2 = Σy²` per (batch, channel) over all voxels in fp32, taken of the
rounded y.  Each kernel writes per-block partial sums in a fixed order
(`(B, blocks, 2, C)`, sized from the library's own plan of the launch), and
one more kernel folds them in double: no atomics, the same bits on every
launch.  The JAX kernels work on the W-packed layout and return packed
moments `(B, r·C)`; these take logical tensors and return the moments
already folded to `(B, C)`.

Gradients (autograd Functions, as the reference's custom VJPs):
  K1: dx = K1-dx on dy with the flip-transposed kernel
      `w.flip(0, 1, 2).transpose(3, 4)` at the same dilation, skipped when x
      needs no gradient (the stem); dW is the plain weight gradient of the
      conv (cuDNN), as the reference leaves it to XLA.  When the backward
      runs with `create_graph` (the second-order search step), K1-dx runs
      as a Function of its own (`_Conv3x3x3`: its backward is K1-dx with
      the other flip, and the weight gradient) and dW is cuDNN's weight
      gradient recorded by autograd, so both can be differentiated.
      Without a graph the backward is the first-order one, launch for
      launch.
  K2: dx = dy @ wᵀ and dW = Σ x3ᵀ dy, plain matmuls, which autograd
      differentiates again.
  The moments' cotangents are dropped by contract (`packed.py:410-413`):
  s1 and s2 are non-differentiable outputs.  Their consumer, the GroupNorm
  Function of `ops/groupnorm.py`, returns the complete gradient through y.

On a D-slab (`parallel/spatial.py`) a ConvNormAct's K1 runs as K1-dx's
kernel on x with its halo, cropped, with K5a's moments of the crop
(`conv3x3x3_stats_slab`); K2 needs no halo, and the GroupNorm sums both
producers' moments over the spatial group.

Dispatch: a CPU tensor takes the twin (the Functions then run the twin
forward and the twin conv for dx); a CUDA tensor launches the kernel or
raises (a shape a conv tile refuses raises too: it goes to no other
kernel).  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..parallel import spatial
from . import _cuda, stats
from .stats import moments_twin

# ---------------------------------------------------------------------------
# K1: stride-1 3³ conv (+ moments)
# ---------------------------------------------------------------------------


def conv3x3x3_twin(x: torch.Tensor, w: torch.Tensor, dilation: int = 1):
    """Plain PyTorch K1-dx: explicit SAME pad (= dilation per side at
    stride 1, `packed.py:123-128`), then `F.conv3d`; y in x's dtype."""
    p = dilation
    xt = F.pad(x.permute(0, 4, 1, 2, 3), (p, p, p, p, p, p))
    y = F.conv3d(xt, w.permute(4, 3, 0, 1, 2), dilation=dilation)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv3x3x3_stats_twin(x: torch.Tensor, w: torch.Tensor, dilation: int = 1):
    """Plain PyTorch K1: the conv, then fp32 moments of y."""
    y = conv3x3x3_twin(x, w, dilation)
    return (y, *moments_twin(y))


def _check_conv(name: str, x: torch.Tensor, w: torch.Tensor,
                dilation: int) -> None:
    if x.dim() != 5 or w.dim() != 5 or w.shape[:3] != (3, 3, 3) \
            or w.shape[3] != x.shape[4]:
        raise ValueError(f"{name}: x {tuple(x.shape)} w {tuple(w.shape)}")
    if dilation not in (1, 2):
        raise ValueError(f"{name}: dilation {dilation}")


def _k1_blocks(t: str, cin: int, cout: int, dilation: int, d: int, h: int,
               wd: int) -> int:
    """Blocks per batch item of K1's kernel, which write one row of moments
    partials each: the bricks of the tensor-core conv (bf16) or of the FMA
    conv tile (fp32), as the library computes them."""
    tile = "conv_mma" if t == "bf16" else "conv_fma"
    n = getattr(_cuda.lib(), f"{tile}_blocks")(cin, cout, dilation, d, h, wd)
    if n < 1:
        raise ValueError(f"conv3x3x3_stats: no plan for {(cin, cout)}")
    return n


def _k1(x: torch.Tensor, w: torch.Tensor, dilation: int, with_stats: bool):
    """One K1 (with_stats) or K1-dx launch, or its twin on the CPU."""
    name = "conv3x3x3_stats" if with_stats else "conv3x3x3"
    if _cuda.dispatch(name, x, w):
        if with_stats:
            return conv3x3x3_stats_twin(x, w, dilation)
        return conv3x3x3_twin(x, w, dilation)
    t = _cuda.check(name, x, w)
    b, d, h, wd, cin = x.shape
    cout = w.shape[4]
    y = torch.empty((b, d, h, wd, cout), dtype=x.dtype, device=x.device)
    if with_stats:
        partial = torch.empty((b, _k1_blocks(t, cin, cout, dilation, d, h, wd),
                               2, cout), dtype=torch.float32,
                              device=x.device)
        s1 = torch.empty((b, cout), dtype=torch.float32, device=x.device)
        s2 = torch.empty_like(s1)
        ptrs = (partial.data_ptr(), s1.data_ptr(), s2.data_ptr())
    else:
        ptrs = (None, None, None)
    _cuda.run(f"{name}_{t}", x.device, x.data_ptr(), w.data_ptr(),
              y.data_ptr(), *ptrs, b, d, h, wd, cin, cout, dilation)
    return (y, s1, s2) if with_stats else y


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """The kernel whose stride-1 SAME conv is the transpose of w's:
    spatially flipped, in and out channels swapped (`packed.py:494`)."""
    return w.flip(0, 1, 2).transpose(3, 4).contiguous()


def _conv_backward(ctx, dy):
    """(dx, dw) of the stride-1 SAME 3³ conv y = conv(x, w), x and w saved
    in `ctx`, each None where its input needs no gradient.  dx is K1-dx on
    dy with the flip-transposed kernel; dw the plain weight gradient
    (cuDNN), OIDHW → DHWIO.  With grad mode on (a backward run with
    `create_graph`), both are recorded so that they can be differentiated:
    dx through `_Conv3x3x3`, dw through cuDNN's weight gradient, which
    autograd differentiates itself."""
    x, w = ctx.saved_tensors
    d = ctx.dilation
    dx = dw = None
    dy = dy.contiguous()
    if ctx.needs_input_grad[0]:
        wt = flip_transpose(w)
        dx = (_Conv3x3x3.apply(dy, wt, d) if torch.is_grad_enabled()
              else _k1(dy, wt, d, False))
    if ctx.needs_input_grad[1]:
        dw = torch.nn.grad.conv3d_weight(
            x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).shape,
            dy.permute(0, 4, 1, 2, 3), padding=d, dilation=d)
        dw = dw.permute(2, 3, 4, 1, 0)
    return dx, dw


class _ConvStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dilation):
        y, s1, s2 = _k1(x, w, dilation, True)
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, _ds1, _ds2):   # stats cotangents dropped
        return (*_conv_backward(ctx, dy), None)


class _Conv3x3x3(torch.autograd.Function):
    """K1-dx as a Function of its own: the conv without the moments, whose
    backward is K1-dx again with the other flip (∂/∂x) and the weight
    gradient (∂/∂w).  `_ConvStats`'s backward runs it where its own dx is
    to be differentiated."""

    @staticmethod
    def forward(ctx, x, w, dilation):
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        return _k1(x, w, dilation, False)

    @staticmethod
    def backward(ctx, dy):
        return (*_conv_backward(ctx, dy), None)


def conv3x3x3_stats(x: torch.Tensor, w: torch.Tensor, dilation: int = 1):
    """K1 (y, Σy, Σy²): x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout) in one
    dtype → y (B, D, H, W, Cout) in that dtype, moments (B, Cout) fp32.
    Differentiable in x and w, twice (see the module docstring)."""
    _check_conv("conv3x3x3_stats", x, w, dilation)
    return _ConvStats.apply(x, w, dilation)


def conv3x3x3_stats_slab(x: torch.Tensor, w: torch.Tensor,
                         dilation: int = 1):
    """K1's (y, Σy, Σy²) on a D-slab (`parallel/spatial.py`): the conv runs
    on x with `dilation` halo planes each side (K1-dx's kernel, whose SAME
    pad then falls on the halo), is cropped back to the slab's planes, and
    K5a takes the crop's moments, which the GroupNorm sums over the spatial
    group.  K1's own moments epilogue would also sum the output planes of
    the halo.  The backward is K1-dx's: the crop pads dy with zeros, and
    the halo's share of dx goes back through the exchange's adjoint."""
    _check_conv("conv3x3x3_stats_slab", x, w, dilation)
    d = dilation
    xe = spatial.halo_d(x, d, d, 0.0, spatial.current())
    y = conv3x3x3(xe, w, d)[:, d:d + x.shape[1]].contiguous()
    with torch.no_grad():
        s1, s2 = stats.moments(y)
    return y, s1, s2


def conv3x3x3(x: torch.Tensor, w: torch.Tensor, dilation: int = 1):
    """K1-dx: the conv alone, y (B, D, H, W, Cout) in x's dtype.  K1's
    backward runs it for dx.  Where a graph is recorded (grad mode on and
    x or w needs a gradient) it runs as `_Conv3x3x3`, differentiable in x
    and w; elsewhere the launch alone."""
    _check_conv("conv3x3x3", x, w, dilation)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3x3.apply(x, w, dilation)
    return _k1(x, w, dilation, False)


# ---------------------------------------------------------------------------
# K2: voxel-row GEMM + moments
# ---------------------------------------------------------------------------


def gemm_stats_twin(x3: torch.Tensor, w: torch.Tensor):
    """Plain PyTorch K2: `x3 @ w`, then fp32 moments of y."""
    y = x3 @ w
    return (y, *moments_twin(y))


@functools.lru_cache(maxsize=None)
def _k2_rows(t: str, k: int, n: int) -> int:
    """Rows per moments partial of K2's kernel (one per tile): the
    tensor-core GEMM's (bf16) or the FMA tile's (fp32), from the library's
    plan, once per (dtype, K, N)."""
    if t == "bf16":
        plan = (ctypes.c_int * 4)()
        err = _cuda.lib().gemm_mma_plan(k, n, 1, 0, plan)
    else:
        plan = (ctypes.c_int * 5)()
        err = _cuda.lib().gemm_fma_plan(k, n, 1, 0, plan)
    if err:
        raise ValueError(f"gemm_stats: no plan for {(k, n)}")
    return plan[1]


def _k2(x3: torch.Tensor, w: torch.Tensor):
    if _cuda.dispatch("gemm_stats", x3, w):
        return gemm_stats_twin(x3, w)
    t = _cuda.check("gemm_stats", x3, w)
    b, v, k = x3.shape
    n = w.shape[1]
    y = torch.empty((b, v, n), dtype=x3.dtype, device=x3.device)
    # one fp32 buffer: the partials (B, tiles, 2, N), then s1 and s2 (B, N)
    nparts = b * -(-v // _k2_rows(t, k, n)) * 2 * n
    buf = torch.empty(nparts + 2 * b * n, dtype=torch.float32,
                      device=x3.device)
    p = buf.data_ptr()
    _cuda.run(f"gemm_stats_{t}", x3.device, x3.data_ptr(), w.data_ptr(),
              y.data_ptr(), p, p + 4 * nparts, p + 4 * (nparts + b * n),
              b, v, k, n)
    s1, s2 = buf[nparts:].view(2, b, n).unbind(0)
    return y, s1, s2


class _GemmStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, w):
        y, s1, s2 = _k2(x3, w)
        ctx.save_for_backward(x3, w)
        ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, _ds1, _ds2):   # stats cotangents dropped
        x3, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dy @ w.t()
        if ctx.needs_input_grad[1]:
            dw = x3.reshape(-1, x3.shape[-1]).t() @ dy.reshape(-1, dy.shape[-1])
        return dx, dw


def gemm_stats(x3: torch.Tensor, w: torch.Tensor):
    """K2 (y, Σy, Σy²): x3 (B, V, K), w (K, N) in one dtype → y (B, V, N)
    in that dtype, moments (B, N) fp32.  Differentiable in x3 and w."""
    if x3.dim() != 3 or w.dim() != 2 or w.shape[0] != x3.shape[2]:
        raise ValueError(f"gemm_stats: x3 {tuple(x3.shape)} "
                         f"w {tuple(w.shape)}")
    if torch.is_grad_enabled() and (x3.requires_grad or w.requires_grad):
        return _GemmStats.apply(x3, w)
    return _k2(x3, w)       # no graph to record (serving): no Function
