"""The `use_pallas` convs: the counterpart of
`nas_3d_unet_tpu/ops/pallas/conv3d.py`.

Kernels (`csrc/conv3d.cu`: in fp32 on the FMA units, K6 on K1's conv
tile `csrc/conv_fma.cuh` (planned as `ops/conv_fma.py` mirrors), K7 and
K4 on K2's voxel-row FMA tile `csrc/gemm_fma.cuh` (`ops/gemm_fma.py`); in
bf16 on the tensor cores, K6 on the conv tile `csrc/conv_mma.cuh`
(`ops/conv_mma.py`), K7 and K4 on K2's GEMM tile `csrc/gemm_mma.cuh`
(`ops/gemm_mma.py`)),
fp32 or bf16 with fp32 accumulation, rounded once to the input's dtype,
each with its plain PyTorch twin beside it:

  K6 `conv3d(x, w, b, stride, dilation, relu)`: 3³ SAME conv, stride 1 or
     2, dilation 1 or 2, lax's pads (the odd one high, `_same_pad`),
     optional bias and ReLU in the epilogue (replaces `conv3d`);
  K7 `pointwise_conv(x, w, b, relu)`: the 1³ conv, (voxels, Cin) @ (Cin,
     Cout), optional bias (rounded to w's dtype first, as the reference's
     kernel concatenates it into w) and ReLU (replaces `pointwise_conv`);
  K4 `conv_transpose2x(x, w, relu)`: the kernel-2 stride-2 transpose conv
     as (voxels, Cin) @ (Cin, 8·Cout) whose store writes the depth-to-space
     layout; lax puts the spatially flipped tap at each output offset
     (`_transpose2x_fwd`): both kernels read the DHWIO kernel with the
     flip themselves, so the wrapper copies nothing (replaces
     `conv_transpose2x`).

Layouts are the JAX package's: NDHWC activations, DHWIO kernels (K7:
(Cin, Cout)).

Gradients: as in the reference, whose custom VJPs differentiate the plain
XLA version (`_conv3d_bwd_rule`, `_pointwise_bwd_rule`,
`_transpose2x_bwd_rule`), each autograd Function runs the kernel forward
and the backward of its twin: cuDNN's `convolution_backward` for K6 and
K4, matmuls for K7.  The cotangent is cast to x's dtype first and masked
by y > 0 where the ReLU was fused.  Those backwards are differentiable
ops on the saved x and w (the mask from the kernel's y is a constant),
so a backward run with `create_graph` (the second-order search step) is
differentiated by autograd: each Function is twice differentiable.  Where no graph is recorded (grad mode
off, or no input that needs a gradient: serving), K7 and K4 launch their
kernel without the Function.

On a D-slab (`parallel/spatial.py`) the 3³ convs, K6 and `conv3d_same`
alike, run on x with the halo that lax's SAME pads of the global D ask
for ((d, d) at stride 1, (0, 1) at stride 2, (1, 2) at stride 2 and
dilation 2) and a D pad of 0 (`_halo_pads`); K6's ⌈D/stride⌉ output
planes are cropped to the valid ones, and its backward's dx goes back
through the exchange's adjoint.  K7 and K4 need no halo.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches the kernel
or raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import spatial
from . import _cuda


def same_pad(in_size: int, kernel: int, stride: int,
             dilation: int) -> tuple[int, int]:
    """lax 'SAME' padding (lo, hi) for one axis: the odd pad goes high."""
    out = -(-in_size // stride)
    k_eff = dilation * (kernel - 1) + 1
    total = max(0, (out - 1) * stride + k_eff - in_size)
    return total // 2, total - total // 2


def _check(name: str, x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None, taps: tuple) -> None:
    """x NDHWC; w `taps` + (Cin, Cout) with x's Cin; b (Cout,) or None."""
    if x.dim() != 5 or w.dim() != len(taps) + 2 \
            or tuple(w.shape[:-2]) != taps or w.shape[-2] != x.shape[4] \
            or (b is not None and tuple(b.shape) != (w.shape[-1],)):
        raise ValueError(f"{name}: x {tuple(x.shape)} w {tuple(w.shape)}"
                         f" b {None if b is None else tuple(b.shape)}")


def _epilogue(y: torch.Tensor, b: torch.Tensor | None, relu: bool,
              dtype: torch.dtype) -> torch.Tensor:
    """Bias and ReLU on an fp32 result, rounded once to `dtype`."""
    if b is not None:
        y = y + b.float()
    if relu:
        y = y.relu()
    return y.to(dtype)


def _bias(b: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """The kernels take the bias as a dense fp32 vector on x's device."""
    if b is None:
        return None
    if b.device != x.device:
        raise ValueError(f"bias on {b.device}, x on {x.device}")
    return b.float().contiguous()


def _grad_in(g: torch.Tensor, y: torch.Tensor | None, x: torch.Tensor):
    """The cotangent in x's dtype, masked by y > 0 when ReLU was fused."""
    g = g.to(x.dtype)
    return g if y is None else torch.where(y > 0, g, 0)


# ---------------------------------------------------------------------------
# K6: 3³ SAME conv, stride 1 or 2 (+ bias, ReLU)
# ---------------------------------------------------------------------------


def _same_pads(x: torch.Tensor, k: int, stride: int, dilation: int):
    """lax's SAME pads of NDHWC x in F.pad's order: W lo/hi, H lo/hi, D
    lo/hi."""
    pads = []
    for size in reversed(x.shape[1:4]):
        pads += same_pad(size, k, stride, dilation)
    return pads


def _halo_pads(x: torch.Tensor, k: int, stride: int, dilation: int):
    """(x, pads in F.pad's order) for a SAME conv of x: lax's pads of x's
    shape, or, on a D-slab (`parallel/spatial.py`), x with the halo that
    lax's pads of the global D ask for and a D pad of 0."""
    pads = _same_pads(x, k, stride, dilation)
    slab = spatial.current()
    if slab is None:
        return x, pads
    lo, hi = same_pad(x.shape[1] * slab.size, k, stride, dilation)
    pads[4:6] = [0, 0]
    return spatial.halo_d(x, lo, hi, 0.0, slab), pads


def _padded_nchw(x: torch.Tensor, pads) -> torch.Tensor:
    """x as NCDHW with `pads` applied."""
    xt = x.permute(0, 4, 1, 2, 3)
    return F.pad(xt, pads) if any(pads) else xt


def _conv(x, w, pads, stride, dilation, groups=1):
    """The conv of NDHWC x padded by `pads` with a DHWIO kernel (cuDNN),
    NDHWC out."""
    y = F.conv3d(_padded_nchw(x, pads), w.permute(4, 3, 0, 1, 2),
                 stride=stride, dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 4, 1)


def conv3d_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Plain SAME conv on NDHWC with a DHWIO kernel (cuDNN).  The pad is
    explicit because torch's `padding=` is symmetric and lax's is not; on
    a D-slab the D pad is the halo (`_halo_pads`)."""
    x, pads = _halo_pads(x, w.shape[0], stride, dilation)
    return _conv(x, w, pads, stride, dilation, groups)


def conv3d_twin(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None = None, stride: int = 1,
                dilation: int = 1, relu: bool = False,
                pads=None) -> torch.Tensor:
    """Plain PyTorch K6: the conv of x padded by `pads` (None: lax's SAME
    pads of x).  With a bias the conv runs in fp32 so that y rounds once,
    as the kernel's does; without one it runs in x's dtype (one rounding
    too)."""
    if pads is None:
        pads = _same_pads(x, 3, stride, dilation)
    if b is None:
        y = _conv(x, w, pads, stride, dilation)
        return (y.relu() if relu else y).contiguous()
    y = _conv(x.float(), w.float(), pads, stride, dilation)
    return _epilogue(y, b, relu, x.dtype).contiguous()


def _k6(x, w, b, stride, dilation, relu, pads=None):
    """One K6 launch (the conv tile of x's dtype: `csrc/conv_fma.cuh` in
    fp32, `csrc/conv_mma.cuh` in bf16), or its twin on the CPU.  `pads`
    (F.pad's order; None: lax's SAME pads of x) may set the D pads of a
    slab extended by its halo to 0: the kernel, which writes ⌈D/stride⌉
    planes, is then cropped to the conv's valid ones."""
    if pads is None:
        pads = _same_pads(x, 3, stride, dilation)
    if _cuda.dispatch("conv3d", x, w):
        return conv3d_twin(x, w, b, stride, dilation, relu, pads)
    t = _cuda.check("conv3d", x, w)
    bsz, d, h, wd, cin = x.shape
    cout = w.shape[4]
    out = [-(-s // stride) for s in (d, h, wd)]
    y = torch.empty((bsz, *out, cout), dtype=x.dtype, device=x.device)
    _cuda.run(f"conv3d_{t}", x.device, x.data_ptr(), w.data_ptr(),
              _cuda.ptr(_bias(b, x)), y.data_ptr(), bsz, d, h, wd, cin, cout,
              stride, dilation, pads[4], pads[2], pads[0], int(relu))
    valid = (d + pads[4] + pads[5] - 2 * dilation - 1) // stride + 1
    return y if valid == out[0] else y[:, :valid].contiguous()


class _Conv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, dilation, relu, pads):
        y = _k6(x, w, b, stride, dilation, relu, pads)
        ctx.save_for_backward(x, w, y if relu else None)
        ctx.conf = (stride, dilation, None if b is None else b.dtype, pads)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        stride, dilation, b_dtype, pads = ctx.conf
        g = _grad_in(g, y, x)
        xt = _padded_nchw(x, pads)
        wt = w.permute(4, 3, 0, 1, 2)
        gt = g.permute(0, 4, 1, 2, 3)
        need_x, need_w = ctx.needs_input_grad[:2]
        dxt, dwt, _ = torch.ops.aten.convolution_backward(
            gt, xt, wt, None, [stride] * 3, [0] * 3, [dilation] * 3, False,
            [0] * 3, 1, [need_x, need_w, False])
        dx = dw = db = None
        if need_x:      # crop the pads off, back to NDHWC
            w0, h0, d0 = pads[0], pads[2], pads[4]
            d, h, wd = x.shape[1:4]
            dx = dxt[:, :, d0:d0 + d, h0:h0 + h, w0:w0 + wd]
            dx = dx.permute(0, 2, 3, 4, 1).contiguous()
        if need_w:
            dw = dwt.permute(2, 3, 4, 1, 0)
        if b_dtype is not None and ctx.needs_input_grad[2]:
            db = g.float().sum((0, 1, 2, 3)).to(b_dtype)
        return dx, dw, db, None, None, None, None


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, dilation: int = 1,
           relu: bool = False) -> torch.Tensor:
    """K6: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout), b (Cout,) or None,
    one dtype → y (B, ⌈D/s⌉, ⌈H/s⌉, ⌈W/s⌉, Cout) in that dtype.  On a
    D-slab, the launch runs on x with its halo and a D pad of 0.
    Differentiable in x, w and b."""
    _check("conv3d", x, w, b, (3, 3, 3))
    if stride not in (1, 2) or dilation not in (1, 2):
        raise ValueError(f"conv3d: stride {stride} dilation {dilation}")
    x, pads = _halo_pads(x.contiguous(), 3, stride, dilation)
    return _Conv3d.apply(x, w.contiguous(), b, stride, dilation, relu,
                         tuple(pads))


# ---------------------------------------------------------------------------
# K7: 1³ conv
# ---------------------------------------------------------------------------


def pointwise_conv_twin(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor | None = None,
                        relu: bool = False) -> torch.Tensor:
    """Plain PyTorch K7: a matmul over voxel rows (in fp32 with a bias, so
    that y rounds once; the bias rounded to w's dtype first, as the
    reference's kernel adds it as a row of w)."""
    if b is None:
        y = x @ w
        return y.relu() if relu else y
    return _epilogue(x.float() @ w.float(), b.to(w.dtype), relu, x.dtype)


def _k7(x, w, b, relu):
    if _cuda.dispatch("pointwise_conv", x, w):
        return pointwise_conv_twin(x, w, b, relu)
    t = _cuda.check("pointwise_conv", x, w)
    cin, cout = w.shape
    rows = x.numel() // cin
    y = torch.empty((*x.shape[:-1], cout), dtype=x.dtype, device=x.device)
    if b is not None:       # the reference's bias row is in w's dtype
        b = b.to(w.dtype)
    _cuda.run(f"pointwise_conv_{t}", x.device, x.data_ptr(), w.data_ptr(),
              _cuda.ptr(_bias(b, x)), y.data_ptr(), rows, cin, cout, int(relu))
    return y


class _Pointwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, relu):
        y = _k7(x, w, b, relu)
        ctx.save_for_backward(x, w, y if relu else None)
        ctx.b_dtype = None if b is None else b.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = _grad_in(g, y, x)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = g @ w.t()
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        if ctx.b_dtype is not None and ctx.needs_input_grad[2]:
            db = g.float().sum(tuple(range(g.dim() - 1))).to(ctx.b_dtype)
        return dx, dw, db, None


def pointwise_conv(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None,
                   relu: bool = False) -> torch.Tensor:
    """K7: x (B, D, H, W, Cin), w (Cin, Cout), b (Cout,) or None, one
    dtype → y (B, D, H, W, Cout).  Differentiable in x, w and b."""
    _check("pointwise_conv", x, w, b, ())
    x, w = x.contiguous(), w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or (
            b is not None and b.requires_grad)):
        return _Pointwise.apply(x, w, b, relu)
    return _k7(x, w, b, relu)   # no graph to record (serving): no Function


# ---------------------------------------------------------------------------
# K4: kernel-2 stride-2 transpose conv
# ---------------------------------------------------------------------------


def _transpose_weight(w: torch.Tensor) -> torch.Tensor:
    """DHWIO (2, 2, 2, Cin, Cout) → torch's (Cin, Cout, 2, 2, 2) with lax's
    tap flip: lax puts tap 1−δ at output offset δ on each axis, torch tap
    δ (`packed.py:644-656`)."""
    return w.flip(0, 1, 2).permute(3, 4, 0, 1, 2)


def conv_transpose2x_twin(x: torch.Tensor, w: torch.Tensor,
                          relu: bool = False) -> torch.Tensor:
    """Plain PyTorch K4: `F.conv_transpose3d` (cuDNN) with the flip."""
    y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), _transpose_weight(w),
                           stride=2).permute(0, 2, 3, 4, 1)
    return (y.relu() if relu else y).contiguous()


def _k4(x, w, relu):
    """One K4 launch on the DHWIO kernel as it is (both tiles stage it
    with lax's flip, `conv3d.py:383-385`), or its twin on the CPU."""
    if _cuda.dispatch("conv_transpose2x", x, w):
        return conv_transpose2x_twin(x, w, relu)
    t = _cuda.check("conv_transpose2x", x, w)
    bsz, d, h, wd, cin = x.shape
    cout = w.shape[4]
    y = torch.empty((bsz, 2 * d, 2 * h, 2 * wd, cout), dtype=x.dtype,
                    device=x.device)
    _cuda.run(f"conv_transpose2x_{t}", x.device, x.data_ptr(), w.data_ptr(),
              y.data_ptr(), bsz, d, h, wd, cin, cout, int(relu))
    return y


class _Transpose2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, relu):
        y = _k4(x, w, relu)
        ctx.save_for_backward(x, w, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = _grad_in(g, y, x)
        need_x, need_w = ctx.needs_input_grad[:2]
        dxt, dwt, _ = torch.ops.aten.convolution_backward(
            g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3),
            _transpose_weight(w), None, [2] * 3, [0] * 3, [1] * 3, True,
            [0] * 3, 1, [need_x, need_w, False])
        dx = dxt.permute(0, 2, 3, 4, 1).contiguous() if need_x else None
        # (Cin, Cout, 2, 2, 2) → DHWIO, undoing the flip
        dw = dwt.permute(2, 3, 4, 0, 1).flip(0, 1, 2) if need_w else None
        return dx, dw, None


def conv_transpose2x(x: torch.Tensor, w: torch.Tensor,
                     relu: bool = False) -> torch.Tensor:
    """K4: x (B, D, H, W, Cin), w (2, 2, 2, Cin, Cout) in flax's
    ConvTranspose layout, one dtype → y (B, 2D, 2H, 2W, Cout).
    Differentiable in x and w."""
    _check("conv_transpose2x", x, w, None, (2, 2, 2))
    x, w = x.contiguous(), w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Transpose2x.apply(x, w, relu)
    return _k4(x, w, relu)      # no graph to record (serving): no Function
