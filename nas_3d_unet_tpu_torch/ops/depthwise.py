"""The depthwise 3³ SAME conv of `SepConv`, on the port's own kernels.

It replaces no TPU kernel: the JAX package leaves this conv to XLA
(`nas_3d_unet_tpu/ops/primitives.py` `SepConv`, `ops/packed.py`
`packed_depthwise3`).  On the card it took most of the device time of
training and the search as cuDNN's grouped conv; here it is three kernels
of `csrc/depthwise.cu`, NDHWC throughout, fp32 or bf16 with fp32 sums
rounded once to the element type, each with its plain twin beside it:

  `dw(x, w, g)`    y = DW(x, w):  y[o] = Σ_k x[s·o + k − p] · w[k];
  `dwt(dy, w, g)`  dx = DWT(dy, w): the adjoint of DW in x (stride 1: DW
                   with the taps flipped; stride 2: the 1 or 2 taps a
                   dimension whose parity matches);
  `dww(x, dy, g)`  dw = DWW(x, dy): the adjoint of DW in w, a per-channel
                   27-tap correlation: fp32 partials a block
                   (`dw3_wgrad`) into a workspace of `torch.empty`, summed
                   in a fixed order by a second launch (`dw3_wsum`) and
                   rounded once to the element type, as cuDNN returns
                   the weight operand's gradient.

x is (N, D, H, W, C), w (3, 3, 3, 1, C) as flax holds it, y (N, OD, OH,
OW, C); `Geom` holds the stride, the pads before each dimension and both
grids (the pads after follow from them).  Outside x the kernels read
zeros: no `F.pad` copy, no permute.

Three autograd Functions close on each other, so every backward is
differentiable again (the second-order search step): `_DW`'s backward is
DWT and DWW, `_DWT`'s is DW and DWW, `_DWW`'s is DWT and DW.  Every sum
has a fixed order, so dx and dw repeat their bits from run to run, and
no kernel allocates or syncs: a CUDA graph captures them.

Dispatch: a CPU tensor takes the twin (today's `F.conv3d(groups=C)`
route, its transpose and its weight gradient); a CUDA tensor launches the
kernel or raises.  Launches count in `_cuda.DEPTHWISE_LAUNCHES`, keyed
`<kernel>_<f32|bf16>`, apart from `_cuda.LAUNCHES`: per train step 18
forwards, 18 dx, 18 dw partials and 18 sums; per served forward 9.

The plan (`plan`, mirroring the kernels' tiles): D chunks of the grid a
kernel's threads own, so that a launch has at least `MIN_BLOCKS` blocks
while a chunk keeps `MIN_PLANES` planes; `dw3_wgrad` takes its work items
(tile, batch item, D chunk) `per` to a block over at most `MIN_BLOCKS`
blocks, and the workspace holds one (27, C) row a block.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _cuda
from . import conv3d as pconv

# csrc/depthwise.cu's block: 8 channel groups x 8 columns x 4 rows of
# threads; a thread owns 2 output rows of the forward and dw at stride 1
THREADS, CQ, TWT, THT = 256, 8, 8, 4
# about one wave of two blocks an SM on the H100's 132: more D chunks
# than that cost more (their halo planes, each block's first planes) than
# the last wave's idle SMs
MIN_BLOCKS = 256
MIN_PLANES = 8              # the least a D chunk walks (2 halo planes)


class Geom(NamedTuple):
    """One depthwise conv's shape: y (OD, OH, OW) of x (D, H, W)."""
    stride: int
    lo: tuple       # pads before D, H, W
    x: tuple        # x's D, H, W
    y: tuple        # y's D, H, W


def geometry(x_dhw, stride: int, lo, hi) -> Geom:
    """The Geom of a conv of x with pads `lo` before and `hi` after."""
    y = tuple((n + a + b - 3) // stride + 1 for n, a, b in zip(x_dhw, lo, hi))
    return Geom(stride, tuple(lo), tuple(x_dhw), y)


def _pads(g: Geom) -> list:
    """g's pads in F.pad's order (W, H, D; before, after); an after pad
    is negative where the conv leaves x's last plane unread."""
    hi = [(o - 1) * g.stride + 3 - n - a for n, o, a in zip(g.x, g.y, g.lo)]
    return [g.lo[2], hi[2], g.lo[1], hi[1], g.lo[0], hi[0]]


# ---------------------------------------------------------------------------
# The plain twins (the CPU route)
# ---------------------------------------------------------------------------


def dw_twin(x: torch.Tensor, w: torch.Tensor, g: Geom) -> torch.Tensor:
    """Plain DW: cuDNN's (or the CPU's) grouped conv of x padded by g."""
    return pconv._conv(x, w, _pads(g), g.stride, 1,
                       groups=x.shape[-1]).contiguous()


def dwt_twin(dy: torch.Tensor, w: torch.Tensor, g: Geom) -> torch.Tensor:
    """Plain DWT: the grouped transpose conv of dy, then g's pads taken
    off (or x's unread last planes put back as zeros)."""
    xp = F.conv_transpose3d(dy.permute(0, 4, 1, 2, 3),
                            w.permute(4, 3, 0, 1, 2), stride=g.stride,
                            groups=dy.shape[-1])
    return F.pad(xp, [-p for p in _pads(g)]).permute(0, 2, 3, 4,
                                                     1).contiguous()


def dww_twin(x: torch.Tensor, dy: torch.Tensor, g: Geom) -> torch.Tensor:
    """Plain DWW: the grouped conv's weight gradient, as (3, 3, 3, 1,
    C)."""
    c = x.shape[-1]
    dwt = torch.nn.grad.conv3d_weight(
        pconv._padded_nchw(x, _pads(g)), (c, 1, 3, 3, 3),
        dy.permute(0, 4, 1, 2, 3), stride=g.stride, groups=c)
    return dwt.permute(2, 3, 4, 1, 0).contiguous()


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    """One launch's grid, as `csrc/depthwise.cu` takes it."""
    vec: int        # 1: 16-byte loads, 16 channels a block; 0: scalar, 8
    nchunk: int     # D chunks of the grid the threads own
    nblk: int       # dw3_wgrad: blocks a channel slice (partial rows)


def _tiles(rows: int, cols: int, stride: int) -> int:
    """The forward's and dw's tiles over an owned grid of rows x cols:
    (8 rows at stride 1, 4 at stride 2) x 8 columns."""
    return -(-rows // (2 * THT if stride == 1 else THT)) * -(-cols // TWT)


@functools.lru_cache(maxsize=None)
def plan(kernel: str, n: int, c: int, g: Geom, vec: int) -> Plan:
    """The grid of one launch of `kernel` ("fwd", "dgrad", "wgrad") of g on
    n batch items of c channels: D chunks of the grid its threads own
    (the output; dx for "dgrad"), and for "wgrad" its blocks a channel
    slice."""
    own = g.x if kernel == "dgrad" else g.y
    if kernel == "dgrad" and g.stride == 2:
        # a thread owns a dy position and the 2 x 2 dx it covers
        tiles = -(-((own[1] + g.lo[1] + 1) // 2) // THT) \
            * -(-((own[2] + g.lo[2] + 1) // 2) // TWT)
    else:
        tiles = _tiles(own[1], own[2], 1 if kernel == "dgrad" else g.stride)
    slices = -(-c // (2 * CQ if vec else CQ))
    nchunk = 1
    while (tiles * n * slices * nchunk < MIN_BLOCKS
           and own[0] // (2 * nchunk) >= MIN_PLANES):
        nchunk *= 2
    nblk = 0
    if kernel == "wgrad":       # at most MIN_BLOCKS blocks in all
        items = tiles * n * nchunk
        per = -(-items // -(-MIN_BLOCKS // slices))
        nblk = -(-items // per)
    return Plan(vec, nchunk, nblk)


def _vec(c: int, *ts: torch.Tensor) -> int:
    """1 where C is a multiple of 16 and every tensor is 16-byte aligned."""
    return int(c % (2 * CQ) == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def _run(name: str, t: str, dev, *args) -> None:
    _cuda.run(f"{name}_{t}", dev, *args, counter=_cuda.DEPTHWISE_LAUNCHES)


def _shapes(name: str, a: torch.Tensor, a_dhw, b: torch.Tensor, b_shape):
    """a (N, *a_dhw, C); b of shape b_shape (with a's N and C)."""
    n, c = a.shape[0], a.shape[-1]
    if a.dim() != 5 or tuple(a.shape[1:4]) != tuple(a_dhw) \
            or tuple(b.shape) != tuple(b_shape(n, c)):
        raise ValueError(f"{name}: {tuple(a.shape)} and {tuple(b.shape)}")


def dw(x: torch.Tensor, w: torch.Tensor, g: Geom) -> torch.Tensor:
    """DW: x (N, *g.x, C), w (3, 3, 3, 1, C) → y (N, *g.y, C)."""
    _shapes("dw3_fwd", x, g.x, w, lambda n, c: (3, 3, 3, 1, c))
    x, w = x.contiguous(), w.contiguous()
    if _cuda.dispatch("dw3_fwd", x, w):
        return dw_twin(x, w, g)
    t = _cuda.check("dw3_fwd", x, w)
    n, c = x.shape[0], x.shape[-1]
    y = torch.empty((n, *g.y, c), dtype=x.dtype, device=x.device)
    p = plan("fwd", n, c, g, _vec(c, x, w, y))
    _run("dw3_fwd", t, x.device, x.data_ptr(), w.data_ptr(), y.data_ptr(),
         n, c, *g.x, *g.y, g.stride, *g.lo, p.vec, p.nchunk)
    return y


def dwt(dy: torch.Tensor, w: torch.Tensor, g: Geom) -> torch.Tensor:
    """DWT: dy (N, *g.y, C), w (3, 3, 3, 1, C) → dx (N, *g.x, C)."""
    _shapes("dw3_dgrad", dy, g.y, w, lambda n, c: (3, 3, 3, 1, c))
    dy, w = dy.contiguous(), w.contiguous()
    if _cuda.dispatch("dw3_dgrad", dy, w):
        return dwt_twin(dy, w, g)
    t = _cuda.check("dw3_dgrad", dy, w)
    n, c = dy.shape[0], dy.shape[-1]
    dx = torch.empty((n, *g.x, c), dtype=dy.dtype, device=dy.device)
    p = plan("dgrad", n, c, g, _vec(c, dy, w, dx))
    _run("dw3_dgrad", t, dy.device, dy.data_ptr(), w.data_ptr(),
         dx.data_ptr(), n, c, *g.x, *g.y, g.stride, *g.lo, p.vec, p.nchunk)
    return dx


def dww(x: torch.Tensor, dy: torch.Tensor, g: Geom) -> torch.Tensor:
    """DWW: x (N, *g.x, C), dy (N, *g.y, C) → dw (3, 3, 3, 1, C)."""
    _shapes("dw3_wgrad", x, g.x, dy, lambda n, c: (n, *g.y, c))
    x, dy = x.contiguous(), dy.contiguous()
    if _cuda.dispatch("dw3_wgrad", x, dy):
        return dww_twin(x, dy, g)
    t = _cuda.check("dw3_wgrad", x, dy)
    n, c = x.shape[0], x.shape[-1]
    p = plan("wgrad", n, c, g, _vec(c, x, dy))
    part = torch.empty((p.nblk, 27, c), dtype=torch.float32, device=x.device)
    _run("dw3_wgrad", t, x.device, x.data_ptr(), dy.data_ptr(),
         part.data_ptr(), n, c, *g.x, *g.y, g.stride, *g.lo, p.vec, p.nchunk,
         p.nblk)
    out = torch.empty((3, 3, 3, 1, c), dtype=x.dtype, device=x.device)
    _run("dw3_wsum", t, x.device, part.data_ptr(), out.data_ptr(), p.nblk,
         27 * c)
    return out


# ---------------------------------------------------------------------------
# Autograd: three Functions, each the others' backward
# ---------------------------------------------------------------------------


class _DW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, g):
        ctx.save_for_backward(x, w)
        ctx.g = g
        return dw(x, w, g)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype)
        need_x, need_w = ctx.needs_input_grad[:2]
        return (_DWT.apply(gy, w, ctx.g) if need_x else None,
                _DWW.apply(x, gy, ctx.g) if need_w else None, None)


class _DWT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dy, w, g):
        ctx.save_for_backward(dy, w)
        ctx.g = g
        return dwt(dy, w, g)

    @staticmethod
    def backward(ctx, gdx):
        dy, w = ctx.saved_tensors
        gdx = gdx.to(dy.dtype)
        need_dy, need_w = ctx.needs_input_grad[:2]
        return (_DW.apply(gdx, w, ctx.g) if need_dy else None,
                _DWW.apply(gdx, dy, ctx.g) if need_w else None, None)


class _DWW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dy, g):
        ctx.save_for_backward(x, dy)
        ctx.g = g
        return dww(x, dy, g)

    @staticmethod
    def backward(ctx, gdw):
        x, dy = ctx.saved_tensors
        gdw = gdw.to(x.dtype)
        need_x, need_dy = ctx.needs_input_grad[:2]
        return (_DWT.apply(dy, gdw, ctx.g) if need_x else None,
                _DW.apply(x, gdw, ctx.g) if need_dy else None, None)


def depthwise3(x: torch.Tensor, w: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """The SepConv's depthwise conv: x (B, D, H, W, C), w (3, 3, 3, 1, C)
    of x's dtype, lax's SAME pads (the odd one high), stride 1 or 2 → y
    (B, ⌈D/s⌉, ⌈H/s⌉, ⌈W/s⌉, C), contiguous.  On a D-slab
    (`parallel/spatial.py`) x takes the halo that lax's pads of the global
    D ask for and a D pad of 0 (`conv3d._halo_pads`).  Differentiable to
    any order in x and w."""
    if stride not in (1, 2):
        raise ValueError(f"depthwise3: stride {stride}")
    x, pads = pconv._halo_pads(x, 3, stride, 1)
    g = geometry(tuple(x.shape[1:4]), stride, (pads[4], pads[2], pads[0]),
                 (pads[5], pads[3], pads[1]))
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _DW.apply(x, w, g)
    return dw(x, w, g)          # no graph to record (serving): no Function
