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

One launch a call (`csrc/stats.cu`): blocks of `THREADS` threads each sum
a span of rows into a double partial, and the block that draws the last
ticket of its (batch item, channel tile) sums the partials.  The host
side, here, is one `torch.empty` and one `_cuda.run`:

  `plan(b, v, c, esize, ntensors, aligned)`  the grid, cached by its
      arguments: VEC channels a load (16 bytes where C · element size is
      a multiple of 16 and every pointer is 16-byte aligned, else 1), the
      channel tiles, the rows a pass covers, and `rows` a block: whole
      passes of U rows a thread, at least `SPAN_BYTES` of one input, and
      no more than `MAX_BLOCKS` blocks.  The tiling is decided here alone:
      the kernel takes every field of the plan, refuses one it would not
      run as planned (another U or thread count, tiles or spans that miss
      a channel or row), and returns an error code that `_cuda.run`
      raises on.
  The allocation `(2 + 4·nspan, B, C)` fp32 holds the sums (rows 0, 1:
      the outputs, as views) and then the partials (B, nspan, 2, C) as
      doubles.  Each block's partial is 16 bytes a channel against the
      ≥ `SPAN_BYTES` it reads, so the partials are at most 16·C /
      `SPAN_BYTES` of one input's bytes where V fills more than one span
      (1/16 at C = 256).
  `kernel_sums(p, x, g, y)`  the kernel's algorithm and summation order
      in plain PyTorch (fp32 over U rows, then double per thread, the
      block's tree, the spans in split order): no path runs it; the tests
      hold it against float64 sums and the JAX functions, which checks the
      plan's tiling where no card is.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools
import operator
from typing import NamedTuple

import torch

from . import _cuda

THREADS = 256
MAX_TICKETS = 4096          # (batch item, channel tile) counters
SPAN_BYTES = 64 * 1024      # the least a block reads of one input
MAX_BLOCKS = 2 * 132        # two blocks on each of the H100's 132 SMs


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


def unroll(ntensors: int) -> int:
    """Rows a thread has in flight (`stats.cu` U), summed in fp32 before
    they go to double: 4 for the masked form's three inputs, else 8."""
    return 4 if ntensors == 3 else 8


class Plan(NamedTuple):
    """The grid of one call, in the order `stats.cu`'s entry points take
    it; the kernel refuses a plan it would not run as planned."""
    vec: int        # channels a thread loads at once
    unroll: int     # rows a thread has in flight
    cgt: int        # channel groups (of vec) a block covers
    ctiles: int     # channel tiles
    tr: int         # rows a pass covers: THREADS // cgt threads along V
    rows: int       # rows a block sums: whole passes of unroll · tr
    nspan: int      # blocks along V per (batch item, channel tile)


@functools.lru_cache(maxsize=None)
def plan(b: int, v: int, c: int, esize: int, ntensors: int = 1,
         aligned: bool = True) -> Plan:
    """The grid of one call on (b, v, c) inputs of `esize`-byte elements,
    `ntensors` of them (1 K5a, 2 K5b, 3 masked K5b); `aligned`: every
    pointer 16-byte aligned."""
    if min(b, v, c) < 1:
        raise ValueError(f"stats: no plan for {(b, v, c)}")
    wide = 16 // esize
    vec = wide if aligned and c % wide == 0 else 1
    cg = c // vec
    ctiles = _cdiv(cg, THREADS)
    cgt = _cdiv(cg, ctiles)
    if b * ctiles > MAX_TICKETS:
        raise ValueError(f"stats: {b} × {ctiles} tiles exceed the tickets")
    tr = THREADS // cgt
    u = unroll(ntensors)
    pass_rows = tr * u
    # passes a block: enough for SPAN_BYTES, and few enough blocks
    spans = max(1, MAX_BLOCKS // (b * ctiles))
    k = max(_cdiv(SPAN_BYTES, pass_rows * cgt * vec * esize),
            _cdiv(_cdiv(v, pass_rows), spans))
    rows = k * pass_rows
    return Plan(vec, u, cgt, ctiles, tr, rows, _cdiv(v, rows))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def kernel_sums(p: Plan, x: torch.Tensor, g: torch.Tensor | None = None,
                y: torch.Tensor | None = None):
    """`stats.cu`'s algorithm on (B, V, C) inputs: (Σx, Σx²) or, with g,
    (Σg, Σg·x) (g where y > 0, with y), (B, C) fp32, summed in the kernel's
    order: a thread's U rows in fp32, those sums in double, the block's
    tree, the spans.  Within fp32 rounding of the kernel (fmaf rounds once where
    this rounds twice), not its bits."""
    bsz, v, c = x.shape
    pad = p.nspan * p.rows - v
    npass = p.rows // (p.unroll * p.tr)

    def rows(t):    # (B, nspan, npass, unroll, tr, C) fp32, zero-padded
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.view(bsz, p.nspan, npass, p.unroll, p.tr, c)

    xv = rows(x)
    if g is None:
        t1, t2 = xv, xv * xv
    else:
        gv = rows(g)
        if y is not None:
            gv = torch.where(rows(y) > 0, gv, 0.0)
        t1, t2 = gv, gv * xv
    out = []
    for t in (t1, t2):
        f = torch.zeros_like(t[:, :, :, 0])
        for k in range(p.unroll):                   # fp32, row order
            f = f + t[:, :, :, k]
        a = torch.zeros_like(f[:, :, 0], dtype=torch.float64)
        for i in range(npass):                      # the thread's doubles
            a = a + f[:, :, i].double()
        step = 1 << max(p.tr - 1, 0).bit_length()
        while step > 1:                             # the block's tree
            step >>= 1
            hi = a[:, :, step:min(2 * step, p.tr)]
            a = a.clone()
            a[:, :, :hi.shape[2]] += hi
        part = a[:, :, 0]                           # (B, nspan, C)
        out.append(part)
    return tuple(_span_order(p, c, part).float() for part in out)


def _span_order(p: Plan, c: int, part: torch.Tensor) -> torch.Tensor:
    """The last block's sum over spans of (B, nspan, C) partials: each
    channel tile's outputs (2 per channel) split over the block's threads,
    every nsplit-th span a thread, the splits added in order."""
    out = []
    for tile in range(p.ctiles):
        cs = slice(tile * p.cgt * p.vec, min(c, (tile + 1) * p.cgt * p.vec))
        o = 2 * (cs.stop - cs.start)
        nsplit = max(1, THREADS // o)
        t = part[:, :, cs]
        tot = torch.zeros_like(t[:, 0])
        for q in range(nsplit):
            s = torch.zeros_like(t[:, 0])
            for i in range(q, p.nspan, nsplit):
                s = s + t[:, i]
            tot = tot + s
        out.append(tot)
    return torch.cat(out, dim=1)


def _launch(name: str, *ts: torch.Tensor):
    t = _cuda.check(name, *ts)
    x = ts[0]
    dev = x.device
    shape = x.shape
    b, c = shape[0], shape[-1]
    v = x.numel() // (b * c)
    ptrs = [u.data_ptr() for u in ts]
    p = plan(b, v, c, x.element_size(), len(ptrs),
             not functools.reduce(operator.or_, ptrs) & 15)
    # sizes as separate ints: PyTorch parses them faster than a tuple
    buf = torch.empty(2 + 4 * p.nspan, b, c, dtype=torch.float32,
                      device=dev)
    _cuda.run(f"{name}_{t}", dev, *ptrs, buf.data_ptr(), b, v, c, *p)
    return buf[0], buf[1]


def moments(x: torch.Tensor):
    """K5a: x (B, ..., C) → (Σx, Σx²), (B, C) fp32.  Not differentiable.

    On the card it runs on the current stream.  Every K5 call of a device
    shares `stats.cu`'s tickets, so two K5 calls that overlap on two
    streams would return wrong sums, without an error: order them with
    events."""
    if x.dim() < 3:
        raise ValueError(f"moments: x {tuple(x.shape)}")
    if _cuda.dispatch("moments", x):
        return moments_twin(x)
    return _launch("moments", x)


def weighted_sums(g: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor | None = None):
    """K5b: g, x (B, ..., C) → (Σg, Σg·x), (B, C) fp32; with y (same
    shape), g counts only where y > 0 (`weighted_sums_masked`).  Not
    differentiable.  Streams: as `moments`; no two K5 calls may overlap
    on two streams."""
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
