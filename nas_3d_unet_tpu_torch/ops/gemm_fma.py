"""The plan of the fp32 voxel-row FMA tile behind K2, K7 and K4 in fp32
(`csrc/gemm_fma.cuh`), and that kernel's algorithm in plain PyTorch.

The kernel (launched by `pgemm.gemm_stats`, `conv3d.pointwise_conv` and
`conv3d.conv_transpose2x` on fp32 CUDA tensors) cuts the voxel rows into
tiles of BM; each block stages w (BN output columns) once and walks over
its tiles, x in K chunks of 16 through a ring of stages; each thread sums
a TM × TN register tile (rows ty + i·TY, i < TM) over k in increasing
order, adds the bias and clamps (K7, K4), and the tile goes out as one run
of rows (K2, K7) or depth-to-space in runs of columns (K4); for K2 it also
sums the moments of each tile's y.  Its host side picks the tile from the
shapes:

  `plan(k, n, stats, d2s)`  the block's columns BN, its rows per tile, the
      K chunks, the x stages (the most, 4 or 3, with which two blocks fit
      an SM, else 4 or fewer with one) and the bytes of shared memory (the
      moments' warp rows with `stats`, the rows' output corners with
      `d2s`).  The C function `gemm_fma_plan` returns the same numbers
      (chip_smoke.py holds the two equal on the card).
  `store_runs(cout, bn, h, wd)`  K4's store: the runs of columns a block
      writes, each with its offset from a row's output corner.
  `row_gemm_stats(x3, w)`  K2's algorithm: the tile walk of
      `gemm_mma.tile_sums` at this tile's rows and chunks, and the
      per-tile moments partials (B, tiles, 2, N) in the kernel's order
      (`tile_moments`; whichever block takes a tile, its sums are the
      same).
  `row_gemm(x3, w, b, relu)`  K7's: the same sums, the bias and the ReLU.
  `transpose2x(x, w, relu)`  K4's: w staged from the DHWIO kernel as the
      kernel reads it (`gemm_mma.staged_transpose_w`), the same sums, the
      ReLU, and the depth-to-space store run by run at each row's corner
      (`gemm_mma.d2s_offsets`).
No path runs them; the tests hold them against the twins and the JAX
functions they replace, which checks the kernel's tiling and masking where
no card is.  Their sums run chunk by chunk (a matmul each), where the
kernel's run k by k: the same within fp32 rounding, not the same bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .gemm_mma import d2s_offsets, epilogue, staged_transpose_w, tile_sums

THREADS = 256
WARPS = THREADS // 32
KC = 16                     # K per x stage
LDX = KC + 4                # an x stage row in shared memory, floats
SMEM_MAX = 232448           # 227 KB: the most a block may have
SMEM_TWO_BLOCKS = 113 * 1024


def tile_n(bn: int) -> int:
    """A thread's columns."""
    return 8 if bn >= 64 else 4


def tile_m(bn: int) -> int:
    """A thread's rows."""
    return 8 if bn in (32, 128) else 4


def tile_rows(bn: int) -> int:
    """The tile's rows: 256 threads, BN / TN of them along N."""
    return THREADS // (bn // tile_n(bn)) * tile_m(bn)


@dataclass(frozen=True)
class Plan:
    bn: int                     # columns per block
    rows: int                   # rows per tile (a partial row each)
    nchunks: int                # K chunks of 16
    stages: int                 # x stages in the ring
    smem: int                   # bytes of shared memory per block


def _smem(bn: int, nchunks: int, stages: int, stats: bool,
          d2s: bool) -> int:
    bm = tile_rows(bn)
    return (nchunks * KC * bn + stages * bm * LDX + bm * bn
            + (WARPS * 2 * bn if stats else 0) + (bm if d2s else 0)) * 4


def plan(k: int, n: int, stats: bool = True, d2s: bool = False) -> Plan:
    """The kernel's tile (`gemm_fma.cuh` make_plan): BN the narrowest of
    16/32/64/128 covering N (N above 128, K4's N = 8·Cout among them,
    takes ⌈N/128⌉ column blocks); shared memory for w (all chunks), the
    ring of x stages, the epilogue's y tile and, with `stats` (K2), the
    warps' moments rows or, with `d2s` (K4), each row's output corner."""
    if min(k, n) < 1:
        raise ValueError(f"gemm_fma: k {k} n {n}")
    bn = 16 if n <= 16 else 32 if n <= 32 else 64 if n <= 64 else 128
    nchunks = -(-k // KC)
    smem = lambda s: _smem(bn, nchunks, s, stats, d2s)
    fits = [s for s in (4, 3) if smem(s) <= SMEM_TWO_BLOCKS]
    fits = fits or [s for s in (4, 3, 2) if smem(s) <= SMEM_MAX] or [2]
    return Plan(bn, tile_rows(bn), nchunks, fits[0], smem(fits[0]))


def tile_moments(y: torch.Tensor, keep: torch.Tensor,
                 bn: int) -> torch.Tensor:
    """(2, C) fp32 (Σy, Σy²) of one tile's rows y (BM, C) where `keep`
    (BM,), in the kernel's order: thread row ty holds rows ty + i·TY and
    sums them in i order; the warp's WT = 32 / TX thread rows are summed
    pairwise (the __shfl_xor butterfly), then the 8 warps in order."""
    bm, c = y.shape
    ty_n = THREADS // (bn // tile_n(bn))
    v = torch.where(keep[:, None], y.float(), 0.0)
    out = []
    for t in (v, v * v):
        t = t.view(bm // ty_n, ty_n, c)               # (i, ty, C)
        acc = torch.zeros((ty_n, c))
        for i in range(t.shape[0]):                   # this thread's rows
            acc = acc + t[i]
        acc = acc.view(WARPS, ty_n // WARPS, c)       # (warp, row in warp)
        while acc.shape[1] > 1:                       # the butterfly
            acc = acc[:, 0::2] + acc[:, 1::2]
        total = torch.zeros(c)
        for w in range(WARPS):                        # the warps, in order
            total = total + acc[w, 0]
        out.append(total)
    return torch.stack(out)


def row_gemm_stats(x3: torch.Tensor, w: torch.Tensor):
    """K2's algorithm: x3 (B, V, K), w (K, N) fp32 → y (B, V, N) fp32,
    summed per tile chunk by chunk, and partial (B, ⌈V/BM⌉, 2, N) fp32,
    each tile's moments of its y over the rows < V."""
    bsz, v, k = x3.shape
    n = w.shape[1]
    p = plan(k, n)
    y = tile_sums(x3, w, p.rows, KC)
    ntiles = y.shape[1] // p.rows
    partial = torch.zeros((bsz, ntiles, 2, n))
    rows = torch.arange(p.rows)
    for b in range(bsz):
        for t in range(ntiles):
            r0 = t * p.rows
            partial[b, t] = tile_moments(y[b, r0:r0 + p.rows],
                                         r0 + rows < v, p.bn)
    return y[:, :v].contiguous(), partial


def row_gemm(x3: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor | None = None,
             relu: bool = False) -> torch.Tensor:
    """K7's algorithm: x3 (B, V, K), w (K, N), b (N,) fp32 or None → y (B,
    V, N) fp32: the tile's sums, + b, ReLU."""
    v = x3.shape[1]
    p = plan(x3.shape[2], w.shape[1], False)
    return epilogue(tile_sums(x3, w, p.rows, KC)[:, :v], b, relu,
                    torch.float32)


def store_runs(cout: int, bn: int, h: int, wd: int):
    """K4's store within one batch item: [(first column, offset, width)]
    over all column blocks of BN, each block's columns cut into runs of R =
    gcd(2·Cout, BN) (a power of two, so a run never crosses the 2·Cout
    columns of one (kd, kh) pair); a run's column j of row m lands at
    corner[m] + offset + j.  The pair p = kd·2 + kh sits kd planes and kh
    rows past the corner, its kw = 0 and 1 taps side by side."""
    run = math.gcd(2 * cout, bn)
    out = []
    for n in range(0, 8 * cout, run):
        p = n // (2 * cout)
        out.append((n, ((p >> 1) * 2 * h + (p & 1)) * 2 * wd * cout
                    + n - p * 2 * cout, run))
    return out


def transpose2x(x: torch.Tensor, w: torch.Tensor,
                relu: bool = False) -> torch.Tensor:
    """K4's algorithm: x (B, D, H, W, Cin), w (2, 2, 2, Cin, Cout) fp32 →
    y (B, 2D, 2H, 2W, Cout) fp32: the tile's sums of the voxel rows
    against the staged w, ReLU, each run of columns stored at each row's
    output corner."""
    bsz, d, h, wd, cin = x.shape
    cout = w.shape[4]
    v = d * h * wd
    p = plan(cin, 8 * cout, False, True)
    rows = epilogue(tile_sums(x.reshape(bsz, v, cin), staged_transpose_w(w),
                              p.rows, KC)[:, :v], None, relu, torch.float32)
    corner, _ = d2s_offsets(d, h, wd, cout)
    y = torch.empty((bsz, 8 * v * cout))
    for n, off, width in store_runs(cout, p.bn, h, wd):
        at = corner[:, None] + off + torch.arange(width)
        y[:, at.reshape(-1)] = rows[:, :, n:n + width].reshape(bsz, -1)
    return y.view(bsz, 2 * d, 2 * h, 2 * wd, cout)
