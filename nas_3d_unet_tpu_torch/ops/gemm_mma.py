"""The plan of the bf16 tensor-core GEMM behind K2, K7 and K4 in bf16
(`csrc/gemm_mma.cuh`), and that kernel's algorithm in plain PyTorch.

The kernel (launched by `pgemm.gemm_stats`, `conv3d.pointwise_conv` and
`conv3d.conv_transpose2x` on bf16 CUDA tensors) cuts the voxel rows into
tiles of 128; each block stages w (BN output columns) once and walks over
its tiles, x in K chunks of 32 through a ring of stages, sums one K = 16
MMA step at a time, adds the bias and clamps (K7's and K4's epilogue),
rounds y once, and stores it as rows (K2, K7) or depth-to-space (K4); for
K2 it also sums the moments of each tile's rounded y in the fixed order of
`csrc/moments.cuh`.  Its host side picks the tile from the shapes:

  `plan(k, n, stats, d2s)`  the block's columns BN, its rows, the K chunks
      and the bytes of shared memory (the moments' warp rows with `stats`,
      the rows' output corners with `d2s`).  The C function
      `gemm_mma_plan` returns the same numbers (chip_smoke.py holds the two
      equal on the card).
  `row_gemm_stats(x3, w)`  K2's algorithm on the CPU in fp32: per tile of
      rows, the chunk-by-chunk product, one rounding, and the per-tile
      moments partials (B, tiles, 2, N) in tile order (whichever block
      takes a tile, its sums are the same).
  `row_gemm(x3, w, b, relu)`  K7's: the same product, then the bias and
      the ReLU on the fp32 sum, one rounding.
  `transpose2x(x, w, relu)`  K4's: w staged from the DHWIO kernel as the
      kernel reads it (`staged_transpose_w`), the product with the ReLU,
      and the depth-to-space store at each row's output corner plus each
      column's offset (`d2s_offsets`).
No path runs them; the tests hold them against the twins and the JAX
functions they replace, which checks the kernel's tiling, indexing and
masking where no card is.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .conv_mma import block_moments

BM = 128                    # rows (voxels) per tile
KC = 32                     # K per x stage
LDX = KC + 8                # an x stage row in shared memory, bf16
STAGES = 4                  # x stages in the ring
SMEM_MAX = 232448           # 227 KB: the most a block may have


@dataclass(frozen=True)
class Plan:
    bn: int                     # columns per block
    rows: int                   # rows per tile (a partial row each)
    nchunks: int                # K chunks of 32
    smem: int                   # bytes of shared memory per block

    @property
    def warps_m(self) -> int:
        """Warps along M: 4 of 32 rows, or 8 of 16 at BN = 16."""
        return 8 if self.bn == 16 else 4


def plan(k: int, n: int, stats: bool = True, d2s: bool = False) -> Plan:
    """The kernel's tile (`gemm_mma.cuh` make_plan): BN the narrowest of
    16/32/64/128 covering N (K4's N = 8·Cout above 128 takes ⌈N/128⌉ column
    blocks); shared memory for w (all chunks), the ring of x stages and the
    epilogue's y tile, then the moments' warp rows (`stats`, K2) and each
    row's output corner (`d2s`, K4)."""
    if min(k, n) < 1:
        raise ValueError(f"gemm_mma: k {k} n {n}")
    bn = 16 if n <= 16 else 32 if n <= 32 else 64 if n <= 64 else 128
    nchunks = -(-k // KC)
    wm = 8 if bn == 16 else 4
    smem = ((nchunks * KC + BM) * (bn + 8) + STAGES * BM * LDX) * 2 \
        + (wm * 2 * bn * 4 if stats else 0) + (BM * 4 if d2s else 0)
    return Plan(bn, BM, nchunks, smem)


def tile_sums(x3: torch.Tensor, w: torch.Tensor, rows: int, kc: int):
    """A voxel-row tile's fp32 sums: x3 (B, V, K) and w (K, N) zero-padded
    to whole tiles of `rows` and K chunks of `kc`, summed chunk by chunk per
    tile → (B, tiles·rows, N).  This tile's walk (rows 128, chunks 32) and
    the fp32 FMA tile's (`ops/gemm_fma.py`) alike."""
    bsz, v, k = x3.shape
    n = w.shape[1]
    nblk, nchunks = -(-v // rows), -(-k // kc)
    xf = torch.zeros((bsz, nblk * rows, nchunks * kc))
    xf[:, :v, :k] = x3.float()
    wf = torch.zeros((nchunks * kc, n))
    wf[:k] = w.float()
    acc = torch.zeros((bsz, nblk * rows, n))
    for b in range(bsz):
        for i in range(nblk):
            rs = slice(i * rows, (i + 1) * rows)
            for c in range(nchunks):
                ks = slice(c * kc, (c + 1) * kc)
                acc[b, rs] += xf[b, rs, ks] @ wf[ks]
    return acc


def epilogue(acc: torch.Tensor, b: torch.Tensor | None, relu: bool,
             dtype: torch.dtype) -> torch.Tensor:
    """K7's epilogue on the fp32 sums: + b, ReLU, one rounding."""
    if b is not None:
        acc = acc + b.float()
    if relu:
        acc = acc.clamp_min(0.0)
    return acc.to(dtype)


def row_gemm_stats(x3: torch.Tensor, w: torch.Tensor):
    """K2's algorithm: x3 (B, V, K), w (K, N) → y (B, V, N) in x3's dtype,
    summed in fp32 chunk by chunk, and partial (B, ⌈V/128⌉, 2, N) fp32,
    each tile's moments of its rounded y over the rows < V."""
    bsz, v, k = x3.shape
    p = plan(k, w.shape[1])
    y = tile_sums(x3, w, p.rows, KC).to(x3.dtype).float()   # one rounding
    nblk = y.shape[1] // p.rows
    partial = torch.zeros((bsz, nblk, 2, w.shape[1]))
    rows = torch.arange(p.rows)
    mi = p.rows // p.warps_m // 16
    for b in range(bsz):
        for i in range(nblk):
            r0 = i * p.rows
            partial[b, i] = block_moments(y[b, r0:r0 + p.rows],
                                          r0 + rows < v, mi)
    return y[:, :v].to(x3.dtype), partial


def row_gemm(x3: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor | None = None,
             relu: bool = False) -> torch.Tensor:
    """K7's algorithm: x3 (B, V, K), w (K, N), b (N,) fp32 (already in
    w's dtype's values) or None → y (B, V, N) in x3's dtype: the chunked
    fp32 sums, + b, ReLU, one rounding."""
    v = x3.shape[1]
    return epilogue(tile_sums(x3, w, BM, KC)[:, :v], b, relu, x3.dtype)


def staged_transpose_w(w: torch.Tensor) -> torch.Tensor:
    """K4's w as the kernel stages it from the DHWIO kernel (2, 2, 2, Cin,
    Cout): column n = tap·Cout + co (tap = kd·4 + kh·2 + kw, the output
    offset it lands at) of row ci is flat tap 7 − tap, lax's flip on all
    three axes → (Cin, 8·Cout)."""
    cin, cout = w.shape[3:]
    flat = w.reshape(8, cin, cout)
    n = torch.arange(8 * cout)
    tap, co = n // cout, n % cout
    return flat[7 - tap, :, co].t()


def d2s_offsets(d: int, h: int, wd: int, cout: int):
    """K4's store within one batch item: (corner (V,), column offset (8·
    Cout,)); row m = (d, h, w) of the input volume lands its column n =
    tap·Cout + co at corner[m] + offset[n] of the (2D, 2H, 2W, Cout)
    output, corner the (2d, 2h, 2w) voxel, the tap (kd, kh, kw) kd planes,
    kh rows and kw voxels past it."""
    m = torch.arange(d * h * wd)
    md, mh, mw = m // (h * wd), m // wd % h, m % wd
    corner = ((2 * md * 2 * h + 2 * mh) * 2 * wd + 2 * mw) * cout
    n = torch.arange(8 * cout)
    tap, co = n // cout, n % cout
    offset = (((tap >> 2) * 2 * h + ((tap >> 1) & 1)) * 2 * wd
              + (tap & 1)) * cout + co
    return corner, offset


def transpose2x(x: torch.Tensor, w: torch.Tensor,
                relu: bool = False) -> torch.Tensor:
    """K4's algorithm: x (B, D, H, W, Cin), w (2, 2, 2, Cin, Cout) → y (B,
    2D, 2H, 2W, Cout) in x's dtype: the chunked fp32 sums of the voxel
    rows against the staged w, ReLU, one rounding, each value stored at
    its row's corner plus its column's offset."""
    bsz, d, h, wd, cin = x.shape
    cout = w.shape[4]
    rows = row_gemm(x.reshape(bsz, -1, cin), staged_transpose_w(w), None,
                    relu)
    corner, offset = d2s_offsets(d, h, wd, cout)
    y = torch.empty((bsz, 8 * d * h * wd * cout), dtype=x.dtype)
    y[:, (corner[:, None] + offset[None, :]).reshape(-1)] = \
        rows.reshape(bsz, -1)
    return y.view(bsz, 2 * d, 2 * h, 2 * wd, cout)
