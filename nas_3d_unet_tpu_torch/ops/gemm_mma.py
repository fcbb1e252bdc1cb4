"""The plan of the bf16 tensor-core GEMM behind K2 in bf16
(`csrc/gemm_mma.cuh`), and that kernel's algorithm in plain PyTorch.

The kernel (launched by `pgemm.gemm_stats` on bf16 CUDA tensors) cuts the
voxel rows into tiles of 128; each block stages w (BN output columns)
once and walks over its tiles, x in K chunks of 32 through a ring of
stages, sums one K = 16 MMA step at a time, rounds y once, and sums the
moments of each tile's rounded y in the fixed order of `csrc/moments.cuh`.
Its host side picks the tile from the shapes:

  `plan(k, n)`  the block's columns BN, its rows, the K chunks and the
      bytes of shared memory.  The C function `gemm_mma_plan` returns the
      same numbers (chip_smoke.py holds the two equal on the card).
  `row_gemm_stats(x3, w)`  the kernel's algorithm on the CPU in fp32:
      per tile of rows, the chunk-by-chunk product, one rounding, and the
      per-tile moments partials (B, tiles, 2, N) in tile order (whichever
      block takes a tile, its sums are the same).  No path runs it; the
      tests hold it against K2's twin and the JAX function it replaces,
      which checks the kernel's tiling and masking where no card is.
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


def plan(k: int, n: int) -> Plan:
    """The kernel's tile (`gemm_mma.cuh` make_plan): BN the narrowest of
    16/32/64/128 covering N; shared memory for w (all chunks), the ring of
    x stages, the epilogue's y tile and the moments' warp rows."""
    if min(k, n) < 1:
        raise ValueError(f"gemm_mma: k {k} n {n}")
    bn = 16 if n <= 16 else 32 if n <= 32 else 64 if n <= 64 else 128
    nchunks = -(-k // KC)
    wm = 8 if bn == 16 else 4
    smem = ((nchunks * KC + BM) * (bn + 8) + STAGES * BM * LDX) * 2 \
        + wm * 2 * bn * 4
    return Plan(bn, BM, nchunks, smem)


def row_gemm_stats(x3: torch.Tensor, w: torch.Tensor):
    """The kernel's algorithm: x3 (B, V, K), w (K, N) → y (B, V, N) in
    x3's dtype, summed in fp32 chunk by chunk, and partial (B, ⌈V/128⌉, 2,
    N) fp32, each tile's moments of its rounded y over the rows < V."""
    bsz, v, k = x3.shape
    n = w.shape[1]
    p = plan(k, n)
    nblk = -(-v // p.rows)
    xf = torch.zeros((bsz, nblk * p.rows, p.nchunks * KC))
    xf[:, :v, :k] = x3.float()
    wf = torch.zeros((p.nchunks * KC, n))
    wf[:k] = w.float()
    y = torch.zeros((bsz, nblk * p.rows, n))
    partial = torch.zeros((bsz, nblk, 2, n))
    rows = torch.arange(p.rows)
    mi = p.rows // p.warps_m // 16
    for b in range(bsz):
        for i in range(nblk):
            r0 = i * p.rows
            acc = torch.zeros((p.rows, n))
            for c in range(p.nchunks):
                acc += xf[b, r0:r0 + p.rows, c * KC:(c + 1) * KC] \
                    @ wf[c * KC:(c + 1) * KC]
            acc = acc.to(x3.dtype).float()                # one rounding
            y[b, r0:r0 + p.rows] = acc
            partial[b, i] = block_moments(acc, r0 + rows < v, mi)
    return y[:, :v].to(x3.dtype), partial
