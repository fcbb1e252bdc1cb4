"""The plan of the fp32 FMA conv tile behind K1, K1-dx and K6 in fp32
(`csrc/conv_fma.cuh`), and that kernel's algorithm in plain PyTorch.

The kernel (launched by `pgemm.conv3x3x3_stats`, `pgemm.conv3x3x3` and
`conv3d.conv3d` on fp32 CUDA tensors) gives each block a brick of output
voxels and a slice of output channels, stages the brick's input halo once
per 4-channel chunk for all 27 taps, and has each thread sum an 8 × TN
register tile (its 8 output voxels along W × TN channels) from the halo
row it reads once per (channel, kd, kh) for the three kw taps; for K1 its
epilogue also sums the moments of y per block.  Its host side picks the
tile from the shapes:

  `plan(cin, cout, stride, dilation)`  the block's output channels BN, its
      output brick (BD, 8, 8), the halo brick and its W pitch in shared
      memory, the 4-channel chunks, the shared-memory stages (2 where both
      fit half an SM) and bytes.  The C function `conv_fma_plan` returns
      the same numbers (chip_smoke.py holds the two equal on the card).
  `fma_conv(x, w, b, stride, dilation, pads, relu, stats)`  the kernel's
      algorithm on the CPU (`conv_mma.brick_conv`, the walk both conv tiles
      share, at this tile's bricks, 4-channel chunks and halo pitch): per
      brick and chunk the zero-filled halo, per tap the (BM, 4) @ (4, Cout)
      product of the rows at the shifted halo positions, then bias, ReLU
      and the masked store; with `stats` also the per-block moments
      partials (`block_moments`) in block order.  No path runs it; the
      tests hold it against the twins and the JAX functions, which checks
      the kernel's indexing where no card is.
  `block_moments(y, keep)`  the moments epilogue: one block's column sums
      of y and y² over the rows it keeps, in the kernel's fixed order.

The bricks run in `conv_mma.bricks`' order, which both tiles share.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .conv_mma import brick_conv, bricks, halo_edge

THREADS = 256
KC = 4                      # input channels per stage
BH = BW = 8                 # the output brick's H and W: a thread's row
TAPS = 27
SMEM_MAX = 232448           # 227 KB: the most a block may have
SMEM_TWO_BLOCKS = 113 * 1024


def tile_n(bn: int) -> int:
    """A thread's output channels."""
    return 8 if bn >= 64 else 4


def brick_depth(bn: int) -> int:
    """One thread per row of 8 voxels: 256 / (BN / TN) rows of 8 x BD."""
    return THREADS // (bn // tile_n(bn)) // BH


def halo_pitch(stride: int, dilation: int) -> int:
    """The halo's W extent in shared memory: odd, so the rows a warp reads
    fall in distinct banks."""
    return halo_edge(BW, stride, dilation) | 1


@dataclass(frozen=True)
class Plan:
    bn: int                     # output channels per block
    brick: tuple                # output voxels per block (BD, 8, 8)
    halo: tuple                 # input voxels a brick reads
    pitch: int                  # the halo's W extent in shared memory
    nchunks: int                # 4-channel chunks of Cin
    nbuf: int                   # chunk stages in shared memory
    smem: int                   # bytes of shared memory per block

    @property
    def rows(self) -> int:
        return self.brick[0] * self.brick[1] * self.brick[2]


def plan(cin: int, cout: int, stride: int = 1, dilation: int = 1) -> Plan:
    """The kernel's tile for these shapes (`conv_fma.cuh` make_plan): BN
    the narrowest of 16/32/64/128 covering Cout; two stages where both fit
    half an SM."""
    if min(cin, cout) < 1 or stride not in (1, 2) or dilation not in (1, 2):
        raise ValueError(f"conv_fma: cin {cin} cout {cout} stride {stride} "
                         f"dilation {dilation}")
    bn = 16 if cout <= 16 else 32 if cout <= 32 else 64 if cout <= 64 else 128
    brick = (brick_depth(bn), BH, BW)
    halo = tuple(halo_edge(e, stride, dilation) for e in brick)
    pitch = halo_pitch(stride, dilation)
    stage = (halo[0] * halo[1] * pitch * KC + KC * TAPS * bn) * 4
    nchunks = -(-cin // KC)
    nbuf = 2 if nchunks > 1 and 2 * stage <= SMEM_TWO_BLOCKS else 1
    return Plan(bn, brick, halo, pitch, nchunks, nbuf, nbuf * stage)


def block_moments(y: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """(2, C) fp32 (Σy, Σy²) of one block's rows y (BM, C) where `keep`
    (BM,), in the kernel's order: row r = ty·8 + j is voxel j of thread row
    ty; each thread sums its 8 voxels in j order, then the thread rows are
    summed in ty order."""
    bm, c = y.shape
    v = torch.where(keep[:, None], y.float(), 0.0)
    out = []
    for t in (v, v * v):
        t = t.view(bm // BW, BW, c)
        acc = torch.zeros((bm // BW, c))
        for j in range(BW):                           # this thread's voxels
            acc = acc + t[:, j]
        total = torch.zeros(c)
        for ty in range(acc.shape[0]):                # the rows, in order
            total = total + acc[ty]
        out.append(total)
    return torch.stack(out)


def fma_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
             stride: int = 1, dilation: int = 1, pads=None,
             relu: bool = False, stats: bool = False):
    """The kernel's algorithm: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout),
    b (Cout,) or None, `pads` the low-side pads (D, H, W) (default: the
    dilation, the stride-1 SAME pad) → y (B, ⌈D/s⌉, ⌈H/s⌉, ⌈W/s⌉, Cout)
    fp32, summed chunk by chunk, tap by tap.  `stats`: (y, partial),
    partial (B, bricks, 2, Cout) fp32 each block's moments of its y inside
    the volume, in block order."""
    p = plan(x.shape[4], w.shape[4], stride, dilation)
    return brick_conv(x.float(), w, b, stride, dilation, pads, relu, stats,
                      p, KC, p.pitch, block_moments)
