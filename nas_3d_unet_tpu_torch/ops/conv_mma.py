"""The plan of the bf16 tensor-core conv behind K1, K1-dx and K6 in bf16
(`csrc/conv_mma.cuh`), and that kernel's algorithm in plain PyTorch.

The kernel (launched by `pgemm.conv3x3x3_stats`, `pgemm.conv3x3x3` and
`conv3d.conv3d` on bf16 CUDA tensors) gives each block a brick of output
voxels and a slice of output channels, stages the brick's input halo once
per 16-channel chunk for all 27 taps, and sums one K = 16 product per tap
read at each output voxel's shifted halo position; for K1 its epilogue
also sums the moments of the rounded y per block.  Its host side picks the
tile from the shapes:

  `plan(cin, cout, stride, dilation)`  the block's output channels BN, its
      output brick (BD, 8, 8), the halo brick, the 16-channel chunks, the
      shared-memory stages (2 where both fit half an SM) and bytes.  The C
      function `conv_mma_plan` returns the same numbers (chip_smoke.py holds
      the two equal on the card).
  `bricks(out_shape, p)`  each block's output corner, in block order.
  `shifted_gemm_conv(x, w, b, stride, dilation, pads, relu, stats)`  the
      kernel's algorithm on the CPU in fp32: per brick and chunk the
      zero-filled halo brick, per tap the (BM, 16) @ (16, Cout) product of
      the rows at the shifted halo positions, then bias, ReLU, one rounding
      and the masked store; with `stats` also the per-block moments
      partials (`block_moments`) in block order.  No path runs it; the
      tests hold it against the twins and the JAX functions, which checks
      the kernel's indexing where no card is.  Its walk over bricks, chunks
      and taps, `brick_conv`, is shared with the fp32 tile's mirror
      (`ops/conv_fma.py`).
  `block_moments(y, keep, mi)`  the moments epilogue of `csrc/moments.cuh`
      (shared with the tensor-core GEMM, `ops/gemm_mma.py`): one block's
      column sums of y and y² over the rows it keeps, in the kernel's fixed
      order.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import torch

KC = 16                     # input channels per stage: one MMA K step
BH = BW = 8                 # the output brick's H and W
TAPS = 27
LDX = KC + 8                # a halo voxel's row in shared memory, bf16
SMEM_MAX = 232448           # 227 KB: the most a block may have
SMEM_TWO_BLOCKS = 113 * 1024


def brick_depth(bn: int) -> int:
    return 4 if bn == 16 else 2


def halo_edge(edge: int, stride: int, dilation: int) -> int:
    """Input voxels along one axis that `edge` output voxels read."""
    return (edge - 1) * stride + 2 * dilation + 1


def stage_bytes(bn: int, stride: int, dilation: int) -> int:
    """One chunk's shared memory: the halo brick and 27 weight slices."""
    halo = (halo_edge(brick_depth(bn), stride, dilation)
            * halo_edge(BH, stride, dilation)
            * halo_edge(BW, stride, dilation))
    return (halo * LDX + TAPS * KC * (bn + 8)) * 2


@dataclass(frozen=True)
class Plan:
    bn: int                     # output channels per block
    brick: tuple                # output voxels per block (BD, 8, 8)
    halo: tuple                 # input voxels a brick reads
    nchunks: int                # 16-channel chunks of Cin
    nbuf: int                   # chunk stages in shared memory
    smem: int                   # bytes of shared memory per block

    @property
    def rows(self) -> int:
        return self.brick[0] * self.brick[1] * self.brick[2]


def plan(cin: int, cout: int, stride: int = 1, dilation: int = 1) -> Plan:
    """The kernel's tile for these shapes (`conv_mma.cuh` make_plan): BN
    the narrowest of 16/32/64/128 covering Cout, halved while one stage
    would not fit 227 KB; two stages where both fit half an SM."""
    if min(cin, cout) < 1 or stride not in (1, 2) or dilation not in (1, 2):
        raise ValueError(f"conv_mma: cin {cin} cout {cout} stride {stride} "
                         f"dilation {dilation}")
    bn = 16 if cout <= 16 else 32 if cout <= 32 else 64 if cout <= 64 else 128
    while bn > 32 and stage_bytes(bn, stride, dilation) > SMEM_MAX:
        bn //= 2
    nchunks = -(-cin // KC)
    stage = stage_bytes(bn, stride, dilation)
    nbuf = 2 if nchunks > 1 and 2 * stage <= SMEM_TWO_BLOCKS else 1
    brick = (brick_depth(bn), BH, BW)
    halo = tuple(halo_edge(e, stride, dilation) for e in brick)
    return Plan(bn, brick, halo, nchunks, nbuf, nbuf * stage)


def bricks(out_shape, p: Plan):
    """The output corner (od0, oh0, ow0) of every block along blockIdx.x,
    in the kernel's order (W fastest); a brick may reach past the volume,
    whose voxels the kernel does not store."""
    n = [-(-o // e) for o, e in zip(out_shape, p.brick)]
    for i in range(n[0] * n[1] * n[2]):
        yield ((i // (n[1] * n[2])) * p.brick[0],
               (i // n[2]) % n[1] * p.brick[1], i % n[2] * p.brick[2])


def block_moments(y: torch.Tensor, keep: torch.Tensor,
                  mi: int) -> torch.Tensor:
    """(2, C) fp32 (Σy, Σy²) of one block's rows y (BM, C) (the rounded
    values, as fp32) where `keep` (BM,), in `csrc/moments.cuh`'s order.
    Row r = ((wm·mi + i)·2 + hr)·8 + g belongs to warp wm (along M), MMA
    tile i < mi, half hr and row group g = lane / 4: each thread sums its
    rows in (i, hr) order, the eight row groups are summed by the xor-4,
    -8, -16 butterfly, then the warps in order."""
    bm, c = y.shape
    v = torch.where(keep[:, None], y.float(), 0.0)
    out = []
    for t in (v, v * v):        # y² of a bf16 y is exact in fp32
        t = t.view(bm // (mi * 16), mi * 2, 8, c)
        acc = torch.zeros((t.shape[0], 8, c))
        for j in range(mi * 2):                       # this thread's rows
            acc = acc + t[:, j]
        for _ in range(3):                            # xor 4, 8, 16
            acc = acc[:, 0::2] + acc[:, 1::2]
        total = torch.zeros(c)
        for wm in range(acc.shape[0]):                # the warps, in order
            total = total + acc[wm, 0]
        out.append(total)
    return torch.stack(out)


def shifted_gemm_conv(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None, stride: int = 1,
                      dilation: int = 1, pads=None, relu: bool = False,
                      stats: bool = False):
    """The kernel's algorithm: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout),
    b (Cout,) or None, `pads` the low-side pads (D, H, W) (default: the
    dilation, the stride-1 SAME pad) → y (B, ⌈D/s⌉, ⌈H/s⌉, ⌈W/s⌉, Cout)
    in x's dtype, summed in fp32 chunk by chunk, tap by tap.  `stats`:
    (y, partial), partial (B, bricks, 2, Cout) fp32 each block's moments
    of its rounded y inside the volume, in block order."""
    p = plan(x.shape[4], w.shape[4], stride, dilation)
    return brick_conv(x, w, b, stride, dilation, pads, relu, stats, p, KC,
                      p.halo[2], lambda y, keep: block_moments(y, keep, 2))


def brick_conv(x, w, b, stride, dilation, pads, relu, stats, p, kc, pitch,
               moments):
    """The brick-and-tap walk both conv tiles share (this one and
    `ops/conv_fma.py`'s): per brick of `p` (`.brick`, `.halo`, `.rows`,
    `.nchunks`) and chunk of `kc` input channels, the zero-filled halo with
    W extent `pitch`; per tap the (rows, kc) @ (kc, Cout) product of the
    rows at the shifted halo positions; then bias, ReLU, one rounding to
    x's dtype and the masked store; with `stats` also each block's moments
    partials, `moments(y, keep)`."""
    bsz, *vol, cin = x.shape
    cout = w.shape[4]
    pads = (dilation,) * 3 if pads is None else tuple(pads)
    out = [-(-v // stride) for v in vol]
    hd, hh, _ = p.halo
    xf = x.float()
    wf = w.float().reshape(TAPS, cin, cout)
    r = torch.arange(p.rows)
    rd, rh, rw = r // (BH * BW), (r // BW) % BH, r % BW
    # the halo voxel of row r at tap (0, 0, 0); tap (kd, kh, kw) adds
    # dilation · ((kd·HH + kh)·pitch + kw)
    hb = (rd * stride * hh + rh * stride) * pitch + rw * stride
    toff = [dilation * ((kd * hh + kh) * pitch + kw)
            for kd, kh, kw in itertools.product(range(3), repeat=3)]
    y = torch.zeros((bsz, *out, cout))
    corners = list(bricks(out, p))
    partial = torch.zeros((bsz, len(corners), 2, cout))
    for n in range(bsz):
        for i, corner in enumerate(corners):
            i0 = [o * stride - pd for o, pd in zip(corner, pads)]
            # the in-volume part of the halo: [lo, hi) of x, from lo - i0
            lo = [max(i, 0) for i in i0]
            hi = [min(i + e, v) for i, e, v in zip(i0, p.halo, vol)]
            acc = torch.zeros((p.rows, cout))
            for c in range(p.nchunks):
                c0, c1 = c * kc, min(c * kc + kc, cin)
                halo = torch.zeros((hd, hh, pitch, kc))
                if all(h > l for l, h in zip(lo, hi)):
                    halo[lo[0] - i0[0]:hi[0] - i0[0],
                         lo[1] - i0[1]:hi[1] - i0[1],
                         lo[2] - i0[2]:hi[2] - i0[2], :c1 - c0] = xf[
                        n, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2], c0:c1]
                flat = halo.reshape(-1, kc)
                wc = torch.zeros((TAPS, kc, cout))
                wc[:, :c1 - c0] = wf[:, c0:c1]
                for t in range(TAPS):
                    acc += flat[hb + toff[t]] @ wc[t]
            if b is not None:
                acc = acc + b.float()
            if relu:
                acc = acc.relu()
            od, oh, ow = (rd + corner[0], rh + corner[1], rw + corner[2])
            keep = (od < out[0]) & (oh < out[1]) & (ow < out[2])
            acc = acc.to(x.dtype).float()                 # one rounding
            y[n, od[keep], oh[keep], ow[keep]] = acc[keep]
            if stats:
                partial[n, i] = moments(acc, keep)
    y = y.to(x.dtype)
    return (y, partial) if stats else y
