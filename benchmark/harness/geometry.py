"""The hand kernels' launches at the flagship derived net's shapes, and
the least time they could take.
Frozen copy of chip_smoke.py's K1/K2/K5 geometry tables and of its
kernel checks' byte and operation counts, which counted the
launches exactly on the card.

Serving (fp32, a forward at batch 2) and training (bf16, one step of two
microbatches at batch 1) of the default path run K1 (3³ conv with its
GroupNorm moments), K1-dx (K1's input gradient), K2 (1³ conv with its
moments), K5a (moments of the other producers) and K5b (each GroupNorm's
backward sums).  Bytes count each input read once and each output written
once; operations count the multiply-adds as two.
"""

from __future__ import annotations

import torch

from .bounds import bound_ms

# serving, launches per forward at batch 2
# K1: (Cin, Cout, volume edge, dilation, launches)
K1_GEOMS = [(4, 48, 128, 1, 1),      # stem
            (32, 32, 64, 1, 5),      # down cell 1 (2), up cell level 1 (3)
            (64, 64, 32, 1, 5),      # down cell 2 (2), up cell level 2 (3)
            (128, 128, 16, 1, 2),    # down cell 3
            (16, 16, 128, 1, 3),     # up cell level 0
            (32, 32, 64, 2, 0)]      # dil_conv3: off the flagship path
# K2: (K, N, volume edge, launches)
K2_GEOMS = [(48, 32, 128, 2), (96, 64, 64, 1), (192, 128, 32, 1),
            (192, 64, 32, 1), (384, 64, 16, 1), (96, 32, 64, 1),
            (192, 32, 32, 1), (48, 16, 128, 1), (96, 16, 64, 1)]
# K5a: (C, volume edge, launches)
K5A_GEOMS = [(16, 128, 3), (32, 64, 5), (64, 32, 5), (64, 64, 2),
             (128, 16, 2), (128, 32, 2), (256, 16, 1)]
SERVE_BATCH = 2

# training, launches per step of two microbatches at batch 1
K1_TRAIN = [(ci, co, v, d, 2 * n) for ci, co, v, d, n in K1_GEOMS]
K1DX_TRAIN = [(co, ci, v, d, 2 * n) for ci, co, v, d, n in K1_GEOMS
              if ci != 4]            # dy (Cout) -> dx (Cin); no stem dx
K2_TRAIN = [(k, n, v, 2 * c) for k, n, v, c in K2_GEOMS]
K5A_TRAIN = [(c, v, 2 * n) for c, v, n in K5A_GEOMS]
# K5b: (C, volume edge, launches per step)
K5B_TRAIN = [(16, 64, 2), (16, 128, 14), (32, 32, 2), (32, 64, 22),
             (32, 128, 4), (48, 128, 2), (64, 16, 2), (64, 32, 22),
             (64, 64, 6), (128, 16, 8), (128, 32, 6), (256, 16, 2)]
TRAIN_BATCH = 1


def _conv(cin, cout, v, batch, dtype, stats):
    e = torch.tensor([], dtype=dtype).element_size()
    rows = batch * v ** 3
    return bound_ms((rows * (cin + cout) + 27 * cin * cout) * e
                    + (8 * batch * cout if stats else 0),
                    2.0 * rows * 27 * cin * cout, dtype)[0]


def _gemm(k, n, v, batch, dtype):
    e = torch.tensor([], dtype=dtype).element_size()
    rows = v ** 3
    return bound_ms((batch * rows * (k + n) + k * n) * e + 8 * batch * n,
                    2.0 * batch * rows * k * n, dtype)[0]


def _stats(c, v, batch, dtype, n_in):
    e = torch.tensor([], dtype=dtype).element_size()
    numel = batch * v ** 3 * c
    return bound_ms(n_in * numel * e + 8 * batch * c, 3.0 * numel, dtype)[0]


def bound_ms_per_unit(train: bool) -> float:
    """Σ over the hand kernels' launches of their least time: a train step
    (bf16) or a forward at batch 2 (fp32), in ms."""
    if train:
        dt, b = torch.bfloat16, TRAIN_BATCH
        return (sum(n * _conv(ci, co, v, b, dt, True)
                    for ci, co, v, _, n in K1_TRAIN)
                + sum(n * _conv(ci, co, v, b, dt, False)
                      for ci, co, v, _, n in K1DX_TRAIN)
                + sum(n * _gemm(k, m, v, b, dt) for k, m, v, n in K2_TRAIN)
                + sum(n * _stats(c, v, b, dt, 1) for c, v, n in K5A_TRAIN)
                + sum(n * _stats(c, v, b, dt, 2) for c, v, n in K5B_TRAIN))
    dt, b = torch.float32, SERVE_BATCH
    return (sum(n * _conv(ci, co, v, b, dt, True)
                for ci, co, v, _, n in K1_GEOMS)
            + sum(n * _gemm(k, m, v, b, dt) for k, m, v, n in K2_GEOMS)
            + sum(n * _stats(c, v, b, dt, 1) for c, v, n in K5A_GEOMS))


def launches_per_unit(train: bool) -> dict:
    """{kernel: launches} of a train step or of a forward at batch 2, as
    the program's launch counter names them."""
    if train:
        tables = {"conv3x3x3_stats": K1_TRAIN, "conv3x3x3": K1DX_TRAIN,
                  "gemm_stats": K2_TRAIN, "moments": K5A_TRAIN,
                  "weighted_sums": K5B_TRAIN}
    else:
        tables = {"conv3x3x3_stats": K1_GEOMS, "gemm_stats": K2_GEOMS,
                  "moments": K5A_GEOMS}
    return {k: sum(r[-1] for r in rows) for k, rows in tables.items()}
