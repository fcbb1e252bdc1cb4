"""The tensor-core GEMM's host side and algorithm (nas_3d_unet_tpu_torch/
ops/gemm_mma.py), on the CPU, where its kernel (csrc/gemm_mma.cuh) cannot
run: the plan fits shared memory and its blocks cover every row once at
every K2 geometry chip_smoke.py checks, and the kernel's algorithm (per
128-row block the chunk-by-chunk product, one rounding, the moments of the
rounded y per block) equals K2's twin and the JAX function it replaces,
`gemm_stats` in interpret mode, in bf16.

Limits are chip_smoke.py's: y within 1 bf16 ulp; the moments against
float64 sums of the mirror's own rounded y within MOM_STORED_RTOL (1e-6 of
Σ|y|, and relative on Σy²), against the twin's and the reference's (whose y
may round an ulp apart) within MOM_RTOL (1e-3).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nas_3d_unet_tpu.ops.pallas.pgemm import gemm_stats as jax_gemm_stats
from nas_3d_unet_tpu_torch.ops import _cuda, gemm_mma, pgemm
from nas_3d_unet_tpu_torch.ops.stats import moments_twin
from tests.test_torch_conv_mma import _moments_within
from tests.test_torch_pgemm import _bf16_ulps

HEADER = (Path(gemm_mma.__file__).resolve().parents[1] / "csrc"
          / "gemm_mma.cuh")
BF16 = torch.bfloat16

# (K, N, rows) of every K2 launch chip_smoke.py checks, on the path and off
GEOMS = [(k, n, cs.math.prod(cs._volume(v)))
         for k, n, v, _ in cs.K2_TRAIN + cs.K2_EXTRA]
# K, N multiples of 8 and not, V a multiple of 128 and not
CASES = [(40, 24, 300), (12, 7, 37), (48, 16, 256), (192, 128, 200),
         (96, 64, 129), (20, 33, 130)]


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


def _operands(k, n, v, seed):
    x3 = _rand((2, v, k), seed).to(BF16)
    w = _rand((k, n), seed + 1, k ** -0.5).to(BF16)
    return x3, w


@pytest.mark.parametrize("k,n,rows", GEOMS)
def test_plan_fits_and_its_blocks_cover_each_row_once(k, n, rows):
    p = gemm_mma.plan(k, n)
    assert p.smem <= gemm_mma.SMEM_MAX
    assert p.bn in (16, 32, 64, 128) and p.bn >= n and p.rows == 128
    assert p.nchunks * gemm_mma.KC >= k > (p.nchunks - 1) * gemm_mma.KC
    nblk = -(-rows // p.rows)
    hits = np.zeros(nblk * p.rows, np.int32)
    for i in range(nblk):
        hits[i * p.rows:(i + 1) * p.rows] += 1
    assert (hits[:rows] == 1).all() and nblk * p.rows - rows < p.rows


def test_plan_mirrors_the_kernel_header():
    """The constants the plan shares with gemm_mma.cuh."""
    src = HEADER.read_text()
    found = dict(re.findall(r"constexpr int (k\w+) = (?:kKC \+ )?(\d+)",
                            src))
    want = {"kBM": gemm_mma.BM, "kKC": gemm_mma.KC,
            "kLdX": gemm_mma.LDX - gemm_mma.KC, "kStages": gemm_mma.STAGES,
            "kSmemMax": gemm_mma.SMEM_MAX}
    for name, value in want.items():
        assert int(found[name]) == value, name


def test_plan_refuses_what_the_kernel_refuses():
    for args in ((0, 8), (8, 0)):
        with pytest.raises(ValueError):
            gemm_mma.plan(*args)


@pytest.mark.parametrize("k,n,v", CASES)
def test_row_gemm_stats_matches_k2_twin(k, n, v):
    """y within 1 ulp of K2's twin; one partial row per 128-row block,
    summing to the moments of the mirror's own rounded y (the ragged last
    block's rows past V left out), and to the twin's within MOM_RTOL."""
    x3, w = _operands(k, n, v, 100 + k)
    y, partial = gemm_mma.row_gemm_stats(x3, w)
    assert y.shape == (2, v, n) and y.dtype == BF16
    assert partial.shape == (2, -(-v // 128), 2, n)
    yt, s1, s2 = pgemm.gemm_stats_twin(x3, w)
    assert _bf16_ulps(y.float(), yt.float()).max() <= 1
    got = partial.sum(1)
    assert cs._moments_err(got[:, 0], got[:, 1], y) <= cs.MOM_STORED_RTOL
    _moments_within(got, torch.stack(moments_twin(y), 1), y, 1e-6)
    _moments_within(got, torch.stack([s1, s2], 1), yt, cs.MOM_RTOL[BF16])


@pytest.mark.parametrize("k,n,v", [(40, 24, 300), (12, 7, 37)])
def test_row_gemm_stats_matches_gemm_stats_interpret(k, n, v):
    """Against the reference's K2 (`gemm_stats` in interpret mode, bf16,
    rows_pb 16: its own ragged tail masked): y within 1 ulp, the moments
    within MOM_RTOL."""
    x3, w = _operands(k, n, v, 200 + k)
    j16 = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jy, js1, js2 = jax_gemm_stats(j16(x3), j16(w), rows_pb=16,
                                  interpret=True)
    jy = torch.from_numpy(np.array(jy.astype(jnp.float32)))
    y, partial = gemm_mma.row_gemm_stats(x3, w)
    assert _bf16_ulps(y.float(), jy).max() <= 1
    want = torch.stack([torch.from_numpy(np.array(js1)),
                        torch.from_numpy(np.array(js2))], 1)
    _moments_within(partial.sum(1), want, jy, cs.MOM_RTOL[BF16])


@pytest.mark.parametrize("bn,mi", [(16, 1), (32, 2), (128, 2)])
def test_block_moments_order_is_the_kernel_s(bn, mi):
    """The warps' rows (16 at BN = 16, 32 above): each 8-row group's rows
    are summed by one thread, the 8 groups pairwise, then the warps in
    order; spelled out here row by row for one column."""
    y = _rand((128, 3), 300 + bn).to(BF16).float()
    got = gemm_mma.block_moments(y, torch.ones(128, dtype=torch.bool), mi)
    rows_w = mi * 16
    total = torch.zeros(3)
    for wm in range(128 // rows_w):
        lanes = []
        for g in range(8):
            t = torch.zeros(3)
            for j in range(2 * mi):
                t = t + y[wm * rows_w + j * 8 + g]
            lanes.append(t)
        while len(lanes) > 1:
            lanes = [lanes[i] + lanes[i + 1] for i in range(0, len(lanes), 2)]
        total = total + lanes[0]
    assert torch.equal(got[0], total)


def test_gemm_stats_counts_no_launch_on_the_cpu():
    _cuda.LAUNCHES.clear()
    x3, w = _operands(12, 7, 37, 400)
    pgemm.gemm_stats(x3, w)
    assert not _cuda.LAUNCHES
