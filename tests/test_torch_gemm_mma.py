"""The tensor-core GEMM's host side and algorithm (nas_3d_unet_tpu_torch/
ops/gemm_mma.py), on the CPU, where its kernel (csrc/gemm_mma.cuh) cannot
run: the plan fits shared memory and its blocks cover every row once at
every K2, K7 and K4 geometry chip_smoke.py checks, and the kernel's
algorithm equals the twins and the JAX functions it replaces in bf16:
  K2 (per 128-row block the chunk-by-chunk product, one rounding, the
     moments of the rounded y per block) against K2's twin and
     `gemm_stats` in interpret mode;
  K7 (the same product, bias and ReLU on the fp32 sum, one rounding)
     against K7's twin and `pointwise_conv` under
     `pltpu.force_tpu_interpret_mode()`;
  K4 (the DHWIO kernel staged with lax's flip, the product, ReLU, one
     rounding, the depth-to-space store) against K4's twin and
     `conv_transpose2x` the same way.

Limits are chip_smoke.py's: y within 1 bf16 ulp (the fp32 sum over K <=
192 runs in another order before the one rounding); in fp32 within 1e-5
(rtol and atol: the same sums in another order); the moments against
float64 sums of the mirror's own rounded y within MOM_STORED_RTOL (1e-6
of Σ|y|, and relative on Σy²), against the twin's and the reference's
(whose y may round an ulp apart) within MOM_RTOL (1e-3).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from jax.experimental.pallas import tpu as pltpu

from nas_3d_unet_tpu.ops.pallas.conv3d import (conv_transpose2x,
                                               pointwise_conv)
from nas_3d_unet_tpu.ops.pallas.pgemm import gemm_stats as jax_gemm_stats
from nas_3d_unet_tpu_torch.ops import _cuda, conv3d, gemm_mma, pgemm
from nas_3d_unet_tpu_torch.ops.stats import moments_twin
from tests.test_torch_conv_mma import _moments_within
from tests.test_torch_pgemm import _bf16_ulps
from tests.torch_helpers import one_torch_thread  # noqa: F401

HEADER = (Path(gemm_mma.__file__).resolve().parents[1] / "csrc"
          / "gemm_mma.cuh")
BF16 = torch.bfloat16

# (K, N, rows) of every K2 launch chip_smoke.py checks, on the path and off
GEOMS = [(k, n, cs.math.prod(cs._volume(v)))
         for k, n, v, _ in cs.K2_TRAIN + cs.K2_EXTRA]
# (K, N, stats, d2s) of every K7 and K4 launch chip_smoke.py checks (K4:
# N = 8·Cout)
EPI_GEOMS = sorted(
    {(c, c, False, False) for c, _, _ in cs.P_K7}
    | {(ci, co, False, False) for ci, co, _, _ in cs.P_K7_EXTRA}
    | {(c, 8 * c, False, True) for c, _, _ in cs.P_K4}
    | {(ci, 8 * co, False, True) for ci, co, _, _ in cs.P_K4_EXTRA})
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


# K7: (K, N, V, bias scale or None, ReLU): K or N not a multiple of 8, V
# ragged, a bias whose bf16 rounding matters (scale 37)
K7_CASES = [(40, 24, 300, None, False), (12, 7, 37, None, True),
            (48, 16, 256, 37.0, True), (96, 64, 129, 0.5, False),
            (128, 128, 200, 37.0, False), (20, 33, 130, 1.0, True)]
# K4: (Cin, Cout, input volume, ReLU): N = 8·Cout above 128 (Cout 24, 64),
# Cin 12 -> Cout 5 (scalar copies), ragged volumes
K4_CASES = [(16, 24, (3, 5, 7), False), (32, 64, (2, 3, 3), True),
            (12, 5, (3, 4, 5), False), (16, 16, (5, 6, 7), True),
            (8, 3, (1, 2, 3), True)]
FP_TOL = 1e-5


@pytest.mark.parametrize("k,n,stats,d2s", EPI_GEOMS)
def test_plan_without_moments_fits_and_covers_n(k, n, stats, d2s):
    """K7's and K4's plan: no moments rows, K4's row corners; BN covers N
    at N <= 128, and ⌈N/128⌉ column blocks of 128 cover K4's N above."""
    p = gemm_mma.plan(k, n, stats, d2s)
    with_moments = gemm_mma.plan(k, n)
    assert p.smem <= gemm_mma.SMEM_MAX
    assert p.smem == with_moments.smem - p.warps_m * 2 * p.bn * 4 \
        + (gemm_mma.BM * 4 if d2s else 0)
    assert (p.bn >= n) if n <= 128 else (p.bn == 128)


def _bias(n, scale, seed):
    """An fp32 bias as the K7 wrapper hands it to the kernel: rounded to
    bf16 (the reference adds it as a bf16 row of w)."""
    return None if scale is None else \
        _rand((n,), seed, scale).to(BF16).float()


@pytest.mark.parametrize("k,n,v,scale,relu", K7_CASES)
def test_row_gemm_matches_k7_twin(k, n, v, scale, relu):
    x3, w = _operands(k, n, v, 500 + k)
    b = _bias(n, scale, 510 + n)
    y = gemm_mma.row_gemm(x3, w, b, relu)
    assert y.shape == (2, v, n) and y.dtype == BF16
    yt = conv3d.pointwise_conv_twin(x3, w, b, relu)
    assert _bf16_ulps(y.float(), yt.float()).max() <= 1


@pytest.mark.parametrize("k,n,v,scale,relu", K7_CASES[:3])
def test_row_gemm_matches_k7_twin_in_fp32(k, n, v, scale, relu):
    x3, w = (t.float() for t in _operands(k, n, v, 520 + k))
    b = None if scale is None else _rand((n,), 530 + n, scale)
    np.testing.assert_allclose(
        gemm_mma.row_gemm(x3, w, b, relu).numpy(),
        conv3d.pointwise_conv_twin(x3, w, b, relu).numpy(), rtol=FP_TOL,
        atol=FP_TOL)


@pytest.mark.parametrize("k,n,v,scale,relu", [K7_CASES[1], K7_CASES[2],
                                              K7_CASES[4]])
def test_row_gemm_matches_pointwise_conv_interpret(k, n, v, scale, relu):
    """Against the reference's K7 (bf16, the bias unrounded fp32 on its
    side: its kernel rounds it into w's dtype itself)."""
    x3, w = _operands(k, n, v, 540 + k)
    b32 = None if scale is None else _rand((n,), 550 + n, scale)
    j16 = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jy = pointwise_conv(j16(x3).reshape(2, v, 1, 1, k), j16(w),
                            None if b32 is None else jnp.asarray(b32.numpy()),
                            relu=relu)
    jy = torch.from_numpy(np.array(jy.astype(jnp.float32))).view(2, v, n)
    b = None if b32 is None else b32.to(BF16).float()
    y = gemm_mma.row_gemm(x3, w, b, relu)
    assert _bf16_ulps(y.float(), jy).max() <= 1


def test_staged_transpose_w_is_lax_s_flip():
    """The kernel's staging of the DHWIO kernel equals the fp32 wrapper's
    flipped, flattened copy (the reference's `wmat`) bit for bit."""
    w = _rand((2, 2, 2, 6, 5), 600)
    want = w.flip(0, 1, 2).permute(3, 0, 1, 2, 4).reshape(6, 40)
    assert torch.equal(gemm_mma.staged_transpose_w(w), want)


@pytest.mark.parametrize("vol,cout", [((3, 5, 7), 24), ((1, 2, 3), 3)])
def test_d2s_offsets_write_each_output_once(vol, cout):
    corner, offset = gemm_mma.d2s_offsets(*vol, cout)
    flat = (corner[:, None] + offset[None, :]).reshape(-1)
    assert torch.equal(flat.sort().values,
                       torch.arange(8 * cs.math.prod(vol) * cout))


def _k4_operands(cin, cout, vol, seed):
    x = _rand((2, *vol, cin), seed).to(BF16)
    w = _rand((2, 2, 2, cin, cout), seed + 1, cin ** -0.5).to(BF16)
    return x, w


@pytest.mark.parametrize("cin,cout,vol,relu", K4_CASES)
def test_transpose2x_matches_k4_twin(cin, cout, vol, relu):
    x, w = _k4_operands(cin, cout, vol, 700 + cin + cout)
    y = gemm_mma.transpose2x(x, w, relu)
    yt = conv3d.conv_transpose2x_twin(x, w, relu)
    assert y.shape == yt.shape == (2, *(2 * s for s in vol), cout)
    assert y.dtype == BF16
    assert _bf16_ulps(y.float(), yt.float()).max() <= 1


@pytest.mark.parametrize("cin,cout,vol,relu", K4_CASES[:3])
def test_transpose2x_matches_k4_twin_in_fp32(cin, cout, vol, relu):
    x, w = (t.float() for t in _k4_operands(cin, cout, vol, 720 + cin))
    np.testing.assert_allclose(
        gemm_mma.transpose2x(x, w, relu).numpy(),
        conv3d.conv_transpose2x_twin(x, w, relu).numpy(), rtol=FP_TOL,
        atol=FP_TOL)


@pytest.mark.parametrize("cin,cout,vol,relu", K4_CASES[:3])
def test_transpose2x_matches_conv_transpose2x_interpret(cin, cout, vol,
                                                         relu):
    x, w = _k4_operands(cin, cout, vol, 740 + cin)
    j16 = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jy = conv_transpose2x(j16(x), j16(w), relu=relu)
    jy = torch.from_numpy(np.array(jy.astype(jnp.float32)))
    y = gemm_mma.transpose2x(x, w, relu)
    assert y.shape == jy.shape
    assert _bf16_ulps(y.float(), jy).max() <= 1


def test_k7_and_k4_count_no_launch_on_the_cpu():
    _cuda.LAUNCHES.clear()
    x, w = _k4_operands(12, 5, (1, 2, 3), 800)
    conv3d.conv_transpose2x(x, w, True)
    conv3d.pointwise_conv(x, w[0, 0, 0], _rand((5,), 801), True)
    assert not _cuda.LAUNCHES
