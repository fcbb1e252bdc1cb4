"""The fp32 voxel-row FMA tile's host side and algorithm
(nas_3d_unet_tpu_torch/ops/gemm_fma.py), on the CPU, where its kernel
(csrc/gemm_fma.cuh) cannot run: the plan fits shared memory and its tiles
cover every row once at every K2 and K7 geometry chip_smoke.py checks, and
the kernel's algorithm equals the twins and the JAX functions it replaces
in fp32:
  K2 (per tile of rows the chunk-by-chunk product, and the moments of
     each tile's y in the kernel's order) against K2's twin and
     `gemm_stats` in interpret mode;
  K7 (the same product, then the bias and the ReLU) against K7's twin and
     `pointwise_conv` under `pltpu.force_tpu_interpret_mode()`.

Limits: y within FP_TOL 1e-5 (rtol and atol: the same fp32 sums in
another order); the moments within chip_smoke.py's MOM_RTOL (Σy over Σ|y|,
Σy² relative).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from jax.experimental.pallas import tpu as pltpu

from nas_3d_unet_tpu.ops.pallas.conv3d import pointwise_conv
from nas_3d_unet_tpu.ops.pallas.pgemm import gemm_stats as jax_gemm_stats
from nas_3d_unet_tpu_torch.ops import _cuda, conv3d, gemm_fma, pgemm
from tests.test_torch_conv_mma import _moments_within

HEADER = (Path(gemm_fma.__file__).resolve().parents[1] / "csrc"
          / "gemm_fma.cuh")
F32 = torch.float32
FP_TOL = 1e-5
MOM_TOL = cs.MOM_RTOL[F32]

# (K, N, rows, stats) of every K2 (moments) and K7 launch chip_smoke.py
# checks, on the path and off
PLAN_GEOMS = sorted(
    {(k, n, cs.math.prod(cs._volume(v)), True)
     for k, n, v, _ in cs.K2_GEOMS + cs.K2_EXTRA}
    | {(c, c, 2 * v ** 3, False) for c, v, _ in cs.P_K7}
    | {(ci, co, 2 * cs.math.prod(cs._volume(v)), False)
       for ci, co, v, _ in cs.P_K7_EXTRA})
# K and N multiples of 4 and not, each BN class (N 16, 32, 64, 128), K
# over several chunks (384), V a multiple of the tile and not
K2_CASES = [(12, 7, 37), (40, 24, 300), (48, 16, 256), (96, 64, 129),
            (192, 128, 200), (384, 64, 131), (20, 33, 130)]
# K7: (K, N, V, bias scale or None, ReLU)
K7_CASES = [(16, 16, 300, None, False), (12, 7, 37, None, True),
            (32, 32, 257, 0.5, True), (64, 64, 129, 37.0, False),
            (128, 128, 200, 1.0, True)]


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


def _operands(k, n, v, seed):
    return _rand((2, v, k), seed), _rand((k, n), seed + 1, k ** -0.5)


@pytest.mark.parametrize("k,n,rows,stats", PLAN_GEOMS)
def test_plan_fits_and_its_tiles_cover_each_row_once(k, n, rows, stats):
    p = gemm_fma.plan(k, n, stats)
    assert p.smem <= gemm_fma.SMEM_MAX
    assert p.bn in (16, 32, 64, 128) and p.bn >= n
    assert p.rows == gemm_fma.tile_rows(p.bn) in (128, 256)
    assert p.stages in (2, 3, 4)
    assert p.nchunks * gemm_fma.KC >= k > (p.nchunks - 1) * gemm_fma.KC
    # each thread's rows ty + i·TY, over the tile's threads, and the tiles
    ty_n = gemm_fma.THREADS // (p.bn // gemm_fma.tile_n(p.bn))
    ntiles = -(-rows // p.rows)
    offs = (np.arange(ty_n)[:, None]
            + np.arange(gemm_fma.tile_m(p.bn))[None, :] * ty_n).ravel()
    idx = (np.arange(ntiles)[:, None] * p.rows + offs[None, :]).ravel()
    hits = np.bincount(idx, minlength=ntiles * p.rows)
    assert (hits == 1).all() and ntiles * p.rows - rows < p.rows


def test_plan_keeps_two_blocks_where_the_stages_allow():
    """Two blocks an SM at the 128³ rows, which hold most of the bytes."""
    for k, n, stats in ((48, 32, True), (48, 16, True), (16, 16, False)):
        assert gemm_fma.plan(k, n, stats).smem <= gemm_fma.SMEM_TWO_BLOCKS


def test_plan_mirrors_the_kernel_header():
    """The constants the plan shares with gemm_fma.cuh."""
    src = HEADER.read_text()
    found = dict(re.findall(r"constexpr int (k\w+) = (?:kKC \+ )?(\d+)",
                            src))
    want = {"kThreads": gemm_fma.THREADS, "kKC": gemm_fma.KC,
            "kLdX": gemm_fma.LDX - gemm_fma.KC,
            "kSmemMax": gemm_fma.SMEM_MAX}
    for name, value in want.items():
        assert int(found[name]) == value, name
    assert "kSmemTwoBlocks = 113 * 1024" in src


def test_plan_refuses_what_the_kernel_refuses():
    for args in ((0, 8), (8, 0)):
        with pytest.raises(ValueError):
            gemm_fma.plan(*args)


@pytest.mark.parametrize("k,n,v", K2_CASES)
def test_row_gemm_stats_matches_k2_twin(k, n, v):
    """y within FP_TOL of K2's twin; one partial row per tile, summing to
    the twin's moments within MOM_RTOL."""
    x3, w = _operands(k, n, v, 100 + k)
    y, partial = gemm_fma.row_gemm_stats(x3, w)
    p = gemm_fma.plan(k, n)
    assert y.shape == (2, v, n) and y.dtype == F32
    assert partial.shape == (2, -(-v // p.rows), 2, n)
    yt, s1, s2 = pgemm.gemm_stats_twin(x3, w)
    np.testing.assert_allclose(y.numpy(), yt.numpy(), rtol=FP_TOL,
                               atol=FP_TOL)
    _moments_within(partial.sum(1), torch.stack([s1, s2], 1), yt, MOM_TOL)


@pytest.mark.parametrize("k,n,v", [(40, 24, 300), (12, 7, 37),
                                   (96, 64, 129)])
def test_row_gemm_stats_matches_gemm_stats_interpret(k, n, v):
    """Against the reference's K2 (`gemm_stats` in interpret mode, fp32,
    rows_pb 16: its own ragged tail masked)."""
    x3, w = _operands(k, n, v, 200 + k)
    jy, js1, js2 = jax_gemm_stats(jnp.asarray(x3.numpy()),
                                  jnp.asarray(w.numpy()), rows_pb=16,
                                  interpret=True)
    jy = torch.from_numpy(np.array(jy))
    y, partial = gemm_fma.row_gemm_stats(x3, w)
    np.testing.assert_allclose(y.numpy(), jy.numpy(), rtol=FP_TOL,
                               atol=FP_TOL)
    want = torch.stack([torch.from_numpy(np.array(js1)),
                        torch.from_numpy(np.array(js2))], 1)
    _moments_within(partial.sum(1), want, jy, MOM_TOL)


@pytest.mark.parametrize("bn", [16, 32, 64, 128])
def test_tile_moments_order_is_the_kernel_s(bn):
    """Each thread row's TM rows in order, the warp's thread rows pairwise,
    then the 8 warps in order; spelled out here row by row, the last rows
    of the tile past V left out."""
    rows = gemm_fma.tile_rows(bn)
    y = _rand((rows, 3), 300 + bn)
    keep = torch.arange(rows) < rows - 5
    got = gemm_fma.tile_moments(y, keep, bn)
    ty_n = gemm_fma.THREADS // (bn // gemm_fma.tile_n(bn))
    per_warp = ty_n // gemm_fma.WARPS
    ym = torch.where(keep[:, None], y, 0.0)
    for s, vals in enumerate((ym, ym * ym)):
        total = torch.zeros(3)
        for wp in range(gemm_fma.WARPS):
            lanes = []
            for ty in range(wp * per_warp, (wp + 1) * per_warp):
                t = torch.zeros(3)
                for i in range(gemm_fma.tile_m(bn)):
                    t = t + vals[ty + i * ty_n]
                lanes.append(t)
            while len(lanes) > 1:
                lanes = [lanes[i] + lanes[i + 1]
                         for i in range(0, len(lanes), 2)]
            total = total + lanes[0]
        assert torch.equal(got[s], total)


@pytest.mark.parametrize("k,n,v,scale,relu", K7_CASES)
def test_row_gemm_matches_k7_twin(k, n, v, scale, relu):
    x3, w = _operands(k, n, v, 500 + k)
    b = None if scale is None else _rand((n,), 510 + n, scale)
    y = gemm_fma.row_gemm(x3, w, b, relu)
    assert y.shape == (2, v, n) and y.dtype == F32
    np.testing.assert_allclose(
        y.numpy(), conv3d.pointwise_conv_twin(x3, w, b, relu).numpy(),
        rtol=FP_TOL, atol=FP_TOL)


@pytest.mark.parametrize("k,n,v,scale,relu", K7_CASES[1:4])
def test_row_gemm_matches_pointwise_conv_interpret(k, n, v, scale, relu):
    """Against the reference's K7 in fp32 (its bias a row of w)."""
    x3, w = _operands(k, n, v, 540 + k)
    b = None if scale is None else _rand((n,), 550 + n, scale)
    with pltpu.force_tpu_interpret_mode():
        jy = pointwise_conv(jnp.asarray(x3.numpy()).reshape(2, v, 1, 1, k),
                            jnp.asarray(w.numpy()),
                            None if b is None else jnp.asarray(b.numpy()),
                            relu=relu)
    jy = np.array(jy).reshape(2, v, n)
    np.testing.assert_allclose(gemm_fma.row_gemm(x3, w, b, relu).numpy(),
                               jy, rtol=FP_TOL, atol=FP_TOL)


def test_fp32_gemms_count_no_launch_on_the_cpu():
    """Both wrappers take the twin on CPU tensors, with and without a
    graph to record."""
    _cuda.LAUNCHES.clear()
    x3, w = _operands(12, 7, 37, 800)
    pgemm.gemm_stats(x3, w)
    conv3d.pointwise_conv(x3.view(2, 37, 1, 1, 12), w, _rand((7,), 801),
                          True)
    with torch.no_grad():
        pgemm.gemm_stats(x3, w)
        conv3d.pointwise_conv(x3.view(2, 37, 1, 1, 12), w)
    assert not _cuda.LAUNCHES


def test_wrappers_without_a_graph_return_the_function_s_values():
    """The no-graph path (serving) and the autograd Function compute the
    same y and moments; only the former records no graph."""
    x3, w = _operands(40, 24, 300, 900)
    b = _rand((24,), 901)
    with torch.no_grad():
        plain = pgemm.gemm_stats(x3, w)
        y7 = conv3d.pointwise_conv(x3.view(2, 300, 1, 1, 40), w, b, True)
    xg = x3.clone().requires_grad_()
    graph = pgemm.gemm_stats(xg, w)
    assert graph[0].grad_fn is not None and plain[0].grad_fn is None
    for a, c in zip(plain, graph):
        assert torch.equal(a, c.detach())
    y7g = conv3d.pointwise_conv(xg.view(2, 300, 1, 1, 40), w, b, True)
    assert y7g.grad_fn is not None and torch.equal(y7, y7g.detach())
