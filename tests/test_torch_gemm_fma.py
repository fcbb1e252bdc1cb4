"""The fp32 voxel-row FMA tile's host side and algorithm
(nas_3d_unet_tpu_torch/ops/gemm_fma.py), on the CPU, where its kernel
(csrc/gemm_fma.cuh) cannot run: the plan fits shared memory and its tiles
cover every row once at every K2, K7 and K4 geometry chip_smoke.py checks,
K4's store runs cover every column once, and the kernel's algorithm
equals the twins and the JAX functions it replaces in fp32:
  K2 (per tile of rows the chunk-by-chunk product, and the moments of
     each tile's y in the kernel's order) against K2's twin and
     `gemm_stats` in interpret mode;
  K7 (the same product, then the bias and the ReLU) against K7's twin and
     `pointwise_conv` under `pltpu.force_tpu_interpret_mode()`;
  K4 (the DHWIO kernel staged with lax's flip, the same product, the
     ReLU, the depth-to-space store run by run) against K4's twin and
     `conv_transpose2x` the same way.
And the wrappers' launch path: K4 hands the kernel the caller's w (no
copy, either dtype), and a call with no graph to record skips the
autograd Functions.

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

from unittest import mock

from nas_3d_unet_tpu.ops.pallas.conv3d import (conv_transpose2x,
                                               pointwise_conv)
from nas_3d_unet_tpu.ops.pallas.pgemm import gemm_stats as jax_gemm_stats
from nas_3d_unet_tpu_torch.ops import _cuda, conv3d, gemm_fma, gemm_mma, pgemm
from tests.test_torch_conv_mma import _moments_within
from tests.torch_helpers import one_torch_thread  # noqa: F401

HEADER = (Path(gemm_fma.__file__).resolve().parents[1] / "csrc"
          / "gemm_fma.cuh")
F32 = torch.float32
FP_TOL = 1e-5
MOM_TOL = cs.MOM_RTOL[F32]

# (K, N, rows, stats, d2s) of every K2 (moments), K7 and K4 (depth-to-
# space, N = 8·Cout) launch chip_smoke.py checks, on the path and off
PLAN_GEOMS = sorted(
    {(k, n, cs.math.prod(cs._volume(v)), True, False)
     for k, n, v, _ in cs.K2_GEOMS + cs.K2_EXTRA}
    | {(c, c, 2 * v ** 3, False, False) for c, v, _ in cs.P_K7}
    | {(ci, co, 2 * cs.math.prod(cs._volume(v)), False, False)
       for ci, co, v, _ in cs.P_K7_EXTRA}
    | {(c, 8 * c, v ** 3, False, True) for c, v, _ in cs.P_K4}
    | {(ci, 8 * co, cs.math.prod(cs._volume(v)), False, True)
       for ci, co, v, _ in cs.P_K4_EXTRA})
# K4's (Cin, Cout) of chip_smoke.py, on the path and off
K4_GEOMS = sorted({(c, c) for c, _, _ in cs.P_K4}
                  | {(ci, co) for ci, co, _, _ in cs.P_K4_EXTRA})
# K and N multiples of 4 and not, each BN class (N 16, 32, 64, 128), K
# over several chunks (384), V a multiple of the tile and not
K2_CASES = [(12, 7, 37), (40, 24, 300), (48, 16, 256), (96, 64, 129),
            (192, 128, 200), (384, 64, 131), (20, 33, 130)]
# K7: (K, N, V, bias scale or None, ReLU)
K7_CASES = [(16, 16, 300, None, False), (12, 7, 37, None, True),
            (32, 32, 257, 0.5, True), (64, 64, 129, 37.0, False),
            (128, 128, 200, 1.0, True)]
# K4: (Cin, Cout, input volume, ReLU): each BN class, N = 8·Cout of one,
# two (Cout 24: runs of 16 columns, cut by the block's edge) and four
# (Cout 64, K over 4 chunks) column blocks, Cout 5 (scalar copies, runs of
# 2), a ragged volume
K4_CASES = [(16, 16, (4, 4, 4), False), (16, 24, (3, 4, 3), True),
            (12, 5, (2, 3, 4), False), (64, 64, (2, 2, 2), True),
            (8, 3, (1, 2, 3), True)]


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


def _operands(k, n, v, seed):
    return _rand((2, v, k), seed), _rand((k, n), seed + 1, k ** -0.5)


@pytest.mark.parametrize("k,n,rows,stats,d2s", [
    pytest.param(*g, id="-".join(map(str, g[:3] + (g[4] and "d2s"
                                                   or g[3],))))
    for g in PLAN_GEOMS])
def test_plan_fits_and_its_tiles_cover_each_row_once(k, n, rows, stats,
                                                     d2s):
    p = gemm_fma.plan(k, n, stats, d2s)
    assert p.smem <= gemm_fma.SMEM_MAX
    # the moments' warp rows (K2) or the rows' corners (K4) beside the rest
    bare = gemm_fma.plan(k, n, False)
    extra = gemm_fma.WARPS * 2 * p.bn if stats else p.rows if d2s else 0
    assert p.stages != bare.stages or p.smem == bare.smem + 4 * extra
    # BN covers N at N <= 128; ⌈N/128⌉ column blocks of 128 above
    assert p.bn in (16, 32, 64, 128) and p.bn >= min(n, 128)
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


@pytest.mark.parametrize("cin,cout", K4_GEOMS)
def test_store_runs_cover_each_column_once_at_its_offset(cin, cout):
    """K4's runs: every column once, each run inside one column block and
    one (kd, kh) pair, at d2s_offsets' offsets; runs of 2·Cout (a warp's
    vectors contiguous across a line's rows) wherever 2·Cout divides BN."""
    h, wd = 5, 3
    p = gemm_fma.plan(cin, 8 * cout, False, True)
    _, offset = gemm_mma.d2s_offsets(2, h, wd, cout)
    cols = []
    for n, off, width in gemm_fma.store_runs(cout, p.bn, h, wd):
        assert n // p.bn == (n + width - 1) // p.bn
        assert n // (2 * cout) == (n + width - 1) // (2 * cout)
        assert torch.equal(offset[n:n + width], off + torch.arange(width))
        assert width == (2 * cout if p.bn % (2 * cout) == 0
                         else cs.math.gcd(2 * cout, p.bn))
        cols += range(n, n + width)
    assert cols == list(range(8 * cout))


def _k4_operands(cin, cout, vol, seed):
    return (_rand((2, *vol, cin), seed),
            _rand((2, 2, 2, cin, cout), seed + 1, cin ** -0.5))


@pytest.mark.parametrize("cin,cout,vol,relu", K4_CASES)
def test_transpose2x_matches_k4_twin(cin, cout, vol, relu):
    x, w = _k4_operands(cin, cout, vol, 600 + cin + cout)
    y = gemm_fma.transpose2x(x, w, relu)
    yt = conv3d.conv_transpose2x_twin(x, w, relu)
    assert y.shape == yt.shape == (2, *(2 * s for s in vol), cout)
    assert y.dtype == F32
    np.testing.assert_allclose(y.numpy(), yt.numpy(), rtol=FP_TOL,
                               atol=FP_TOL)


@pytest.mark.parametrize("cin,cout,vol,relu", K4_CASES[:2])
def test_transpose2x_matches_conv_transpose2x_interpret(cin, cout, vol,
                                                         relu):
    """Against the reference's K4 in fp32 (the flipped taps, one dot)."""
    x, w = _k4_operands(cin, cout, vol, 640 + cin)
    with pltpu.force_tpu_interpret_mode():
        jy = conv_transpose2x(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                              relu=relu)
    jy = np.array(jy)
    assert jy.shape == (2, *(2 * s for s in vol), cout)
    np.testing.assert_allclose(gemm_fma.transpose2x(x, w, relu).numpy(), jy,
                               rtol=FP_TOL, atol=FP_TOL)


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16])
def test_k4_hands_the_kernel_the_caller_s_w(dtype):
    """The launch path, on the CPU with the dispatch forced to the kernel
    side and the launch recorded: K4's kernel gets x, w and a fresh y by
    address, w the caller's DHWIO tensor itself (no flipped copy, either
    dtype), and the shapes of the call."""
    x, w = (t.to(dtype) for t in _k4_operands(12, 5, (2, 3, 4), 660))
    calls = []
    with mock.patch.object(_cuda, "dispatch", return_value=False), \
            mock.patch.object(_cuda, "run",
                              side_effect=lambda *a: calls.append(a)):
        y = conv3d._k4(x, w, True)
    (fn, dev, xp, wp, yp, *ints), = calls
    assert fn == f"conv_transpose2x_{_cuda.SUFFIX[dtype]}" and dev == x.device
    assert (xp, wp, yp) == (x.data_ptr(), w.data_ptr(), y.data_ptr())
    assert ints == [2, 2, 3, 4, 12, 5, 1]
    assert y.shape == (2, 4, 6, 8, 5) and y.dtype == dtype


def test_fp32_gemms_count_no_launch_on_the_cpu():
    """The three wrappers take the twin on CPU tensors, with and without
    a graph to record."""
    _cuda.LAUNCHES.clear()
    x3, w = _operands(12, 7, 37, 800)
    x4, w4 = _k4_operands(12, 5, (1, 2, 3), 802)
    pgemm.gemm_stats(x3, w)
    conv3d.pointwise_conv(x3.view(2, 37, 1, 1, 12), w, _rand((7,), 801),
                          True)
    conv3d.conv_transpose2x(x4, w4, True)
    with torch.no_grad():
        pgemm.gemm_stats(x3, w)
        conv3d.pointwise_conv(x3.view(2, 37, 1, 1, 12), w)
        conv3d.conv_transpose2x(x4, w4)
    assert not _cuda.LAUNCHES


def test_wrappers_without_a_graph_return_the_function_s_values():
    """The no-graph path (serving) and the autograd Function compute the
    same y and moments; only the former records no graph, and K4 there
    does not enter its Function."""
    x3, w = _operands(40, 24, 300, 900)
    b = _rand((24,), 901)
    x4, w4 = _k4_operands(16, 24, (3, 4, 3), 902)
    with torch.no_grad():
        plain = pgemm.gemm_stats(x3, w)
        y7 = conv3d.pointwise_conv(x3.view(2, 300, 1, 1, 40), w, b, True)
        with mock.patch.object(conv3d._Transpose2x, "forward",
                               side_effect=AssertionError("Function")):
            y4 = conv3d.conv_transpose2x(x4, w4, True)
    xg = x3.clone().requires_grad_()
    graph = pgemm.gemm_stats(xg, w)
    assert graph[0].grad_fn is not None and plain[0].grad_fn is None
    for a, c in zip(plain, graph):
        assert torch.equal(a, c.detach())
    y7g = conv3d.pointwise_conv(xg.view(2, 300, 1, 1, 40), w, b, True)
    assert y7g.grad_fn is not None and torch.equal(y7, y7g.detach())
    y4g = conv3d.conv_transpose2x(x4.clone().requires_grad_(), w4, True)
    assert y4g.grad_fn is not None and y4.grad_fn is None
    assert torch.equal(y4, y4g.detach())
