"""The fp32 FMA conv tile's host side and algorithm (nas_3d_unet_tpu_torch/
ops/conv_fma.py), on the CPU, where its kernel (csrc/conv_fma.cuh) cannot
run: the plan fits shared memory, its halo and brick edges follow the
formula and its bricks cover every output voxel once at every fp32
geometry chip_smoke.py checks; the kernel's algorithm (per brick and
4-channel chunk a zero-filled halo at the kernel's W pitch, per tap the
product of the rows at the shifted halo positions, bias, ReLU, the masked
store) equals the K1, K1-dx and K6 twins and the JAX functions they
replace; with the moments epilogue (K1), its per-block partials, summed,
equal the twin's Σy and Σy² and `conv_pgemm`'s.

The JAX side: K6 through `conv3d(..., interpret=True)` (its Pallas body);
K1 through `packed_conv_stats` and `unpack` (`conv_pgemm` in interpret mode
on the W-packed layout) and K1-dx through `jax.vjp` of it, as
tests/test_torch_pgemm.py runs them.  Tolerances: y rtol/atol 2e-5, the
reference's own fp32 conv limits (fp32 sums in another order); the summed
moments within 1e-5: Σy over Σ|y| (its rounding scale), Σy² relative.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nas_3d_unet_tpu.ops.packed import (pack, packed_conv_stats,
                                        standard_layout, unpack)
from nas_3d_unet_tpu.ops.pallas.conv3d import conv3d as jax_conv3d
from nas_3d_unet_tpu_torch.ops import conv3d, conv_fma, pgemm
from tests.test_torch_pgemm import _vjp_pair

HEADER = (Path(conv_fma.__file__).resolve().parents[1] / "csrc"
          / "conv_fma.cuh")
MOM_RTOL = 1e-5

# (cin, cout, volume, stride, dilation) of every fp32 K1, K1-dx and K6
# launch chip_smoke.py checks, on the path and off it
GEOMS = ([(ci, co, v, 1, d) for ci, co, v, d, _ in cs.K1_GEOMS + cs.K1_EXTRA
          + cs.K1DX_TRAIN + cs.K1DX_EXTRA]
         + [(ci, co, v, s, d)
            for ci, co, v, s, d, _ in cs.P_K6 + cs.P_K6_EXTRA]
         + [(*cs.P_K6_BIAS_RELU[:2], cs.P_K6_BIAS_RELU[2], 1, 1)])


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _pads(x, stride, dil):
    """lax's low-side SAME pads of x in (D, H, W) order."""
    p = conv3d._same_pads(x, 3, stride, dil)
    return p[4], p[2], p[0]


def _moments_within(s, y, rtol=MOM_RTOL):
    """Summed partials `s` (B, 2, C) against float64 sums of y (B, ..., C):
    Σy over Σ|y|, Σy² relative."""
    yd = y.double().flatten(1, -2)
    s = s.double()
    assert ((s[:, 0] - yd.sum(1)).abs() / yd.abs().sum(1)).max() <= rtol
    t2 = (yd * yd).sum(1)
    assert ((s[:, 1] - t2).abs() / t2).max() <= rtol


@pytest.mark.parametrize("cin,cout,v,stride,dil", GEOMS)
def test_plan_fits_and_its_bricks_cover_each_output_voxel_once(
        cin, cout, v, stride, dil):
    p = conv_fma.plan(cin, cout, stride, dil)
    assert p.smem <= conv_fma.SMEM_MAX
    assert p.bn in (16, 32, 64, 128) and p.bn >= min(cout, 128)
    # one thread per row of 8 voxels along W, 256 threads
    tn = 8 if p.bn >= 64 else 4
    assert p.brick == (256 // (p.bn // tn) // 8, 8, 8)
    assert p.nchunks * conv_fma.KC >= cin > (p.nchunks - 1) * conv_fma.KC
    # the halo holds every tap of every brick row: the last row's last tap
    # is (edge - 1)·stride + 2·dilation past the first row's first
    assert p.halo == tuple((e - 1) * stride + 2 * dil + 1 for e in p.brick)
    assert p.pitch % 2 == 1 and p.halo[2] <= p.pitch <= p.halo[2] + 1
    vol = (v,) * 3 if isinstance(v, int) else v
    out = [-(-e // stride) for e in vol]
    hits = np.zeros(out, np.int32)
    for od, oh, ow in conv_fma.bricks(out, p):
        bd, bh, bw = p.brick
        hits[od:od + bd, oh:oh + bh, ow:ow + bw] += 1
    assert (hits == 1).all()


def test_plan_mirrors_the_kernel_header():
    """The constants the plan shares with conv_fma.cuh, and its rules."""
    src = HEADER.read_text()
    found = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    want = {"kThreads": conv_fma.THREADS, "kKC": conv_fma.KC,
            "kTaps": conv_fma.TAPS, "kBH": conv_fma.BH, "kBW": conv_fma.BW,
            "kSmemMax": conv_fma.SMEM_MAX}
    for name, value in want.items():
        assert int(found[name]) == value, name
    assert "kSmemTwoBlocks = 113 * 1024" in src
    assert conv_fma.SMEM_TWO_BLOCKS == 113 * 1024
    assert "return bn >= 64 ? 8 : 4;" in src
    assert "return halo_edge(kBW, stride, dil) | 1;" in src


def test_plan_refuses_what_the_kernel_refuses():
    for args in ((0, 8, 1, 1), (8, 0, 1, 1), (8, 8, 3, 1), (8, 8, 1, 3)):
        with pytest.raises(ValueError):
            conv_fma.plan(*args)


@pytest.mark.parametrize("stride,dil", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("cin,cout", [(5, 7), (9, 20)])
def test_fma_conv_matches_k6_twin_and_pallas(stride, dil, cin, cout):
    """A ragged, non-cubic volume (a partial brick along every axis), Cin
    and Cout not multiples of 4 (5: a full and a partial chunk) and Cin
    over three chunks, at every stride and dilation, lax's SAME pads."""
    x = _rand((1, 5, 9, 17, cin), 60 + cin)
    w = _rand((3, 3, 3, cin, cout), 61 + stride + dil, 0.2)
    got = conv_fma.fma_conv(x, w, None, stride, dil, _pads(x, stride, dil))
    _close(got, conv3d.conv3d_twin(x, w, None, stride, dil))
    want = jax_conv3d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), None,
                      stride, dil, False, interpret=True)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("stride,dil,cout", [(1, 1, 24), (2, 2, 6)])
def test_fma_conv_bias_relu_matches_the_twin_and_pallas(stride, dil, cout):
    x = _rand((2, 3, 10, 9, 8), 70 + stride)
    w = _rand((3, 3, 3, 8, cout), 71, 0.2)
    b = _rand((cout,), 72, 0.5)
    got = conv_fma.fma_conv(x, w, b, stride, dil, _pads(x, stride, dil),
                            True)
    _close(got, conv3d.conv3d_twin(x, w, b, stride, dil, True))
    want = jax_conv3d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                      jnp.asarray(b.numpy()), stride, dil, True,
                      interpret=True)
    _close(got, want)


@pytest.mark.parametrize("dilation", [1, 2])
def test_fma_conv_is_k1dx(monkeypatch, dilation):
    """K1-dx: the conv of dy with the flip-transposed kernel at stride 1,
    pad = dilation, against the twin and the reference's dx."""
    monkeypatch.setenv("NAS3D_PG_INTERPRET", "1")
    monkeypatch.setenv("NAS3D_FUSED_CONVGN", "1")
    b, d, h, wd, cin, cout = 1, 5, 7, 16, 4, 10
    x = _rand((b, d, h, wd, cin), 80 + dilation).numpy()
    k = _rand((3, 3, 3, cin, cout), 81, 0.2).numpy()
    dy = _rand((b, d, h, wd, cout), 82).numpy()
    (jdx, _), _ = _vjp_pair(x, k, dy, (3, 3, 3), dilation, 2)
    wt = pgemm.flip_transpose(torch.from_numpy(k))
    got = conv_fma.fma_conv(torch.from_numpy(dy), wt, None, 1, dilation)
    _close(got, pgemm.conv3x3x3_twin(torch.from_numpy(dy), wt, dilation))
    _close(got, jdx)


@pytest.mark.parametrize("cin,cout,vol,dil", [
    (4, 48, (5, 9, 17), 1),       # the stem: BN 64, columns past 48 masked
    (5, 7, (3, 10, 9), 2),        # odd channels, BN 16 (BD 8), ragged
    (12, 40, (6, 9, 8), 1),       # three chunks, BN 64 (BD 4)
    (16, 72, (3, 5, 12), 2)])     # BN 128 (BD 2), ragged on every axis
def test_moments_partials_sum_to_the_k1_twins(cin, cout, vol, dil):
    """One partial row per brick, in block order; summed, they are the
    moments of the mirror's y (rows past the volume left out) and of K1's
    twin, and y is the twin's."""
    x = _rand((2, *vol, cin), 90 + cin)
    w = _rand((3, 3, 3, cin, cout), 91 + dil, 0.2)
    y, partial = conv_fma.fma_conv(x, w, None, 1, dil, stats=True)
    p = conv_fma.plan(cin, cout, 1, dil)
    assert partial.shape == (2, len(list(conv_fma.bricks(vol, p))), 2, cout)
    yt, s1, s2 = pgemm.conv3x3x3_stats_twin(x, w, dil)
    _close(y, yt)
    got = partial.sum(1)
    _moments_within(got, y)
    _moments_within(got, yt)
    np.testing.assert_allclose(got[:, 0].numpy(), s1.numpy(), rtol=0,
                               atol=MOM_RTOL * yt.abs().sum((1, 2, 3)).max())
    np.testing.assert_allclose(got[:, 1].numpy(), s2.numpy(), rtol=MOM_RTOL)


def test_block_moments_leave_out_rows_past_the_volume():
    """A brick reaching past the volume: its rows there are not summed,
    whatever they hold (with a bias or a ReLU they are not 0)."""
    y = _rand((256, 16), 95)
    keep = torch.arange(256) < 100
    got = conv_fma.block_moments(y, keep)
    want = torch.stack([y[:100].sum(0), (y[:100] ** 2).sum(0)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    y2 = y.clone()
    y2[100:] = 1e6
    assert torch.equal(conv_fma.block_moments(y2, keep), got)


@pytest.mark.parametrize("dil", [1, 2])
def test_stem_matches_conv_pgemm_interpret(monkeypatch, dil):
    """The stem's Cin 4 → Cout 48 against the reference's K1
    (`packed_conv_stats` → `conv_pgemm` in interpret mode, W/r = 16 its
    sublane tile) on a volume ragged in D and H: y within 2e-5, the
    folded moments within 1e-5."""
    monkeypatch.setenv("NAS3D_PG_INTERPRET", "1")
    monkeypatch.setenv("NAS3D_FUSED_CONVGN", "1")
    b, d, h, wd, cin, cout, r = 1, 3, 5, 32, 4, 48, 2
    x = _rand((b, d, h, wd, cin), 96 + dil)
    w = _rand((3, 3, 3, cin, cout), 97, 0.2)
    jy, js1, js2 = packed_conv_stats(
        pack(jnp.asarray(x.numpy()), r), jnp.asarray(w.numpy()),
        standard_layout(r, cin), standard_layout(r, cout), w_in=wd,
        dilation=dil)
    jy = torch.from_numpy(np.array(unpack(jy, r)))
    fold = lambda t: torch.from_numpy(np.array(t)).view(b, r, cout).sum(1)
    y, partial = conv_fma.fma_conv(x, w, None, 1, dil, stats=True)
    _close(y, jy)
    got = partial.sum(1)
    _moments_within(got, jy)
    np.testing.assert_allclose(got[:, 1].numpy(), fold(js2).numpy(),
                               rtol=MOM_RTOL)
    np.testing.assert_allclose(
        got[:, 0].numpy(), fold(js1).numpy(), rtol=0,
        atol=MOM_RTOL * jy.abs().sum((1, 2, 3)).max())
