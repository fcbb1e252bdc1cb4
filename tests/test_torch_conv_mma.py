"""The tensor-core conv's host side and algorithm (nas_3d_unet_tpu_torch/
ops/conv_mma.py), on the CPU, where its kernel (csrc/conv_mma.cuh) cannot
run: the plan fits shared memory and its bricks cover every output voxel
once at every geometry chip_smoke.py checks, and the kernel's algorithm
(per brick and 16-channel chunk a zero-filled halo, per tap a shifted K = 16
product) equals the K6 and K1-dx twins and the JAX functions they replace;
with the moments epilogue (K1 bf16), its per-block partials sum to the
moments of its rounded y and agree with K1's twin and `conv_pgemm`.

The JAX side: K6 through `conv3d(..., interpret=True)` (its Pallas body);
K1-dx through `jax.vjp` of `packed_conv_stats` (the reference's custom VJP,
`conv_pgemm` in interpret mode on the W-packed layout), as
tests/test_torch_pgemm.py runs it.  Tolerances: rtol/atol 2e-5, the
reference's own fp32 conv limits (fp32 sums in another order).  The
moments in bf16 are held to chip_smoke.py's limits: against float64 sums of
the mirror's own rounded y, MOM_STORED_RTOL (1e-6 of Σ|y|, and relative on
Σy²); against the twin's and the reference's, whose y may round an ulp
apart, MOM_RTOL (1e-3); y within 1 bf16 ulp.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nas_3d_unet_tpu.ops.pallas.conv3d import conv3d as jax_conv3d
from nas_3d_unet_tpu_torch.ops import conv3d, conv_mma, pgemm
from nas_3d_unet_tpu.ops.packed import (pack, packed_conv_stats,
                                        standard_layout, unpack)
from nas_3d_unet_tpu_torch.ops.stats import moments_twin
from tests.test_torch_pgemm import _bf16_ulps, _vjp_pair
from tests.torch_helpers import one_torch_thread  # noqa: F401

HEADER = (Path(conv_mma.__file__).resolve().parents[1] / "csrc"
          / "conv_mma.cuh")

# (cin, cout, volume, stride, dilation) of every K1-dx and K6 launch
# chip_smoke.py checks, on the path and off it
GEOMS = ([(ci, co, v, 1, d) for ci, co, v, d, _ in cs.K1DX_TRAIN
          + cs.K1DX_EXTRA + cs.K1_TRAIN + cs.K1_EXTRA]
         + [(ci, co, v, s, d)
            for ci, co, v, s, d, _ in cs.P_K6 + cs.P_K6_EXTRA])


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("cin,cout,v,stride,dil", GEOMS)
def test_plan_fits_and_its_bricks_cover_each_output_voxel_once(
        cin, cout, v, stride, dil):
    p = conv_mma.plan(cin, cout, stride, dil)
    assert p.smem <= conv_mma.SMEM_MAX
    assert p.bn in (16, 32, 64, 128) and p.rows in (128, 256)
    assert p.nchunks * conv_mma.KC >= cin
    vol = (v,) * 3 if isinstance(v, int) else v
    out = [-(-e // stride) for e in vol]
    hits = np.zeros(out, np.int32)
    for od, oh, ow in conv_mma.bricks(out, p):
        bd, bh, bw = p.brick
        hits[od:od + bd, oh:oh + bh, ow:ow + bw] += 1
    assert (hits == 1).all()
    # the halo holds every tap of every brick row: the last row's last tap
    # is (edge - 1)·stride + 2·dilation past the first row's first
    assert p.halo == tuple((e - 1) * stride + 2 * dil + 1 for e in p.brick)


def test_plan_mirrors_the_kernel_header():
    """The constants the plan shares with conv_mma.cuh."""
    src = HEADER.read_text()
    want = {"kKC": conv_mma.KC, "kLdX": conv_mma.LDX - conv_mma.KC,
            "kSmemMax": conv_mma.SMEM_MAX, "kBH": conv_mma.BH,
            "kBW": conv_mma.BW}
    found = dict(re.findall(r"constexpr int (k\w+) = (?:kKC \+ )?(\d+)",
                            src))
    for name, value in want.items():
        assert int(found[name]) == value, name
    assert "kSmemTwoBlocks = 113 * 1024" in src
    assert conv_mma.SMEM_TWO_BLOCKS == 113 * 1024


def test_plan_refuses_what_the_kernel_refuses():
    for args in ((0, 8, 1, 1), (8, 8, 3, 1), (8, 8, 1, 3)):
        with pytest.raises(ValueError):
            conv_mma.plan(*args)


@pytest.mark.parametrize("stride,dil", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("cin,cout", [(4, 12), (20, 40)])
def test_shifted_gemm_conv_matches_k6_twin_and_pallas(stride, dil, cin,
                                                      cout):
    """A ragged volume (several bricks along H and W, a partial one along
    each axis), odd channel counts (Cin 4: one partial chunk; 20: two) and
    every stride/dilation, with lax's SAME pads."""
    x = _rand((1, 5, 9, 17, cin), 60 + cin)
    w = _rand((3, 3, 3, cin, cout), 61 + stride + dil, 0.2)
    pads = conv3d._same_pads(x, 3, stride, dil)
    got = conv_mma.shifted_gemm_conv(x, w, None, stride, dil,
                                     (pads[4], pads[2], pads[0]))
    _close(got, conv3d.conv3d_twin(x, w, None, stride, dil))
    want = jax_conv3d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), None,
                      stride, dil, False, interpret=True)
    assert got.shape == want.shape
    _close(got, want)


def test_shifted_gemm_conv_bias_relu_matches_the_twin():
    x = _rand((2, 3, 10, 9, 8), 70)
    w = _rand((3, 3, 3, 8, 24), 71, 0.2)
    b = _rand((24,), 72, 0.5)
    pads = conv3d._same_pads(x, 3, 2, 1)
    got = conv_mma.shifted_gemm_conv(x, w, b, 2, 1,
                                     (pads[4], pads[2], pads[0]), True)
    _close(got, conv3d.conv3d_twin(x, w, b, 2, 1, True))


@pytest.mark.parametrize("dilation", [1, 2])
def test_shifted_gemm_conv_is_k1dx(monkeypatch, dilation):
    """K1-dx: the conv of dy with the flip-transposed kernel at stride 1,
    pad = dilation, against the twin and the reference's dx."""
    monkeypatch.setenv("NAS3D_PG_INTERPRET", "1")
    monkeypatch.setenv("NAS3D_FUSED_CONVGN", "1")
    b, d, h, wd, cin, cout = 1, 5, 7, 16, 4, 20
    x = _rand((b, d, h, wd, cin), 80 + dilation).numpy()
    k = _rand((3, 3, 3, cin, cout), 81, 0.2).numpy()
    dy = _rand((b, d, h, wd, cout), 82).numpy()
    (jdx, _), _ = _vjp_pair(x, k, dy, (3, 3, 3), dilation, 2)
    wt = pgemm.flip_transpose(torch.from_numpy(k))
    got = conv_mma.shifted_gemm_conv(torch.from_numpy(dy), wt, None, 1,
                                     dilation)
    _close(got, pgemm.conv3x3x3_twin(torch.from_numpy(dy), wt, dilation))
    _close(got, jdx)


def _moments_within(s, t, y, rtol):
    """(Σy, Σy²) `s` (B, 2, C) against `t`: Σy over Σ|y| of y, Σy² relative,
    both within rtol (chip_smoke.py's _moments_check)."""
    y = y.double().flatten(1, -2)
    scale = y.abs().sum(1)
    s, t = s.double(), t.double()
    assert ((s[:, 0] - t[:, 0]).abs() / scale).max() <= rtol
    assert ((s[:, 1] - t[:, 1]).abs() / t[:, 1].abs()).max() <= rtol


@pytest.mark.parametrize("cin,cout,vol,dil", [
    (4, 12, (5, 9, 17), 1),       # the stem's Cin: one partial chunk
    (4, 12, (5, 9, 17), 2),
    (20, 40, (3, 10, 9), 1),      # two chunks, a BN = 64 tile past Cout
    (16, 16, (6, 9, 8), 2)])      # BN = 16: BD = 4, eight warps along M
def test_moments_partials_sum_to_the_rounded_y_and_match_k1_twin(
        cin, cout, vol, dil):
    """bf16, ragged bricks on every axis: one partial row per brick, in
    block order; their sum is the moments of the mirror's own rounded y
    (rows past the volume and columns past Cout left out), and matches
    K1's twin."""
    x = _rand((2, *vol, cin), 90 + cin).bfloat16()
    w = _rand((3, 3, 3, cin, cout), 91 + dil, 0.2).bfloat16()
    y, partial = conv_mma.shifted_gemm_conv(x, w, None, 1, dil, stats=True)
    p = conv_mma.plan(cin, cout, 1, dil)
    assert partial.shape == (2, len(list(conv_mma.bricks(vol, p))), 2, cout)
    assert y.dtype == torch.bfloat16
    got = partial.sum(1)
    assert cs._moments_err(got[:, 0], got[:, 1], y) <= cs.MOM_STORED_RTOL
    yt, s1, s2 = pgemm.conv3x3x3_stats_twin(x, w, dil)
    assert _bf16_ulps(y.float(), yt.float()).max() <= 1
    _moments_within(got, torch.stack([s1, s2], 1), yt,
                    cs.MOM_RTOL[torch.bfloat16])
    m1, m2 = moments_twin(y)
    _moments_within(got, torch.stack([m1, m2], 1), y, 1e-6)


def test_block_moments_leave_out_rows_past_the_volume():
    """A brick reaching past the volume: its rows there are not summed,
    whatever they hold (with a bias or a ReLU they are not 0)."""
    y = _rand((256, 8), 95)
    keep = torch.arange(256) < 100
    got = conv_mma.block_moments(y, keep, 2)
    want = torch.stack([y[:100].sum(0), (y[:100] ** 2).sum(0)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    y2 = y.clone()
    y2[100:] = 1e6
    assert torch.equal(conv_mma.block_moments(y2, keep, 2), got)


@pytest.mark.parametrize("dil", [1, 2])
def test_moments_match_conv_pgemm_interpret(monkeypatch, dil):
    """Against the reference's K1 (`packed_conv_stats` → `conv_pgemm` in
    interpret mode, bf16, W/r = 16 its sublane tile), on a volume ragged
    in D and H, Cin 4 → Cout 12: y within 1 ulp, the folded moments within
    MOM_RTOL."""
    monkeypatch.setenv("NAS3D_PG_INTERPRET", "1")
    monkeypatch.setenv("NAS3D_FUSED_CONVGN", "1")
    b, d, h, wd, cin, cout, r = 1, 3, 5, 32, 4, 12, 2
    x = _rand((b, d, h, wd, cin), 96 + dil).bfloat16()
    w = _rand((3, 3, 3, cin, cout), 97, 0.2).bfloat16()
    j16 = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    jy, js1, js2 = packed_conv_stats(
        pack(j16(x), r), j16(w), standard_layout(r, cin),
        standard_layout(r, cout), w_in=wd, dilation=dil)
    jy = torch.from_numpy(np.array(unpack(jy, r).astype(jnp.float32)))
    fold = lambda t: torch.from_numpy(np.array(t)).view(b, r, cout).sum(1)
    y, partial = conv_mma.shifted_gemm_conv(x, w, None, 1, dil, stats=True)
    assert _bf16_ulps(y.float(), jy).max() <= 1
    _moments_within(partial.sum(1), torch.stack([fold(js1), fold(js2)], 1),
                    jy, cs.MOM_RTOL[torch.bfloat16])
