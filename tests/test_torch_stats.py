"""The port's GroupNorm reductions (K5a/K5b twins, nas_3d_unet_tpu_torch/
ops/stats.py) and its GroupNorm Function (ops/groupnorm.py) against the
JAX package, on CPU.

K5a/K5b: against `ops/pallas/stats.py` in interpret mode, rtol 1e-5 /
atol 1e-4 (fp32 sums in another order, as test_torch_pgemm.py's moments).
GroupNorm: forward and `jax.vjp` of `packed_group_norm` and
`packed_group_norm_from_stats` on a W-packed input (r = 2), unpacked;
dx, dγ and dβ at rtol 1e-4 / atol 2e-5 (the fp32 GN tolerance of
test_torch_ops.py is 5e-5 on outputs of unit scale).  In bf16, y and dx
within 1 bf16 ulp of the reference's.

The one-launch K5 kernel (csrc/stats.cu), where no card is: its plan
(`stats.plan`) at every K5 geometry chip_smoke.py checks on the flagship
paths, at batch 1 and 2, and at the ragged volume with odd C, covers every
row and channel once, writes disjoint partial slots that fill its one
allocation, and keeps the partials within PARTIAL_SHARE of one input's
bytes; its summation order (`stats.kernel_sums`) is within chip_smoke.py's
STATS_RTOL of float64 sums (over Σ|terms|) and matches the Pallas
`moments`, `weighted_sums` and `_grad_lane_sums` in interpret mode as the
twins do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nas_3d_unet_tpu.ops.packed import (pack, packed_group_norm,
                                        packed_group_norm_from_stats,
                                        standard_layout, unpack)
from nas_3d_unet_tpu.ops.pallas import stats as jstats
from nas_3d_unet_tpu_torch.ops import _cuda, groupnorm, stats
from tests.torch_helpers import one_torch_thread  # noqa: F401


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 128), (1, 3, 5, 7, 256)])
def test_moments_and_weighted_sums_twins_match_pallas(shape):
    x = _x(shape, 0) * 2 + 0.5
    g = _x(shape, 1)
    _cuda.LAUNCHES.clear()
    for got, want in zip(stats.moments(torch.from_numpy(x)),
                         jstats.moments(jnp.asarray(x), interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    for got, want in zip(
            stats.weighted_sums(torch.from_numpy(g), torch.from_numpy(x)),
            jstats.weighted_sums(jnp.asarray(g), jnp.asarray(x),
                                 interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    assert not _cuda.LAUNCHES        # a CPU tensor never counts a launch


def test_twins_upcast_bf16_before_multiplying():
    x = torch.from_numpy(_x((2, 5, 4, 3, 8), 2) * 30).bfloat16()
    g = torch.from_numpy(_x((2, 5, 4, 3, 8), 3) * 30).bfloat16()
    xd, gd = x.double(), g.double()
    s1, s2 = stats.moments(x)
    r1, r2 = stats.weighted_sums(g, x)
    assert {t.dtype for t in (s1, s2, r1, r2)} == {torch.float32}
    for got, want in ((s1, xd.sum((1, 2, 3))), (s2, (xd * xd).sum((1, 2, 3))),
                      (r1, gd.sum((1, 2, 3))),
                      (r2, (gd * xd).sum((1, 2, 3)))):
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-3)


def test_stats_wrappers_refuse_bad_input():
    with pytest.raises(ValueError):
        stats.moments(torch.zeros(4, 3))
    with pytest.raises(ValueError):
        stats.weighted_sums(torch.zeros(1, 4, 3), torch.zeros(1, 4, 2))
    with pytest.raises(ValueError, match="no kernel"):
        stats.moments(torch.zeros(1, 4, 3, device="meta"))


def _gn_case(seed, c=8, r=2):
    x = _x((2, 3, 4, 6, c), seed) * 1.5 + 0.3
    scale = _x((c,), seed + 1) * 0.5 + 1
    bias = _x((c,), seed + 2) * 0.5
    dy = _x(x.shape, seed + 3)
    return x, scale, bias, dy, r


def _port_gn(fn, x, scale, bias, dy, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = fn(xt, st, bt, **kw)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy(), st.grad.numpy(), \
        bt.grad.numpy()


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_vjp_matches_jax(relu):
    x, scale, bias, dy, r = _gn_case(10 + relu)
    lay = standard_layout(r, x.shape[-1])

    def jfn(xp, s, b):
        return packed_group_norm(xp, s, b, 4, lay, relu=relu)

    y, vjp = jax.vjp(jfn, pack(jnp.asarray(x), r), jnp.asarray(scale),
                     jnp.asarray(bias))
    dxp, ds, db = vjp(pack(jnp.asarray(dy), r))
    got = _port_gn(groupnorm.group_norm, x, scale, bias, dy, groups=4,
                   relu=relu)
    _close(got, (unpack(y, r), unpack(dxp, r), ds, db))


@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_from_moments_vjp_matches_jax(relu):
    """The moments come in precomputed; their gradients are zero on both
    sides (the backward through x is complete)."""
    x, scale, bias, dy, r = _gn_case(20 + relu)
    c = x.shape[-1]
    lay = standard_layout(r, c)
    xp = pack(jnp.asarray(x), r)
    s1 = jnp.sum(xp, axis=(1, 2, 3))
    s2 = jnp.sum(xp * xp, axis=(1, 2, 3))

    def jfn(xp_, s, b, s1_, s2_):
        return packed_group_norm_from_stats(xp_, s, b, s1_, s2_, 4, lay,
                                            relu=relu)

    y, vjp = jax.vjp(jfn, xp, jnp.asarray(scale), jnp.asarray(bias), s1, s2)
    dxp, ds, db, ds1, ds2 = vjp(pack(jnp.asarray(dy), r))
    assert not np.any(np.asarray(ds1)) and not np.any(np.asarray(ds2))

    t1 = torch.from_numpy(np.asarray(s1).reshape(2, r, c).sum(1))
    t2 = torch.from_numpy(np.asarray(s2).reshape(2, r, c).sum(1))
    t1.requires_grad_()
    t2.requires_grad_()

    def port(xt, st, bt, groups, relu):
        return groupnorm.group_norm_from_moments(xt, t1, t2, st, bt, groups,
                                                 relu)

    got = _port_gn(port, x, scale, bias, dy, groups=4, relu=relu)
    _close(got, (unpack(y, r), unpack(dxp, r), ds, db))
    assert t1.grad is None and t2.grad is None


def _bf16_ulps(got, want):
    """|got − want| in bf16 ulps of max(|want|, 2⁻⁸)."""
    want = np.asarray(want, np.float64)
    e = np.frexp(np.maximum(np.abs(want), 2.0 ** -8))[1]
    return np.abs(np.asarray(got, np.float64) - want) / np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("relu", [False, True])
def test_group_norm_bf16_rounds_the_affine_first(relu):
    """bf16 y and dx within 1 bf16 ulp of JAX's `packed_group_norm` (and its
    VJP) on the same bf16 input; dγ, dβ as in fp32.  The reference casts
    the fp32 affine to bf16 and rounds x·a to bf16 before it adds b
    (`packed.py:794`).  Skipping either rounding misses by tens of ulps
    where x·a and b cancel, and with this seed flips the ReLU mask where
    the reference's pre-activation is exactly 0."""
    x, scale, bias, dy, r = _gn_case(3)
    lay = standard_layout(r, x.shape[-1])
    xb, dyb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)

    def jfn(xp, s, b):
        return packed_group_norm(xp, s, b, 4, lay, relu=relu)

    y, vjp = jax.vjp(jfn, pack(xb, r), jnp.asarray(scale), jnp.asarray(bias))
    dxp, ds, db = vjp(pack(dyb, r))
    f32 = lambda a: np.array(jnp.asarray(a, jnp.float32))

    xt = torch.from_numpy(f32(xb)).bfloat16().requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    got = groupnorm.group_norm(xt, st, bt, 4, relu=relu)
    got.backward(torch.from_numpy(f32(dyb)).bfloat16())
    assert got.dtype == xt.grad.dtype == torch.bfloat16
    assert _bf16_ulps(got.detach().float(), f32(unpack(y, r))).max() <= 1
    assert _bf16_ulps(xt.grad.float(), f32(unpack(dxp, r))).max() <= 1
    _close((st.grad.numpy(), bt.grad.numpy()), (ds, db))


# ---------------------------------------------------------------------------
# The one-launch kernel's plan (`stats.plan`) and its algorithm
# (`stats.kernel_sums`), which csrc/stats.cu runs on the card
# ---------------------------------------------------------------------------

# (C, volume, batch) of every K5 call chip_smoke.py checks on the flagship
# paths (K5a, K5b, masked K5b; serving at batch 2, training at 1), at
# batch 1 and 2 each, and off them the ragged volume at C 12 and 7
_FLAGSHIP = sorted({(c, v) for c, v, _ in cs.K5A_GEOMS + cs.K5B_TRAIN
                    + cs.P_K3 + cs.P_K5A})
_GEOMS = ([(c, cs._volume(v), b) for c, v in _FLAGSHIP for b in (1, 2)]
          + [(c, cs.RAGGED, b) for c in (12, 7) for b in (1, 2)])
PARTIAL_SHARE = 1 / 16    # the partials' bytes at most, of one input's


def _plan_cases():
    for ntensors in (1, 2, 3):
        for esize in (4, 2):
            yield pytest.param(ntensors, esize, id=f"in{ntensors}-e{esize}")


def _thread_rows(p, v):
    """Every row each thread of each span visits, in the kernel's loop: r =
    r0 + trow + it·U·tr, rows r + k·tr (k < U) below r1."""
    out = []
    for span in range(p.nspan):
        r0, r1 = span * p.rows, min(v, (span + 1) * p.rows)
        it = np.arange(-(-(r1 - r0) // (p.unroll * p.tr)))
        rr = (r0 + np.arange(p.tr)[:, None, None]
              + it[None, :, None] * p.unroll * p.tr
              + np.arange(p.unroll)[None, None, :] * p.tr)
        out.append(rr[rr < r1])
    return np.concatenate(out)


@pytest.mark.parametrize("ntensors, esize", _plan_cases())
def test_plan_covers_every_row_and_channel_once(ntensors, esize):
    """At every flagship K5 geometry (batch 1 and 2), the ragged volume at
    odd C, aligned and not: the threads of the spans visit every row once,
    the channel tiles' threads every channel once, and the last blocks'
    outputs every (sum, channel) once; every thread's row lies in the
    block's pass (tr · cgt threads at most)."""
    for c, vol, b in _GEOMS:
        v = int(np.prod(vol))
        for aligned in (True, False):
            p = stats.plan(b, v, c, esize, ntensors, aligned)
            # what stats.cu checks before it launches
            assert p.tr == stats.THREADS // p.cgt and p.rows % (
                p.unroll * p.tr) == 0 and p.unroll == stats.unroll(ntensors)
            assert (p.ctiles - 1) * p.cgt < c // p.vec <= p.ctiles * p.cgt
            assert (p.nspan - 1) * p.rows < v <= p.nspan * p.rows
            assert np.array_equal(np.bincount(_thread_rows(p, v),
                                              minlength=v), np.ones(v))
            chans = np.zeros(c, int)
            outs = np.zeros((2, c), int)
            for tile in range(p.ctiles):
                for cl in range(p.cgt):
                    c0 = (tile * p.cgt + cl) * p.vec
                    if c0 < c:
                        chans[c0:c0 + p.vec] += 1
                        assert c0 + p.vec <= c
                cbase = tile * p.cgt * p.vec
                ct = min(p.cgt * p.vec, c - cbase)
                outs[:, cbase:cbase + ct] += 1
            assert (chans == 1).all() and (outs == 1).all()
            if not aligned or (c * esize) % 16:
                assert p.vec == 1
            else:
                assert p.vec == 16 // esize


@pytest.mark.parametrize("ntensors, esize", _plan_cases())
def test_plan_partials_slots_disjoint_and_small(ntensors, esize):
    """Each (b, span, sum, channel) partial slot is written by one thread
    of one block, the slots fill the allocation after the outputs exactly,
    the (b, tile) tickets are distinct, and at every flagship geometry the
    partials are at most PARTIAL_SHARE of one input's bytes."""
    for c, vol, b in _GEOMS:
        v = int(np.prod(vol))
        p = stats.plan(b, v, c, esize, ntensors, True)
        slots = []
        for bb in range(b):
            for span in range(p.nspan):
                for tile in range(p.ctiles):
                    c0 = (tile * p.cgt + np.arange(p.cgt)) * p.vec
                    c0 = c0[c0 < c]
                    cs_ = (c0[:, None] + np.arange(p.vec)).ravel()
                    for s in range(2):
                        slots.append(((bb * p.nspan + span) * 2 + s) * c
                                     + cs_)
        slots = np.concatenate(slots)
        assert np.array_equal(np.sort(slots), np.arange(b * p.nspan * 2 * c))
        # the allocation: (2 + 4·nspan, B, C) fp32, outputs then doubles
        assert (2 + 4 * p.nspan) * b * c * 4 == 8 * b * c + 8 * slots.size
        tickets = {bb * p.ctiles + t for bb in range(b)
                   for t in range(p.ctiles)}
        assert len(tickets) == b * p.ctiles <= stats.MAX_TICKETS
        if (c, vol) in {(c_, cs._volume(v_)) for c_, v_ in _FLAGSHIP}:
            assert 8 * slots.size <= PARTIAL_SHARE * b * v * c * esize
            assert p.nspan * b * p.ctiles <= stats.MAX_BLOCKS


def test_plan_caps_blocks_and_spans_bytes():
    """Large inputs get at most MAX_BLOCKS blocks; small ones blocks of at
    least SPAN_BYTES of one input (or one block)."""
    big = stats.plan(1, 128 ** 3, 16, 2, 2, True)
    assert big.nspan <= stats.MAX_BLOCKS and big.vec == 8
    small = stats.plan(1, 16 ** 3, 256, 2, 1, True)
    assert small.rows * 256 * 2 >= stats.SPAN_BYTES or small.nspan == 1
    wide = stats.plan(3, 50, 2100, 2, 1, False)     # scalar: tiles of ≤256
    assert wide.ctiles == 9 and wide.cgt * wide.ctiles >= 2100
    with pytest.raises(ValueError):
        stats.plan(1, 0, 16, 2)
    with pytest.raises(ValueError):
        stats.plan(stats.MAX_TICKETS + 1, 8, 16, 2)


def _inputs(shape, ntensors, dtype, seed):
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                           * 2 + 0.5).to(dtype) for _ in range(ntensors)]
    if ntensors == 3:
        ts[2] = ts[2] - 0.5          # y: about half of it > 0
    return ts


def _float64_sums(ts):
    """(Σ terms, Σ |terms|) in float64 of the two sums."""
    d = [t.double() for t in ts]
    if len(d) == 1:
        terms = (d[0], d[0] * d[0])
    else:
        g = d[0] if len(d) == 2 else torch.where(d[2] > 0, d[0], 0.0)
        terms = (g, g * d[1])
    return [(t.sum(1), t.abs().sum(1)) for t in terms]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ntensors", [1, 2, 3])
@pytest.mark.parametrize("b, v, c, aligned", [
    (2, 19 * 24 * 21, 12, True), (1, 19 * 24 * 21, 7, True),
    (2, 4096, 48, True), (1, 4096, 256, True), (2, 2000, 16, False),
    (1, 300, 257, True)])
def test_kernel_sums_match_float64(b, v, c, aligned, ntensors, dtype):
    """The kernel's order (fp32 over U rows, double per thread, the
    block's tree, the spans split over the last block) within
    chip_smoke.py's STATS_RTOL of float64 sums, over Σ|terms|: several
    spans, vector and scalar plans, two channel tiles at C = 257."""
    ts = _inputs((b, v, c), ntensors, dtype, b * v + c)
    esize = ts[0].element_size()
    p = stats.plan(b, v, c, esize, ntensors, aligned)
    if ntensors == 1:
        got = stats.kernel_sums(p, ts[0])
    else:                            # ts = (g, x[, y])
        got = stats.kernel_sums(p, ts[1], ts[0], *ts[2:])
    for k, (want, scale) in zip(got, _float64_sums(ts)):
        assert k.dtype == torch.float32
        err = ((k.double() - want).abs() / scale).max().item()
        assert err <= cs.STATS_RTOL, err


@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 128), (1, 3, 5, 7, 256)])
def test_kernel_sums_match_pallas(shape):
    """The kernel's order against `moments` / `weighted_sums` in interpret
    mode, as the twins are held above (rtol 1e-5, atol 1e-4)."""
    x = _x(shape, 7) * 2 + 0.5
    g = _x(shape, 8)
    b, c = shape[0], shape[-1]
    v = x.size // (b * c)
    p1 = stats.plan(b, v, c, 4, 1, True)
    p2 = stats.plan(b, v, c, 4, 2, True)
    xt, gt = (torch.from_numpy(a.reshape(b, v, c)) for a in (x, g))
    for got, want in zip(stats.kernel_sums(p1, xt),
                         jstats.moments(jnp.asarray(x), interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    for got, want in zip(stats.kernel_sums(p2, xt, gt),
                         jstats.weighted_sums(jnp.asarray(g), jnp.asarray(x),
                                              interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


def test_masked_kernel_sums_match_the_pallas_grad_sums():
    """The masked form's order against `_grad_lane_sums(..., relu=True)` on
    the lane-packed layout, folded from 128 lanes to C channels (as
    test_torch_pallas_gn.py holds the twin)."""
    from jax.experimental.pallas import tpu as pltpu

    from nas_3d_unet_tpu.ops.pallas import groupnorm as jgn

    b, v, c = 2, 512, 16
    rng = np.random.default_rng(9)
    g, x = (rng.standard_normal((b, v, c)).astype(np.float32)
            for _ in range(2))
    y = np.maximum(rng.standard_normal((b, v, c)), 0).astype(np.float32)
    lanes = lambda a: jnp.asarray(a.reshape(b, v * c // 128, 128))
    with pltpu.force_tpu_interpret_mode():
        sums = jgn._grad_lane_sums(lanes(g), lanes(x), lanes(y), 64, True)
    want = np.asarray(sums).reshape(b, 2, 128 // c, c).sum(2)
    p = stats.plan(b, v, c, 4, 3, True)
    got = stats.kernel_sums(p, *(torch.from_numpy(a) for a in (x, g, y)))
    for k in range(2):
        np.testing.assert_allclose(got[k].numpy(), want[:, k], rtol=1e-5,
                                   atol=1e-4)
