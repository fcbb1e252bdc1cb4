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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.ops.packed import (pack, packed_group_norm,
                                        packed_group_norm_from_stats,
                                        standard_layout, unpack)
from nas_3d_unet_tpu.ops.pallas import stats as jstats
from nas_3d_unet_tpu_torch.ops import _cuda, groupnorm, stats


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
