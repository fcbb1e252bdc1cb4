"""The port's K3 GroupNorm (nas_3d_unet_tpu_torch/ops/groupnorm.py
`pallas_group_norm`; on the CPU its apply and dx twins and the K5a/K5b
twins) against the JAX package's fused Pallas GroupNorm
(`ops/pallas/groupnorm.py` `group_norm`), forward and `jax.vjp`.

The JAX side runs under `pltpu.force_tpu_interpret_mode()`, as
tests/test_groupnorm.py does.  At C = 16 it takes its lane-packed Pallas
path (`_fusable`: C divides 128); at C = 48 and C = 256 it takes its XLA
reference (two-pass variance), where the port keeps its one formula
(`E[x²] − mean²`).  Tolerances: fp32 y, dx, dγ, dβ rtol/atol 1e-4 (sums
over a few thousand terms in another order; the variance formulas differ
by fp32 rounding only); bf16 y and dx within 1 bf16 ulp (both compute in
fp32 and round once).  The stem's and the projections' GroupNorm (K3 on
the producer's moments) is held against flax's `nn.GroupNorm` + ReLU,
which the reference's `use_pallas` net runs there.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nas_3d_unet_tpu.ops.pallas import groupnorm as jgn
from nas_3d_unet_tpu_torch.ops import _cuda, groupnorm, stats
from tests.test_torch_pgemm import _bf16_ulps
from tests.torch_helpers import one_torch_thread  # noqa: F401


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.5 + 1).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.5).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


def _jax_vjp(x, scale, bias, dy, groups, relu, dtype=jnp.float32):
    def f(xx, s, b):
        return jgn.group_norm(xx, s, b, groups, 1e-6, relu)

    def run(xx, s, b, g):
        y, vjp = jax.vjp(f, xx, s, b)
        return y, vjp(g)

    with pltpu.force_tpu_interpret_mode():
        y, grads = jax.jit(run)(jnp.asarray(x, dtype), jnp.asarray(scale),
                                jnp.asarray(bias), jnp.asarray(dy, dtype))
    f32 = lambda a: np.array(jnp.asarray(a, jnp.float32))
    return [f32(y)] + [f32(g) for g in grads]


def _port(x, scale, bias, dy, groups, relu, dtype=torch.float32, **kw):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = groupnorm.pallas_group_norm(xt, st, bt, groups, relu, **kw)
    y.backward(torch.from_numpy(dy).to(dtype))
    assert y.dtype == xt.grad.dtype == dtype
    return [t.float().numpy() for t in (y.detach(), xt.grad, st.grad,
                                        bt.grad)]


@pytest.mark.parametrize("c,groups", [(16, 4), (48, 8), (256, 8)])
@pytest.mark.parametrize("relu", [False, True])
def test_pallas_group_norm_matches_jax(c, groups, relu):
    x, scale, bias, dy = _case((2, 4, 6, 8, c), 10 * groups + relu)
    want = _jax_vjp(x, scale, bias, dy, groups, relu)
    _cuda.LAUNCHES.clear()
    got = _port(x, scale, bias, dy, groups, relu)
    assert not _cuda.LAUNCHES          # a CPU tensor never counts a launch
    for name, g, w in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("relu", [False, True])
def test_pallas_group_norm_bf16_rounds_once(relu):
    """bf16 y and dx within 1 bf16 ulp of the Pallas kernels on the same
    bf16 input and cotangent; dγ, dβ (fp32) as in fp32."""
    x, scale, bias, dy = _case((2, 4, 6, 8, 16), 3 + relu)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    x, dy = bf(x), bf(dy)
    want = _jax_vjp(x, scale, bias, dy, 4, relu, jnp.bfloat16)
    got = _port(x, scale, bias, dy, 4, relu, torch.bfloat16)
    assert _bf16_ulps(got[0], want[0]).max() <= 1
    assert _bf16_ulps(got[1], want[1]).max() <= 1
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c,groups", [(12, 4), (48, 8)])
def test_k3_on_producer_moments_matches_flax_group_norm(c, groups):
    """The stem's and the projections' GroupNorm under `use_pallas`: K3 on
    the moments the conv emitted (Σx, Σx² in fp32) against flax's
    nn.GroupNorm then ReLU, as the reference runs them."""
    x, scale, bias, dy = _case((2, 4, 5, 6, c), c)
    mod = fnn.GroupNorm(num_groups=groups, epsilon=1e-6)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    def run(xx, p, g):
        y, vjp = jax.vjp(lambda a, q: jax.nn.relu(mod.apply(q, a)), xx, p)
        return y, vjp(g)

    y, (dx, dp) = jax.jit(run)(jnp.asarray(x), params, jnp.asarray(dy))
    xd = torch.from_numpy(x).double()
    moments = (xd.sum((1, 2, 3)).float(), (xd * xd).sum((1, 2, 3)).float())
    got = _port(x, scale, bias, dy, groups, True, moments=moments)
    want = [y, dx, dp["params"]["scale"], dp["params"]["bias"]]
    for name, g, w in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_masked_weighted_sums_match_the_pallas_grad_sums():
    """K3's backward sums with the ReLU fused (K5b masked by y > 0) against
    `_grad_lane_sums(..., relu=True)` on the lane-packed layout, folded
    from 128 lanes to C channels."""
    b, v, c = 2, 512, 16
    rng = np.random.default_rng(5)
    g, x = (rng.standard_normal((b, v, c)).astype(np.float32)
            for _ in range(2))
    y = np.maximum(rng.standard_normal((b, v, c)), 0).astype(np.float32)
    lanes = lambda a: jnp.asarray(a.reshape(b, v * c // 128, 128))
    with pltpu.force_tpu_interpret_mode():
        sums = jgn._grad_lane_sums(lanes(g), lanes(x), lanes(y), 64, True)
    want = np.asarray(sums).reshape(b, 2, 128 // c, c).sum(2)
    got = stats.weighted_sums(*(torch.from_numpy(a) for a in (g, x, y)))
    for k in range(2):
        np.testing.assert_allclose(got[k].numpy(), want[:, k], rtol=1e-5,
                                   atol=1e-4)
    unmasked = stats.weighted_sums(torch.from_numpy(g), torch.from_numpy(x))
    assert not torch.allclose(unmasked[0], got[0])


def test_k3_wrappers_refuse_bad_devices():
    meta = torch.zeros(1, 2, 2, 2, 8, device="meta")
    v = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        groupnorm.group_norm_apply(meta, v, v, True)
    with pytest.raises(ValueError, match="no kernel"):
        groupnorm.group_norm_dx(meta, meta, None, v, v, v)
    with pytest.raises(ValueError):
        stats.weighted_sums(torch.zeros(1, 4, 3), torch.zeros(1, 4, 3),
                            torch.zeros(1, 4, 2))
