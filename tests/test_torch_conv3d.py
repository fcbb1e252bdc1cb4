"""The port's `use_pallas` convs (nas_3d_unet_tpu_torch/ops/conv3d.py: K6
conv3d, K7 pointwise_conv, K4 conv_transpose2x; on the CPU their plain
twins) against the JAX Pallas kernels they replace, forward and backward.

The JAX side runs its kernels in interpret mode: K6 through
`conv3d(..., interpret=True)` (its Pallas body at every shape, the
viability gate off), K7 and K4 under `pltpu.force_tpu_interpret_mode()`,
as tests/test_pallas.py runs them.  Their gradients are `jax.grad` of the
Pallas functions, whose custom VJPs differentiate the XLA reference; the
port's autograd Functions run their twin's backward (cuDNN's
`convolution_backward`, matmuls).  Tolerances: fp32 y rtol/atol 2e-5 (the
reference's own test_pallas.py limits), gradients rtol/atol 1e-4 (fp32
sums of up to a few hundred terms in another order); bf16 y within 1 bf16
ulp (both round the fp32 sum once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nas_3d_unet_tpu.ops.pallas.conv3d import _same_pad
from nas_3d_unet_tpu.ops.pallas.conv3d import conv3d as jax_conv3d
from nas_3d_unet_tpu.ops.pallas.conv3d import (conv_transpose2x,
                                               pointwise_conv)
from nas_3d_unet_tpu_torch.ops import _cuda, conv3d
from tests.test_torch_pgemm import _bf16_ulps
from tests.torch_helpers import one_torch_thread  # noqa: F401


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(*arrays, grad=False):
    return [None if a is None else torch.from_numpy(a).requires_grad_(grad)
            for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("stride,dil", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("bias_relu", [False, True])
def test_conv3d_matches_pallas(stride, dil, bias_relu):
    """Odd and even edges: lax's SAME pad at stride 2 is (0, 1) at dilation
    1 and (1, 2) at dilation 2 on an even edge, (1, 1) / (2, 2) on an odd
    one."""
    x = _rand((2, 6, 7, 8, 5), 1 + stride)
    w = _rand((3, 3, 3, 5, 6), 2 + dil, 0.2)
    b = _rand((6,), 3, 0.5) if bias_relu else None
    want = jax_conv3d(jnp.asarray(x), jnp.asarray(w),
                      None if b is None else jnp.asarray(b), stride, dil,
                      bias_relu, interpret=True)
    _cuda.LAUNCHES.clear()
    got = conv3d.conv3d(*_t(x, w, b), stride, dil, bias_relu)
    assert not _cuda.LAUNCHES          # a CPU tensor never counts a launch
    assert got.shape == want.shape
    _close(got, want, 2e-5)


@pytest.mark.parametrize("stride,bias_relu", [(1, False), (2, True)])
def test_conv3d_gradients_match_jax_grad(stride, bias_relu):
    x = _rand((1, 5, 6, 8, 4), 10 + stride)
    w = _rand((3, 3, 3, 4, 6), 11, 0.2)
    b = _rand((6,), 12, 0.5) if bias_relu else None
    dy = _rand((1, *(-(-s // stride) for s in (5, 6, 8)), 6), 13)

    def jloss(xx, ww, bb):
        y = jax_conv3d(xx, ww, bb, stride, 1, bias_relu, interpret=True)
        return jnp.sum(y * dy)

    args = [jnp.asarray(a) for a in (x, w)] + [
        None if b is None else jnp.asarray(b)]
    want = jax.jit(jax.grad(jloss, argnums=(0, 1) if b is None
                            else (0, 1, 2)))(*args)
    xt, wt, bt = _t(x, w, b, grad=True)
    conv3d.conv3d(xt, wt, bt, stride, 1, bias_relu).backward(
        torch.from_numpy(dy))
    got = [xt.grad, wt.grad] + ([] if b is None else [bt.grad])
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        _close(g, wnt, 1e-4)


@pytest.mark.parametrize("bias_relu", [False, True])
def test_pointwise_conv_matches_pallas(bias_relu):
    x = _rand((2, 4, 6, 8, 16), 20)
    w = _rand((16, 24), 21, 0.2)
    b = _rand((24,), 22, 0.5) if bias_relu else None
    with pltpu.force_tpu_interpret_mode():
        want = pointwise_conv(jnp.asarray(x), jnp.asarray(w),
                              None if b is None else jnp.asarray(b),
                              relu=bias_relu)
    got = conv3d.pointwise_conv(*_t(x, w, b), relu=bias_relu)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("shape", [(1, 4, 5, 6, 8), (2, 3, 3, 2, 16)])
def test_conv_transpose2x_matches_pallas(shape):
    """Odd edges and two batch items: the tap flip and the depth-to-space
    order (B, D, H, W, 2, 2, 2, C) → (B, 2D, 2H, 2W, C)."""
    x = _rand(shape, 30)
    w = _rand((2, 2, 2, shape[-1], 4), 31, 0.3)
    with pltpu.force_tpu_interpret_mode():
        want = conv_transpose2x(jnp.asarray(x), jnp.asarray(w))
    got = conv3d.conv_transpose2x(*_t(x, w))
    assert got.shape == want.shape == (shape[0], *(2 * s for s in shape[1:4]),
                                       4)
    _close(got, want, 2e-5)


def test_pointwise_and_transpose_gradients_match_jax_grad():
    x = _rand((1, 3, 4, 5, 8), 40)
    wp = _rand((8, 6), 41, 0.3)
    bp = _rand((6,), 42, 0.5)
    wt = _rand((2, 2, 2, 6, 4), 43, 0.3)
    dy = _rand((1, 6, 8, 10, 4), 44)

    def jloss(xx, ww, bb, vv):
        with pltpu.force_tpu_interpret_mode():
            h = pointwise_conv(xx, ww, bb, relu=True)
            y = conv_transpose2x(h, vv, relu=True)
        return jnp.sum(y * dy)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (x, wp, bp, wt)))
    ts = _t(x, wp, bp, wt, grad=True)
    h = conv3d.pointwise_conv(ts[0], ts[1], ts[2], relu=True)
    conv3d.conv_transpose2x(h, ts[3], relu=True).backward(
        torch.from_numpy(dy))
    for g, wnt in zip((t.grad for t in ts), want):
        _close(g, wnt, 1e-4)


def test_bf16_convs_round_once_like_pallas():
    """bf16 K6 (stride 2), K7 and K4 on the same bf16 inputs: within 1 bf16
    ulp of the Pallas kernels, which accumulate in fp32 and round once."""
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    x = bf(_rand((1, 6, 6, 8, 8), 50))
    w6 = bf(_rand((3, 3, 3, 8, 8), 51, 0.2))
    w7 = bf(_rand((8, 8), 52, 0.3))
    w4 = bf(_rand((2, 2, 2, 8, 8), 53, 0.3))
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = [jax_conv3d(j16(x), j16(w6), None, 2, 1, False,
                           interpret=True),
                pointwise_conv(j16(x), j16(w7)),
                conv_transpose2x(j16(x), j16(w4))]
    t16 = lambda a: torch.from_numpy(a).bfloat16()
    got = [conv3d.conv3d(t16(x), t16(w6), None, 2, 1),
           conv3d.pointwise_conv(t16(x), t16(w7)),
           conv3d.conv_transpose2x(t16(x), t16(w4))]
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _bf16_ulps(g.float(), np.asarray(wnt, np.float32)).max() <= 1


@pytest.mark.parametrize("relu", [False, True])
def test_pointwise_conv_bf16_rounds_its_bias_like_pallas(relu):
    """bf16 K7 with an fp32 bias of scale 37 (a bf16 ulp of 0.25 there):
    the reference's kernel concatenates the bias into w as a bf16 row
    (`conv3d.py:311`) before its fp32 add, so the port rounds it to w's
    dtype too.  Bit-equal in bf16: y is the same fp32 sum of 8 products
    plus the same bias, rounded once."""
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    x = bf(_rand((1, 4, 4, 4, 8), 60))
    w = bf(_rand((8, 8), 61, 8 ** -0.5))
    b = _rand((8,), 63, 37.0)     # both signs: ReLU keeps some of y
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = pointwise_conv(j16(x), j16(w), jnp.asarray(b), relu=relu)
    got = conv3d.pointwise_conv(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(w).bfloat16(),
                                torch.from_numpy(b), relu=relu)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_conv_wrappers_refuse_bad_shapes_and_devices():
    x = torch.zeros(1, 4, 4, 4, 3)
    with pytest.raises(ValueError):
        conv3d.conv3d(x, torch.zeros(3, 3, 3, 2, 5))           # Cin mismatch
    with pytest.raises(ValueError):
        conv3d.conv3d(x, torch.zeros(3, 3, 3, 3, 5), stride=3)
    with pytest.raises(ValueError):
        conv3d.conv3d(x, torch.zeros(3, 3, 3, 3, 5), torch.zeros(4))
    with pytest.raises(ValueError):
        conv3d.pointwise_conv(x, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        conv3d.conv_transpose2x(x, torch.zeros(3, 3, 3, 3, 2))
    meta = torch.zeros(1, 2, 2, 2, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        conv3d.pointwise_conv(meta, torch.zeros(3, 2, device="meta"))


def test_same_pad_matches_the_reference():
    for size in (5, 6, 7, 8, 16):
        for stride in (1, 2):
            for dil in (1, 2):
                assert conv3d.same_pad(size, 3, stride, dil) \
                    == _same_pad(size, stride, 3, dil)
