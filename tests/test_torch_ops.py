"""Each ported op (nas_3d_unet_tpu_torch/ops/primitives.py) against its JAX
counterpart, unpacked and lane-packed, with the same parameters carried
across by the bridge.

Tolerances follow tests/test_torch_parity.py: ATOL 2e-5 / rtol 1e-4, and
5e-5 where GroupNorm normalizes (`:82`).  These pin the reference's GN
numerics (eps 1e-6, variance from raw moments without a clamp), the
asymmetric SAME pad at stride 2, the k2s2 transpose conv's tap flip and the
merged-edge channel slicing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.ops import primitives as jp
from nas_3d_unet_tpu.ops.packed import PX
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.ops import groupnorm
from nas_3d_unet_tpu_torch.ops import primitives as tp
from tests.torch_helpers import one_torch_thread  # noqa: F401

GN_ATOL = 5e-5


def _pair(jmod, tmod, x, seed=0, r=None):
    """(JAX output, port output) for `x`, same params; r packs the JAX
    input by r W-voxels per lane group."""
    xj = jnp.asarray(x)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), xj)
    bridge.load_flax_params(tmod, params)
    if r:
        want = jax.jit(lambda p, v: jmod.apply(p, PX.pack(v, r)).unpack())(
            params, xj)
    else:
        want = jax.jit(jmod.apply)(params, xj)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    return np.asarray(want), got.numpy()


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (kernel, stride, dilation); odd D/H sizes put the stride-2 SAME pad's odd
# voxel on the high side
CNA = [(3, 1, 1), (3, 1, 2), (3, 2, 1), (3, 2, 2), (1, 1, 1), (1, 2, 1)]


@pytest.mark.parametrize("kernel,stride,dilation", CNA)
@pytest.mark.parametrize("r", [None, 4])
def test_conv_norm_act(kernel, stride, dilation, r):
    cin, c, g = 6, 8, 4
    x = _x((2, 7, 5, 16 if r else 9, cin), seed=kernel + stride + dilation)
    jmod = jp.ConvNormAct(c, kernel, stride, dilation, gn_groups=g)
    tmod = tp.ConvNormAct(cin, c, kernel, stride, dilation, gn_groups=g)
    want, got = _pair(jmod, tmod, x, r=r)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=GN_ATOL)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("r", [None, 4])
def test_sep_conv(stride, r):
    c = 8
    x = _x((2, 7, 5, 16 if r else 9, c), seed=stride)
    want, got = _pair(jp.SepConv(c, stride, gn_groups=4),
                      tp.SepConv(c, c, stride, gn_groups=4), x, r=r)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=GN_ATOL)


@pytest.mark.parametrize("r", [None, 2])
def test_up_transpose(r):
    x = _x((2, 3, 4, 4, 6), seed=3)
    want, got = _pair(jp.UpTranspose(4, gn_groups=2),
                      tp.UpTranspose(6, 4, gn_groups=2), x, r=r)
    assert got.shape == (2, 6, 8, 8, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=GN_ATOL)


def test_transpose_conv_tap_flip_without_norm(monkeypatch):
    """The deconv alone, against lax.conv_transpose, at ATOL 2e-5."""
    x = _x((1, 3, 4, 5, 6), seed=4)
    w = _x((2, 2, 2, 6, 3), seed=5) * 0.3
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(w), (2, 2, 2),
                                  "VALID", dimension_numbers=("NDHWC",
                                                              "DHWIO",
                                                              "NDHWC"))
    mod = tp.UpTranspose(6, 3, gn_groups=1)
    mod.deconv.kernel.data = torch.from_numpy(w)
    captured = {}

    def capture(y, *args, **kw):      # the deconv output, before the norm
        captured["y"] = y
        return y

    monkeypatch.setattr(tp, "group_norm", capture)
    with torch.no_grad():
        mod(torch.from_numpy(x))
    np.testing.assert_allclose(captured["y"].numpy(), np.asarray(want),
                               rtol=1e-4, atol=2e-5)


def test_group_norm_matches_flax():
    x = _x((2, 5, 6, 7, 16), seed=6) * 3 + 1
    scale, bias = _x((16,), 7), _x((16,), 8)
    from flax import linen as nn
    want = nn.GroupNorm(num_groups=4).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x))
    got = groupnorm.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), 4, relu=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=GN_ATOL)


def test_merged_op_slices_equal_separate_ops():
    """A k·C-wide conv with k·g groups is k independent C-wide convs: each
    channel slice of the wide op equals the narrow op on its kernel slice."""
    c, g, k = 4, 2, 2
    x = torch.from_numpy(_x((1, 6, 6, 6, c), seed=9))
    wide = tp.make_op("conv3", c, k * c, k * g)
    bridge.load_flax_params(wide, bridge.random_flax_params(wide, 1))
    with torch.no_grad():
        out = wide(x)
        for e in range(k):
            narrow = tp.make_op("conv3", c, c, g)
            narrow.conv.kernel.copy_(wide.conv.kernel[..., e * c:(e + 1) * c])
            np.testing.assert_allclose(out[..., e * c:(e + 1) * c].numpy(),
                                       narrow(x).numpy(), rtol=1e-4,
                                       atol=GN_ATOL)


def test_make_op_builds_every_registered_op():
    """Every name of NORMAL_OPS, DOWN_OPS and UP_OPS builds (the same
    registry as the JAX package's); an unknown name raises KeyError."""
    assert set(tp._FACTORIES) == set(jp._FACTORIES) == {
        *tp.NORMAL_OPS, *tp.DOWN_OPS, *tp.UP_OPS}
    for name in (*tp.NORMAL_OPS, *tp.DOWN_OPS, *tp.UP_OPS):
        assert isinstance(tp.make_op(name, 4, 4), torch.nn.Module)
    with pytest.raises(KeyError):
        tp.make_op("conv7", 4, 4)
    assert set(tp.NORMAL_OPS) == set(jp.NORMAL_OPS)
    assert set(tp.DOWN_OPS) == set(jp.DOWN_OPS)
    assert set(tp.UP_OPS) == set(jp.UP_OPS)
    for c, g in ((48, 8), (12, 8), (7, 8), (3, 8)):
        assert tp._gn_groups_for(c, g) == jp._gn_groups_for(c, g)
