"""Every candidate op of the search (nas_3d_unet_tpu_torch/ops/primitives.py,
ops/pool.py) against the JAX package's, with the same parameters carried
across by the bridge.

fp32: each op of NORMAL_OPS, DOWN_OPS and UP_OPS, forward and VJP (x and
every parameter) against the unpacked JAX op (flax convs and GroupNorm,
`nn.avg_pool`, `max_pool3_shifted`, `jax.image.resize`), at
test_torch_ops.py's tolerance (rtol 1e-4, atol 5e-5 where GroupNorm
normalizes); the norms "instance" and "none" likewise.

bf16, against the path whose rounding the port follows:
  * the pools, `identity` and `none` against the shipped packed JAX op on
    a W-packed input (`packed_avg_pool3`: an fp32 sum rounded once;
    `packed_max_pool3`), forward and VJP within 1 bf16 ulp (the max
    pool's VJP against `max_pool3_shifted`, whose tie order the port
    follows, exactly);
  * the trilinear upsample against `packed_resize2x` (fp32, one rounding),
    forward and VJP within 1 ulp;
  * the conv ops against a reference built from the JAX package's own
    functions with the port's rounding points: the conv (or upsample) in
    fp32 on the bf16 values, rounded once, then `packed_group_norm` in
    bf16 with its ReLU (`packed.py:794`); forward and VJP within BF16_ULPS.
    The reference's XLA path on the CPU rounds each depth tap of a conv
    instead (`packed.py:211-216`, ROADMAP.md queue 3), so it is not the
    yardstick here; K1's one rounding is pinned against the Pallas
    `conv_pgemm` in test_torch_pgemm.py.
The max pool's gradient splits ties as `lax.max` does (post-ReLU zero
plateaus); the avg pool's divisor counts in-bounds taps at odd and even
sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from nas_3d_unet_tpu.ops import primitives as jp
from nas_3d_unet_tpu.ops.packed import (PX, max_pool3_shifted, pack,
                                        packed_avg_pool3, packed_group_norm,
                                        packed_max_pool3, packed_resize2x,
                                        standard_layout, unpack)
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.ops import pool
from nas_3d_unet_tpu_torch.ops import primitives as tp

GN_ATOL = 5e-5
BF16_ULPS = 2
C, G = 8, 4
OPS = (*tp.NORMAL_OPS, *tp.DOWN_OPS, *tp.UP_OPS)
PARAM_FREE = ("none", "identity", "avg_pool3", "max_pool3", "down_avg_pool",
              "down_max_pool")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _shape(name):
    """Odd D and H put the stride-2 pad's odd voxel on the high side; W
    even for the packed (r = 2) reference."""
    return (2, 3, 4, 4, C) if name.startswith("up") else (2, 7, 5, 8, C)


def _params(tmod, seed):
    """A flax tree for `tmod` from `seed`, GroupNorm affines random too."""
    flat = bridge.params_from_flax(bridge.random_flax_params(tmod, seed))
    rng = np.random.default_rng(seed + 50)
    for key, t in flat.items():
        if key.endswith("norm.scale") or key.endswith("norm.bias"):
            t.copy_(torch.from_numpy((rng.standard_normal(t.shape) * 0.3
                                      + key.endswith("scale"))
                                     .astype(np.float32)))
    tree = bridge.params_to_flax(flat)
    bridge.load_flax_params(tmod, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree) if flat else {}


def _port_vjp(tmod, x, ct, dtype=torch.float32):
    """(y, dx, {param: grad}) of the port's op; dx None where y does not
    depend on x (the `none` op)."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    y = tmod(xt)
    if not y.requires_grad:
        return y.detach().float().numpy(), None, {}
    y.backward(torch.from_numpy(ct).to(dtype))
    grads = {n: p.grad.numpy() for n, p in tmod.named_parameters()}
    return y.detach().float().numpy(), xt.grad.float().numpy(), grads


def jax_vjp(f, primals, seed):
    """(f's outputs, the cotangents, the VJP) in one jitted call: one
    cotangent per output leaf, from `seed` onward, in its dtype."""
    leaves, tree = jax.tree_util.tree_flatten(jax.eval_shape(f, *primals))
    cts = tree.unflatten([jnp.asarray(_x(l.shape, seed + i), l.dtype)
                          for i, l in enumerate(leaves)])

    def run(p, ct):
        out, vjp = jax.vjp(f, *p)
        return out, vjp(ct)

    out, grads = jax.jit(run)(primals, cts)
    return out, cts, grads


def _jit_vjp(f, primals, ct):
    """(f's output, its VJP at `ct`) in one jitted call, as the JAX
    package runs its ops."""
    def run(p, c):
        out, vjp = jax.vjp(f, *p)
        return out, vjp(c)

    return jax.jit(run)(primals, ct)


def _close(got, want, atol=GN_ATOL):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=1e-4,
                               atol=atol)


@pytest.mark.parametrize("name", OPS)
def test_op_forward_and_vjp_match_jax_fp32(name):
    x = _x(_shape(name), 1)
    tmod = tp.make_op(name, C, C, G)
    params = _params(tmod, 2)
    jmod = jp.make_op(name, C, "group", G, jnp.float32)
    y, ct, (dp, dx) = jax_vjp(lambda p, xx: jmod.apply(p, xx),
                              (params, jnp.asarray(x)), 3)
    got_y, got_dx, got_dp = _port_vjp(tmod, x, np.array(ct))
    assert got_y.shape == y.shape
    _close(got_y, y)
    if got_dx is None:
        assert name == "none" and not np.any(np.asarray(dx))
    else:
        _close(got_dx, dx)
    want_dp = bridge.params_from_flax(dp) if got_dp else {}
    assert set(got_dp) == set(want_dp)
    for k, g in got_dp.items():
        _close(g, want_dp[k])


def _bf16(a):
    """An array's values rounded to bf16, as fp32 numpy."""
    return np.array(jnp.asarray(jnp.asarray(a, jnp.bfloat16), jnp.float32))


def _ulps(got, want):
    """|got − want| in bf16 ulps of max(|want|, 2⁻⁸)."""
    want = np.asarray(want, np.float64)
    e = np.frexp(np.maximum(np.abs(want), 2.0 ** -8))[1]
    return np.abs(np.asarray(got, np.float64) - want) / np.ldexp(1.0, e - 8)


def _conv(x, w, stride, dilation, groups=1):
    """lax's SAME conv in fp32 on bf16 values, rounded once to bf16."""
    y = jax.lax.conv_general_dilated(
        x.astype(jnp.float32), w.astype(jnp.bfloat16).astype(jnp.float32),
        (stride,) * 3, "SAME", rhs_dilation=(dilation,) * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        feature_group_count=groups)
    return y.astype(jnp.bfloat16)


def _gn_relu(y, p):
    lay = standard_layout(1, y.shape[-1])
    return unpack(packed_group_norm(pack(y, 1), p["norm"]["scale"],
                                    p["norm"]["bias"], G, lay, relu=True), 1)


def _cna(x, p, stride=1, dilation=1):
    return _gn_relu(_conv(x, p["conv"]["kernel"], stride, dilation), p)


def _sep(x, p, stride=1):
    y = _conv(x, p["dw"]["kernel"], stride, 1, groups=x.shape[-1])
    return _gn_relu(_conv(y, p["pw"]["kernel"], 1, 1), p)


def _transpose(x, p):
    y = jax.lax.conv_transpose(
        x.astype(jnp.float32),
        p["deconv"]["kernel"].astype(jnp.bfloat16).astype(jnp.float32),
        (2, 2, 2), "VALID", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    return _gn_relu(y.astype(jnp.bfloat16), p)


def _up(x):
    return unpack(packed_resize2x(pack(x, 1), standard_layout(1,
                                                               x.shape[-1])),
                  2)


def _pool(kind, stride):
    """The shipped packed pool on a W-packed (r = 2) input."""
    def f(x):
        lay = standard_layout(2, x.shape[-1])
        if kind == "avg":
            y = packed_avg_pool3(pack(x, 2), lay, w_in=x.shape[3],
                                 stride=stride)
        else:
            y = packed_max_pool3(pack(x, 2), lay, stride=stride)
        return unpack(y, 2 if stride == 1 else 1)
    return f


REF_BF16 = {
    "none": lambda p, x: jnp.zeros_like(x),
    "identity": lambda p, x: x,
    "conv3": lambda p, x: _cna(x, p["params"]),
    "dil_conv3": lambda p, x: _cna(x, p["params"], 1, 2),
    "sep_conv3": lambda p, x: _sep(x, p["params"]),
    "avg_pool3": lambda p, x: _pool("avg", 1)(x),
    "max_pool3": lambda p, x: _pool("max", 1)(x),
    "down_avg_pool": lambda p, x: _pool("avg", 2)(x),
    "down_max_pool": lambda p, x: _pool("max", 2)(x),
    "down_conv3": lambda p, x: _cna(x, p["params"], 2),
    "down_dil_conv3": lambda p, x: _cna(x, p["params"], 2, 2),
    "down_sep_conv3": lambda p, x: _sep(x, p["params"], 2),
    "up_transpose": lambda p, x: _transpose(x, p["params"]),
    "up_conv3": lambda p, x: _cna(_up(x), p["params"]["ConvNormAct_0"]),
    "up_sep_conv3": lambda p, x: _sep(_up(x), p["params"]["SepConv_0"]),
}


@pytest.mark.parametrize("name", OPS)
def test_op_bf16_matches_the_rounding_it_follows(name):
    x = _bf16(_x(_shape(name), 4))
    tmod = tp.make_op(name, C, C, G)
    params = _params(tmod, 5)
    xb = jnp.asarray(x, jnp.bfloat16)
    ct = _bf16(_x(jax.eval_shape(REF_BF16[name], params, xb).shape, 6))
    y, (dp, dx) = _jit_vjp(REF_BF16[name], (params, xb),
                           jnp.asarray(ct, jnp.bfloat16))
    got_y, got_dx, got_dp = _port_vjp(tmod, x, ct, torch.bfloat16)
    tol = 1 if name in PARAM_FREE else BF16_ULPS
    assert _ulps(got_y, np.asarray(y, np.float32)).max() <= tol
    if got_dx is None:
        assert name == "none"
        return
    want_dx = np.asarray(dx, np.float32)
    if "max_pool" in name:             # the port's tie order: D, H, W
        stride = 2 if "down" in name else 1
        want_dx = np.asarray(_jit_vjp(
            lambda xx: max_pool3_shifted(xx, stride), (xb,),
            jnp.asarray(ct, jnp.bfloat16))[1][0], np.float32)
        np.testing.assert_array_equal(got_dx, want_dx)
    assert _ulps(got_dx, want_dx).max() <= tol
    want_dp = bridge.params_from_flax(dp) if got_dp else {}
    for k, g in got_dp.items():        # fp32 parameters, bf16-rounded grads
        assert _ulps(g, want_dp[k].numpy()).max() <= BF16_ULPS, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_max_pool_splits_tied_gradients_like_lax(dtype, stride):
    """A post-ReLU input, ~93 % exact zeros: every tie's gradient is
    split as `max_pool3_shifted`'s (`jnp.maximum`'s 0.5 / 0.5 per pair),
    bit for bit; routing it to the first maximum (`F.max_pool3d` on the
    same −inf pads) gives another gradient."""
    x = np.maximum(_x((1, 6, 7, 5, 3), 7) - 1.5, 0)
    ct = _bf16(np.abs(_x((1, *(-(-n // stride) for n in x.shape[1:4]), 3),
                         8)))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    y, (want,) = _jit_vjp(lambda xx: max_pool3_shifted(xx, stride),
                          (jnp.asarray(x, jdt),), jnp.asarray(ct, jdt))
    want = np.asarray(want, np.float32)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    out = pool.max_pool3(xt, stride)
    out.backward(torch.from_numpy(ct).to(dtype))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(y, np.float32))
    got = xt.grad.float().numpy()
    np.testing.assert_array_equal(got, want)

    xf = torch.from_numpy(x).requires_grad_()
    pads = []
    for n in reversed(x.shape[1:4]):
        pads += pool.same_pad(n, 3, stride, 1)
    first = torch.nn.functional.max_pool3d(
        torch.nn.functional.pad(xf.permute(0, 4, 1, 2, 3), pads,
                                value=float("-inf")), 3, stride)
    first.backward(torch.from_numpy(ct).permute(0, 4, 1, 2, 3))
    assert not np.allclose(xf.grad.numpy(), got)


@pytest.mark.parametrize("stride", [1, 2])
def test_max_pool_grad_matches_packed_on_tie_free_input(stride):
    """The shipped packed pool takes W, then D, then H: the same forward
    and, without ties, the same gradient (fp32: a permutation of 0..63 per
    channel; the summation order of an input's cotangents differs)."""
    rng = np.random.default_rng(8)
    x = np.stack([rng.permutation(64).reshape(4, 4, 4) for _ in range(C)],
                 -1)[None].astype(np.float32)
    ct = _x(jax.eval_shape(_pool("max", stride), x).shape, 9)
    y, (want,) = _jit_vjp(_pool("max", stride), (jnp.asarray(x),),
                          jnp.asarray(ct))
    want = np.asarray(want)
    xt = torch.from_numpy(x).requires_grad_()
    out = pool.max_pool3(xt, stride)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [(5, 6, 7), (6, 6, 6), (7, 5, 4)])
@pytest.mark.parametrize("stride", [1, 2])
def test_avg_pool_divides_by_the_in_bounds_taps(size, stride):
    """count_include_pad=False with lax's SAME pads (the odd one high at
    stride 2), against flax's `nn.avg_pool` in fp32; the per-axis counts
    spelled out."""
    x = _x((2, *size, 3), 10)
    want = nn.avg_pool(jnp.asarray(x), (3, 3, 3), strides=(stride,) * 3,
                       padding="SAME", count_include_pad=False)
    got = pool.avg_pool3(torch.from_numpy(x), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    ones = pool.avg_pool3(torch.ones((1, *size, 1)), stride)
    assert torch.equal(ones, torch.ones_like(ones))
    assert pool._counts(5, 1) == [2, 3, 3, 3, 2]
    assert pool._counts(5, 2) == [2, 3, 2]         # pads (1, 1)
    assert pool._counts(6, 2) == [3, 3, 2]         # pads (0, 1)


def test_upsample_matches_jax_image_resize():
    """`F.interpolate` trilinear, half-pixel, edges clamped: fp32 within
    1e-6 of `jax.image.resize`, borders included."""
    x = _x((2, 3, 4, 5, 6), 11)
    want = jax.image.resize(jnp.asarray(x), (2, 6, 8, 10, 6), "trilinear")
    got = pool.upsample2x(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


NORM_CASES = [("conv3", "instance"), ("down_sep_conv3", "instance"),
              ("up_transpose", "instance"), ("conv3", "none"),
              ("down_conv3", "none"), ("up_sep_conv3", "none")]


@pytest.mark.parametrize("name,norm", NORM_CASES)
def test_norms_instance_and_none_match_jax(name, norm):
    """"instance" is GroupNorm with one group a channel; "none" is no norm
    and no `norm` parameters, the ReLU still applied."""
    x = _x(_shape(name), 12)
    tmod = tp.make_op(name, C, C, G, norm=norm)
    keys = tmod.state_dict()
    assert any(".norm." in f".{k}" for k in keys) == (norm != "none")
    params = _params(tmod, 13)
    jmod = jp.make_op(name, C, norm, G, jnp.float32)
    y, ct, (dp, dx) = jax_vjp(lambda p, xx: jmod.apply(p, xx),
                              (params, jnp.asarray(x)), 14)
    got_y, got_dx, got_dp = _port_vjp(tmod, x, np.array(ct))
    _close(got_y, y)
    _close(got_dx, dx)
    want_dp = bridge.params_from_flax(dp)
    assert set(got_dp) == set(want_dp)
    for k, g in got_dp.items():
        _close(g, want_dp[k])
    if norm == "instance":
        assert all(m.groups == m.scale.shape[0] for m in tmod.modules()
                   if isinstance(m, tp.Norm))
