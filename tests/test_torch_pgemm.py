"""The port's K1/K2 twins (nas_3d_unet_tpu_torch/ops/pgemm.py) against the
JAX kernels they replace, on CPU, forward and backward.

The JAX side runs the Pallas kernels in interpret mode, as
tests/test_fused_convgn.py does.  Its packed outputs are unpacked and its
packed moments (B, r·C) folded over r to (B, C).  Tolerances are
test_fused_convgn.py's: rtol 1e-5 / atol 1e-5 on y, atol 1e-4 on the
moments (fp32 sums in another order).  The backward of the port's autograd
Functions (on the CPU: the twin conv with the flip-transposed kernel for
dx) is held against `jax.vjp` of `_pg_stats_fn` / `_gemm_stats_fn` at
rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.ops.packed import (pack, packed_conv_stats,
                                        standard_layout, unpack)
from nas_3d_unet_tpu.ops.pallas.pgemm import gemm_stats as jax_gemm_stats
from nas_3d_unet_tpu_torch.ops import _cuda, pgemm
from tests.torch_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    monkeypatch.setenv("NAS3D_PG_INTERPRET", "1")
    monkeypatch.setenv("NAS3D_FUSED_CONVGN", "1")


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=atol)


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("dilation", [1, 2])
def test_conv3x3x3_twin_matches_conv_pgemm(r, dilation):
    b, d, h, w, cin, cout = 2, 6, 5, 8 * r, 3, 5
    rng = np.random.default_rng(10 * r + dilation)
    x = rng.standard_normal((b, d, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)

    y, s1, s2 = packed_conv_stats(
        pack(jnp.asarray(x), r), jnp.asarray(k), standard_layout(r, cin),
        standard_layout(r, cout), w_in=w, dilation=dilation)
    fold = lambda s: np.asarray(s).reshape(b, r, cout).sum(1)

    _cuda.LAUNCHES.clear()
    yt, s1t, s2t = pgemm.conv3x3x3_stats(torch.from_numpy(x),
                                         torch.from_numpy(k), dilation)
    _close(yt, unpack(y, r), 1e-5)
    _close(s1t, fold(s1), 1e-4)
    _close(s2t, fold(s2), 1e-4)
    assert not _cuda.LAUNCHES          # a CPU tensor never counts a launch


@pytest.mark.parametrize("v", [37, 64])
def test_gemm_stats_twin_matches_pallas(v):
    b, k, n = 2, 12, 7
    rng = np.random.default_rng(v)
    x = rng.standard_normal((b, v, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)

    # rows_pb=16: the ragged tail of v=37 exercises the reference's mask
    y, s1, s2 = jax_gemm_stats(jnp.asarray(x), jnp.asarray(w), rows_pb=16,
                               interpret=True)

    _cuda.LAUNCHES.clear()
    yt, s1t, s2t = pgemm.gemm_stats(torch.from_numpy(x), torch.from_numpy(w))
    _close(yt, y, 1e-5)
    _close(s1t, s1, 1e-4)
    _close(s2t, s2, 1e-4)
    assert not _cuda.LAUNCHES


def test_wrappers_refuse_bad_shapes_and_devices():
    x = torch.zeros(1, 4, 4, 4, 3)
    with pytest.raises(ValueError):
        pgemm.conv3x3x3_stats(x, torch.zeros(3, 3, 3, 2, 5))   # Cin mismatch
    with pytest.raises(ValueError):
        pgemm.conv3x3x3_stats(x, torch.zeros(3, 3, 3, 3, 5), dilation=3)
    with pytest.raises(ValueError):
        pgemm.gemm_stats(torch.zeros(1, 8, 3), torch.zeros(4, 2))
    # neither CPU nor CUDA: no twin, no kernel
    meta = torch.zeros(1, 8, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pgemm.gemm_stats(meta, torch.zeros(3, 2, device="meta"))


def _vjp_pair(x, k, dy, kernel, dilation, r):
    """(JAX dx, dW) from `jax.vjp` of packed_conv_stats (the kernel's custom
    VJP, stats cotangents zero) and the port's (dx, dW) from autograd."""
    cin, cout = x.shape[-1], k.shape[-1]
    w_in = x.shape[3]

    def f(xp, kk):
        return packed_conv_stats(xp, kk, standard_layout(r, cin),
                                 standard_layout(r, cout), w_in=w_in,
                                 kernel=kernel, dilation=dilation)

    def grads(xp, kk, dyp):
        (_, s1, s2), vjp = jax.vjp(f, xp, kk)
        return vjp((dyp, jnp.zeros_like(s1), jnp.zeros_like(s2)))

    dxp, dk = jax.jit(grads)(pack(jnp.asarray(x), r), jnp.asarray(k),
                             pack(jnp.asarray(dy), r))

    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    if kernel == (3, 3, 3):
        yt, s1t, s2t = pgemm.conv3x3x3_stats(xt, kt, dilation)
    else:
        b = x.shape[0]
        yt, s1t, s2t = pgemm.gemm_stats(xt.view(b, -1, cin),
                                        kt.view(cin, cout))
        yt = yt.view(dy.shape)
    assert not (s1t.requires_grad or s2t.requires_grad)   # dropped
    yt.backward(torch.from_numpy(dy))
    return (unpack(dxp, r), dk), (xt.grad, kt.grad)


@pytest.mark.parametrize("dilation", [1, 2])
def test_conv3x3x3_stats_backward_matches_pg_stats_vjp(dilation):
    b, d, h, w, cin, cout, r = 1, 3, 4, 16, 2, 3, 2
    rng = np.random.default_rng(30 + dilation)
    x = rng.standard_normal((b, d, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    dy = rng.standard_normal((b, d, h, w, cout)).astype(np.float32)
    _cuda.LAUNCHES.clear()
    want, got = _vjp_pair(x, k, dy, (3, 3, 3), dilation, r)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-4,
                                   atol=1e-5)
    assert not _cuda.LAUNCHES


def test_gemm_stats_backward_matches_gemm_stats_vjp():
    b, d, h, w, k, n, r = 2, 3, 4, 8, 6, 5, 4
    rng = np.random.default_rng(40)
    x = rng.standard_normal((b, d, h, w, k)).astype(np.float32)
    wk = (rng.standard_normal((1, 1, 1, k, n)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, d, h, w, n)).astype(np.float32)
    want, got = _vjp_pair(x, wk, dy, (1, 1, 1), 1, r)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-4,
                                   atol=1e-5)


def _bf16_ulps(got, want):
    """|got − want| in bf16 ulps of max(|want|, 2⁻⁸)."""
    want = np.asarray(want, np.float64)
    e = np.frexp(np.maximum(np.abs(want), 2.0 ** -8))[1]
    return np.abs(np.asarray(got, np.float64) - want) / np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("kernel", [(3, 3, 3), (1, 1, 1)])
def test_bf16_forward_and_backward_match_the_pallas_vjp(kernel):
    """bf16 K1 (on the CPU: the twin, and the twin conv with the
    flip-transposed kernel for dx) and K2 against `jax.vjp` of
    `_pg_stats_fn` / `_gemm_stats_fn` on the same bf16 inputs: y and dx
    within 1 bf16 ulp, the moments as fp32 sums of the ROUNDED y to 1e-6
    of Σ|y| and Σy² (sums of the unrounded y miss by ~1e-4 here), dW
    (bf16, rounded from fp32 sums in another order) within 2 ulps of
    max|dW|.  W/r = 16: the bf16 kernel's sublane tile."""
    b, d, h, w, cin, cout, r = 1, 3, 4, 32, 2, 3, 2
    rng = np.random.default_rng(50)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    x = bf(rng.standard_normal((b, d, h, w, cin)))
    k = bf(rng.standard_normal((*kernel, cin, cout)) * 0.3)
    dy = bf(rng.standard_normal((b, d, h, w, cout)))
    lay_i, lay_o = standard_layout(r, cin), standard_layout(r, cout)

    def f(xp, kk):
        return packed_conv_stats(xp, kk, lay_i, lay_o, w_in=w,
                                 kernel=kernel)

    def fwd_bwd(xp, kk, dyp):
        (y, s1, s2), vjp = jax.vjp(f, xp, kk)
        return (y, s1, s2), vjp((dyp, jnp.zeros_like(s1),
                                 jnp.zeros_like(s2)))

    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    (y, s1, s2), (dxp, dk) = jax.jit(fwd_bwd)(pack(j16(x), r), j16(k),
                                              pack(j16(dy), r))
    f32 = lambda a: np.array(jnp.asarray(a, jnp.float32))
    fold = lambda s: np.asarray(s).reshape(b, r, cout).sum(1)

    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    kt = torch.from_numpy(k).bfloat16().requires_grad_()
    _cuda.LAUNCHES.clear()
    if kernel == (3, 3, 3):
        yt, s1t, s2t = pgemm.conv3x3x3_stats(xt, kt)
    else:
        yt, s1t, s2t = pgemm.gemm_stats(xt.view(b, -1, cin),
                                        kt.view(cin, cout))
        yt = yt.view(dy.shape)
    yt.backward(torch.from_numpy(dy).bfloat16())
    assert not _cuda.LAUNCHES
    assert yt.dtype == xt.grad.dtype == kt.grad.dtype == torch.bfloat16
    y_want = f32(unpack(y, r))
    assert _bf16_ulps(yt.detach().float(), y_want).max() <= 1
    assert _bf16_ulps(xt.grad.float(), f32(unpack(dxp, r))).max() <= 1
    dk_want = f32(dk)
    assert np.abs(kt.grad.float().numpy() - dk_want).max() \
        <= 2 * np.ldexp(1.0, np.frexp(np.abs(dk_want).max())[1] - 8)
    yd = y_want.astype(np.float64).reshape(b, -1, cout)
    np.testing.assert_allclose(s1t.numpy(), fold(s1), rtol=0,
                               atol=1e-6 * np.abs(yd).sum(1).max())
    np.testing.assert_allclose(s2t.numpy(), fold(s2), rtol=1e-6)


def test_conv_backward_skips_dx_when_x_needs_none(monkeypatch):
    """The stem's input needs no gradient: K1's backward runs no dx conv."""
    calls = []
    k1 = pgemm._k1

    def noted(x, w, dilation, with_stats):
        calls.append(with_stats)
        return k1(x, w, dilation, with_stats)

    monkeypatch.setattr(pgemm, "_k1", noted)
    x = torch.randn(1, 4, 4, 4, 2)
    w = torch.randn(3, 3, 3, 2, 3, requires_grad=True)
    y, _, _ = pgemm.conv3x3x3_stats(x, w)
    y.sum().backward()
    assert calls == [True] and w.grad is not None
    x.requires_grad_()
    y, _, _ = pgemm.conv3x3x3_stats(x, w)
    y.sum().backward()
    assert calls == [True, True, False] and x.grad is not None
