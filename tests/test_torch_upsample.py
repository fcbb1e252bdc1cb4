"""The trilinear 2× upsample (nas_3d_unet_tpu_torch/ops/pool.py
`upsample2x`), a separable stencil of shifted slices:

  * against `jax.image.resize` trilinear (half-pixel, edges clamped) in
    fp32 within 1e-6, as test_torch_search_ops.py holds it, at even, odd
    and one-plane sizes; in bf16 the fp32 resize of the bf16 values
    rounded once, within 1 bf16 ulp;
  * `gradcheck` and `gradgradcheck` in float64 (the second-order search
    step differentiates its backward);
  * on the slabs of a 1 × 2 and a 1 × 3 spatial layout (the neighbours'
    planes handed over by a stand-in for the halo exchange, in one
    process), each slab's output the one-process output's planes, bit for
    bit, in fp32 and bf16;
  * no op of it that PyTorch counts as nondeterministic: it runs under
    `torch.use_deterministic_algorithms(True)` forward and backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu_torch.ops import pool
from nas_3d_unet_tpu_torch.parallel import spatial
from nas_3d_unet_tpu_torch.parallel.spatial import Slab, sharded_d
from tests.torch_helpers import one_torch_thread  # noqa: F401

SHAPES = [(2, 3, 4, 5, 6), (1, 1, 2, 1, 3), (1, 4, 4, 4, 8),
          (2, 5, 3, 7, 2)]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _resize(x):
    b, d, h, w, c = x.shape
    return np.asarray(jax.jit(lambda t: jax.image.resize(
        t, (b, 2 * d, 2 * h, 2 * w, c), "trilinear"))(jnp.asarray(x)))


def _ulps(got, want):
    want_bf = torch.from_numpy(np.array(want)).bfloat16().float()
    step = torch.maximum(want_bf.abs(), torch.tensor(2.0 ** -8)) * 2.0 ** -7
    return ((got.float() - want_bf).abs() / step).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matches_jax_image_resize_fp32(shape):
    x = _x(shape, 1)
    got = pool.upsample2x(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), _resize(x), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bf16_is_the_fp32_resize_rounded_once(shape):
    xb = torch.from_numpy(_x(shape, 2)).bfloat16()
    got = pool.upsample2x(xb)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert _ulps(got, _resize(xb.float().numpy())).max() <= 1


def test_edge_planes_are_copies():
    """The clamp gives an edge output weight 1 on the edge input."""
    x = torch.from_numpy(_x((1, 3, 4, 5, 2), 3))
    y = pool.upsample2x(x)
    assert torch.equal(y[:, 0, 0, 0], x[:, 0, 0, 0])
    assert torch.equal(y[:, -1, -1, -1], x[:, -1, -1, -1])


@pytest.mark.parametrize("shape", [(1, 3, 2, 4, 2), (2, 1, 3, 2, 1)],
                         ids=str)
def test_gradcheck_and_gradgradcheck_float64(shape):
    x = torch.from_numpy(_x(shape, 4)).double().requires_grad_()
    assert torch.autograd.gradcheck(pool.upsample2x, (x,))
    assert torch.autograd.gradgradcheck(pool.upsample2x, (x,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [2, 3])
def test_slabs_give_the_one_process_bits(monkeypatch, dtype, size):
    """Each slab's upsample, with a plane of each neighbour (none at a
    global end), is the one-process output's planes bit for bit."""
    x = torch.from_numpy(_x((2, 4 * size, 6, 5, 3), 5)).to(dtype)
    want = pool.upsample2x(x)
    n = x.shape[1] // size

    def halo_d(t, lo, hi, fill, slab):    # the exchange, within one process
        assert fill is None and (lo, hi) == (1, 1)
        a = slab.index * n - (0 if slab.first else 1)
        b = (slab.index + 1) * n + (0 if slab.last else 1)
        return x[:, a:b]

    monkeypatch.setattr(spatial, "halo_d", halo_d)
    for index in range(size):
        slab = Slab(index, size)
        with sharded_d(slab):
            got = pool.upsample2x(slab.cut(x))
        assert got.dtype == dtype and got.is_contiguous()
        assert torch.equal(got, slab.cut(want)), index


def test_runs_under_deterministic_algorithms():
    """Forward, backward and the backward's derivative, each op one that
    PyTorch calls deterministic (it raises at any other)."""
    x = torch.from_numpy(_x((1, 3, 4, 2, 2), 6)).requires_grad_()
    v = torch.from_numpy(_x((1, 6, 8, 4, 2), 7)).requires_grad_()
    torch.use_deterministic_algorithms(True)
    try:
        (g,) = torch.autograd.grad(pool.upsample2x(x), x, v,
                                   create_graph=True)
        g.sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    # every output's weights sum to 1, so Σ dx = Σ v; v's gradient is the
    # upsample of ones
    assert torch.allclose(g.sum(), v.sum(), rtol=1e-5)
    assert torch.equal(v.grad, torch.ones_like(v))
