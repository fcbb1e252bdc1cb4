"""Numerical parity vs torch-CPU oracles (SURVEY.md §4).

The reference is PyTorch; these tests push identical weights through torch
ops (NCDHW) and our JAX modules (channels-last) and assert fp32 agreement.
torch is a test-harness dependency ONLY — framework code never imports it
(BASELINE.json: "no PyTorch in the build").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from nas_3d_unet_tpu.metrics.dice import dice_ce_loss, soft_dice_loss  # noqa: E402
from nas_3d_unet_tpu.ops.pallas.conv3d import _same_pad, conv3d_reference  # noqa: E402
from tests.torch_helpers import one_torch_thread  # noqa: F401

ATOL = 2e-5


def _to_torch_input(x_jax):
    # (B, D, H, W, C) → (B, C, D, H, W)
    return torch.from_numpy(np.asarray(x_jax).transpose(0, 4, 1, 2, 3).copy())


def _from_torch(y):
    return y.detach().numpy().transpose(0, 2, 3, 4, 1)


@pytest.mark.parametrize("stride,dil", [(1, 1), (2, 1), (1, 2)])
def test_conv3d_parity(stride, dil):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 10, 11, 5)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 5, 7)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(7) * 0.1).astype(np.float32)

    ours = np.asarray(conv3d_reference(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), stride, dil, False))

    xt = _to_torch_input(x)
    # replicate XLA SAME padding (may be asymmetric under stride 2)
    pads = [_same_pad(s, stride, 3, dil) for s in x.shape[1:4]]
    xt = F.pad(xt, (pads[2][0], pads[2][1], pads[1][0], pads[1][1],
                    pads[0][0], pads[0][1]))
    wt = torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy())  # (Co, Ci, kd,kh,kw)
    yt = F.conv3d(xt, wt, torch.from_numpy(b), stride=stride, dilation=dil)
    np.testing.assert_allclose(ours, _from_torch(yt), atol=ATOL, rtol=1e-4)


def test_conv_transpose_parity():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 4, 5, 6, 8)).astype(np.float32)
    w = (rng.standard_normal((2, 2, 2, 8, 3)) * 0.2).astype(np.float32)

    ours = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), strides=(2, 2, 2), padding="VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")))

    # torch ConvTranspose3d places the UNflipped tap at each offset, while
    # lax (transpose_kernel=False) places the flipped one → flip spatially.
    wt = torch.from_numpy(w[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2).copy())
    yt = F.conv_transpose3d(_to_torch_input(x), wt, stride=2)
    np.testing.assert_allclose(ours, _from_torch(yt), atol=ATOL, rtol=1e-4)


def test_group_norm_parity():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6, 7, 16)).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    beta = rng.standard_normal(16).astype(np.float32)
    groups = 4

    from flax import linen as nn
    gn = nn.GroupNorm(num_groups=groups)
    params = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    ours = np.asarray(gn.apply(params, jnp.asarray(x)))

    yt = F.group_norm(_to_torch_input(x), groups,
                      torch.from_numpy(gamma), torch.from_numpy(beta))
    np.testing.assert_allclose(ours, _from_torch(yt), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_avg_pool_parity(stride):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 8, 4)).astype(np.float32)
    from flax import linen as nn
    ours = np.asarray(nn.avg_pool(jnp.asarray(x), (3, 3, 3),
                                  strides=(stride,) * 3, padding="SAME",
                                  count_include_pad=False))
    xt = _to_torch_input(x)
    # XLA SAME padding is asymmetric under stride 2; torch avg_pool3d can't
    # express that, so build count_include_pad=False semantics manually:
    # sum-pool over the padded input divided by sum-pool over a ones mask.
    pads = [_same_pad(s, stride, 3, 1) for s in x.shape[1:4]]
    pad6 = (pads[2][0], pads[2][1], pads[1][0], pads[1][1], pads[0][0], pads[0][1])
    xp = F.pad(xt, pad6)
    ones = F.pad(torch.ones_like(xt), pad6)
    sums = F.avg_pool3d(xp, 3, stride=stride, divisor_override=1)
    cnts = F.avg_pool3d(ones, 3, stride=stride, divisor_override=1)
    yt = sums / cnts
    np.testing.assert_allclose(ours, _from_torch(yt), atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_max_pool_parity(stride):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 8, 8, 4)).astype(np.float32)
    from flax import linen as nn
    ours = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3, 3),
                                  strides=(stride,) * 3, padding="SAME"))
    xt = _to_torch_input(x)
    pads = [_same_pad(s, stride, 3, 1) for s in x.shape[1:4]]
    xp = F.pad(xt, (pads[2][0], pads[2][1], pads[1][0], pads[1][1],
                    pads[0][0], pads[0][1]), value=float("-inf"))
    yt = F.max_pool3d(xp, 3, stride=stride)
    np.testing.assert_allclose(ours, _from_torch(yt), atol=ATOL, rtol=1e-4)


def test_trilinear_upsample_parity():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 4, 5, 6, 3)).astype(np.float32)
    b, d, h, w, c = x.shape
    ours = np.asarray(jax.image.resize(jnp.asarray(x), (b, 2 * d, 2 * h, 2 * w, c),
                                       method="trilinear"))
    yt = F.interpolate(_to_torch_input(x), scale_factor=2, mode="trilinear",
                       align_corners=False)
    np.testing.assert_allclose(ours, _from_torch(yt), atol=ATOL, rtol=1e-4)


def test_dice_ce_loss_parity():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 6, 6, 6, 3)).astype(np.float32)
    y = (rng.random((2, 6, 6, 6, 3)) > 0.5).astype(np.float32)

    ours = float(dice_ce_loss(jnp.asarray(logits), jnp.asarray(y)))

    lt = torch.from_numpy(logits)
    yt = torch.from_numpy(y)
    p = torch.sigmoid(lt).reshape(2, -1, 3)
    yf = yt.reshape(2, -1, 3)
    inter = (p * yf).sum(1)
    dice = (2 * inter + 1.0) / (p.sum(1) + yf.sum(1) + 1.0)
    bce = F.binary_cross_entropy_with_logits(lt, yt)
    want = float((1 - dice).mean() + bce)
    np.testing.assert_allclose(ours, want, atol=1e-5, rtol=1e-5)


def test_soft_dice_perfect_zero_against_torch_convention():
    y = jnp.ones((1, 4, 4, 4, 3))
    assert float(soft_dice_loss(y, y)) < 1e-6
