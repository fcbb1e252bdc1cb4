"""The port's K1/K2 twins (nas_3d_unet_tpu_torch/ops/pgemm.py) against the
JAX kernels they replace, on CPU.

The JAX side runs the Pallas kernels in interpret mode, as
tests/test_fused_convgn.py does.  Its packed outputs are unpacked and its
packed moments (B, r·C) folded over r to (B, C).  Tolerances are
test_fused_convgn.py's: rtol 1e-5 / atol 1e-5 on y, atol 1e-4 on the
moments (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.ops.packed import (pack, packed_conv_stats,
                                        standard_layout, unpack)
from nas_3d_unet_tpu.ops.pallas.pgemm import gemm_stats as jax_gemm_stats
from nas_3d_unet_tpu_torch.ops import pgemm


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

    pgemm.LAUNCHES.clear()
    yt, s1t, s2t = pgemm.conv3x3x3_stats(torch.from_numpy(x),
                                         torch.from_numpy(k), dilation)
    _close(yt, unpack(y, r), 1e-5)
    _close(s1t, fold(s1), 1e-4)
    _close(s2t, fold(s2), 1e-4)
    assert not pgemm.LAUNCHES          # a CPU tensor never counts a launch


@pytest.mark.parametrize("v", [37, 64])
def test_gemm_stats_twin_matches_pallas(v):
    b, k, n = 2, 12, 7
    rng = np.random.default_rng(v)
    x = rng.standard_normal((b, v, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)

    # rows_pb=16: the ragged tail of v=37 exercises the reference's mask
    y, s1, s2 = jax_gemm_stats(jnp.asarray(x), jnp.asarray(w), rows_pb=16,
                               interpret=True)

    pgemm.LAUNCHES.clear()
    yt, s1t, s2t = pgemm.gemm_stats(torch.from_numpy(x), torch.from_numpy(w))
    _close(yt, y, 1e-5)
    _close(s1t, s1, 1e-4)
    _close(s2t, s2, 1e-4)
    assert not pgemm.LAUNCHES


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
