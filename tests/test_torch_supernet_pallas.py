"""The port's `use_pallas` supernet (`SuperNet(use_pallas=True)`: K6/K7/K4
on the edge ops, K3 for every GroupNorm; on the CPU the kernels' twins)
against the JAX package's `packed=False, use_pallas=True` supernet,
forward only.

The JAX supernet is applied once under `pltpu.force_tpu_interpret_mode()`
(`jax.grad` through it fails in interpret mode under `nn.remat`,
ROADMAP.md queue 3), with the port's weights through the bridge, random
GroupNorm affines and α handed over as numpy.  Base 4, depth 1, 2 nodes,
8³, batch 1: one down and one up cell, so every op set, the mid edges and
the 2·C-wide merged convs, at half the interpreted forward's ~25 s of
depth 2 (which adds only a cell's stride-2 1³ projection: the library
conv, then K3, as in the derived nets of test_torch_model_pallas.py).
rtol/atol 2e-4, as test_torch_model_pallas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from nas_3d_unet_tpu.models.unet import SuperNet as JaxSuperNet
from nas_3d_unet_tpu.models.unet import arch_weights_from_alphas as jax_aw
from nas_3d_unet_tpu_torch.models.unet import (SuperNet,
                                               arch_weights_from_alphas)
from nas_3d_unet_tpu_torch.ops import _cuda
from nas_3d_unet_tpu_torch.ops.primitives import ConvNormAct
from tests.test_torch_supernet import SMALL, _alphas, _params, _x

NET = dict(SMALL, depth=1)


def test_use_pallas_supernet_forward_matches_jax_interpret():
    net = SuperNet(use_pallas=True, **NET)
    params = _params(net, 41)
    al = _alphas(2, 42, scale=1.0)
    x = _x((1, 8, 8, 8, 4), 43)
    jnet = JaxSuperNet(remat=False, packed=False, use_pallas=True,
                       dtype_name="float32", **NET)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(jnet.apply)(
            params, jnp.asarray(x),
            jax_aw({k: jnp.asarray(v) for k, v in al.items()})))
    # the edge ops' 3³ convs take K6; the stem and projections keep K1/K2
    cna = [m for m in net.modules() if isinstance(m, ConvNormAct)]
    assert any(m.k6 for m in cna) and not net.ConvNormAct_0.k6
    _cuda.LAUNCHES.clear()
    with torch.inference_mode():
        got = net(torch.from_numpy(x), arch_weights_from_alphas(
            {k: torch.from_numpy(v) for k, v in al.items()})).numpy()
    assert not _cuda.LAUNCHES                       # CPU: twins only
    assert got.shape == want.shape == (1, 8, 8, 8, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
