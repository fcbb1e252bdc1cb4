"""The port's DerivedNet (nas_3d_unet_tpu_torch/models) against the JAX
DerivedNet: same genotype, same parameters through the bridge, same input.

The JAX side runs lane-packed (the shipped default; on CPU it takes the
unfused conv + GroupNorm path, which tests/test_fused_convgn.py pins equal
to the fused kernel path) and unpacked.  Tolerance rtol 2e-4 / atol 2e-4,
as tests/test_packed_model.py holds packed against unpacked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.models.genotype import (Genotype, default_genotype,
                                                   parse_alphas)
from nas_3d_unet_tpu_torch.models.unet import DerivedNet
from nas_3d_unet_tpu_torch.ops import _cuda, pgemm
from tests.torch_helpers import one_torch_thread  # noqa: F401

SMALL = dict(in_channels=4, num_classes=3, base_channels=4, depth=3,
             n_nodes=3, gn_groups=8)


@pytest.mark.parametrize("packed,merge_ops", [(True, True), (False, True),
                                              (False, False)])
def test_derived_net_matches_jax(packed, merge_ops):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 16, 4)).astype(np.float32)
    net = DerivedNet(default_genotype(3), merge_ops=merge_ops, **SMALL)
    # the port's tree drives the JAX net (init would cost a second compile);
    # GN scale/bias are drawn too, so the affine is exercised
    params = bridge.random_flax_params(net, seed=1)
    for key, t in net.state_dict().items():
        if key.endswith("norm.scale") or key.endswith("norm.bias"):
            node = params["params"]
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = (rng.standard_normal(t.shape) * 0.3
                          + (leaf == "scale")).astype(np.float32)
    bridge.load_flax_params(net, params)

    jnet = JaxDerivedNet(genotype=jax_geno(3), remat=False, packed=packed,
                         merge_ops=merge_ops, dtype_name="float32", **SMALL)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _count_calls(monkeypatch):
    calls = {"conv3x3x3_stats": 0, "gemm_stats": 0}
    for name in calls:
        fn = getattr(pgemm, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(pgemm, name, counted)
    return calls


def test_flagship_forward_runs_each_kernel_path_as_counted(monkeypatch):
    """One flagship forward reaches K1 16 times (1 stem + 2 per down cell +
    3 per up cell) and K2 10 times (2 + 1 + 1 down, 2 per up cell)."""
    net = DerivedNet(default_genotype(3))          # full widths
    calls = _count_calls(monkeypatch)
    with torch.inference_mode():
        net(torch.zeros(1, 16, 16, 16, 4))
    assert calls == {"conv3x3x3_stats": 16, "gemm_stats": 10}
    assert not _cuda.LAUNCHES                       # CPU: twins only


def test_genotype_json_validate_and_parse_match_jax():
    from nas_3d_unet_tpu.models.genotype import Genotype as JaxGenotype
    from nas_3d_unet_tpu.models.genotype import init_alphas
    from nas_3d_unet_tpu.models.genotype import parse_alphas as jax_parse

    g = default_genotype(3)
    assert g.to_json() == jax_geno(3).to_json()
    assert Genotype.from_json(g.to_json()) == g
    for seed in range(3):
        alphas = init_alphas(jax.random.PRNGKey(seed), 3, scale=1.0)
        np_alphas = {k: np.asarray(v) for k, v in alphas.items()}
        want = jax_parse(alphas, 3)
        assert parse_alphas(np_alphas, 3).to_json() == want.to_json()
    bad = Genotype(n_nodes=1, down=((("in0", "conv3"), ("in1", "conv3")),),
                   up=((("below", "up_transpose"), ("skip", "conv3")),))
    with pytest.raises(ValueError):
        bad.validate()
    with pytest.raises(ValueError):
        JaxGenotype(bad.n_nodes, bad.down, bad.up).validate()
