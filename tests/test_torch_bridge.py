"""The flax ⇄ state_dict bridge (nas_3d_unet_tpu_torch/bridge.py): every
flax leaf lands on exactly one parameter of the port's net, with its shape,
and the round trip is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.models.genotype import default_genotype
from nas_3d_unet_tpu_torch.models.unet import DerivedNet
from tests.torch_helpers import one_torch_thread  # noqa: F401


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_round_trip_exact_from_flax_init():
    kw = dict(in_channels=4, num_classes=3, base_channels=4, depth=2,
              n_nodes=2, gn_groups=4)
    # unpacked: the same tree as packed (tests/test_packed_model.py), and
    # a cheaper init on CPU
    jnet = JaxDerivedNet(genotype=jax_geno(2), remat=False, packed=False,
                         dtype_name="float32", **kw)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8, 8, 8, 4)))
    net = DerivedNet(default_genotype(2), **kw)
    bridge.load_flax_params(net, params)            # strict: all consumed
    back = _leaves(bridge.params_to_flax(net.state_dict()))
    want = _leaves(jax.tree_util.tree_map(np.asarray, dict(params)))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_flagship_tree_matches_jax_shapes_and_round_trips():
    jnet = JaxDerivedNet(genotype=jax_geno(3), remat=True, packed=True,
                         dtype_name="float32")
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 16, 16, 16, 4),
                                                 jnp.float32))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    assert len(want) == 149
    assert sum(int(np.prod(s)) for s in want.values()) == 3_534_195

    net = DerivedNet(default_genotype(3))
    tree = bridge.random_flax_params(net, seed=0)
    got = {k: v.shape for k, v in _leaves(tree).items()}
    assert got == want
    bridge.load_flax_params(net, tree)
    back = _leaves(bridge.params_to_flax(net.state_dict()))
    for k, v in _leaves(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_load_refuses_trees_that_do_not_fit():
    net = DerivedNet(default_genotype(2), base_channels=4, depth=2,
                     n_nodes=2, gn_groups=4)
    tree = bridge.random_flax_params(net, seed=0)
    cell = tree["params"]["CheckpointDerivedDownCell_0"]
    del cell["ConvNormAct_0"]["norm"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        bridge.load_flax_params(net, tree)
    cell["ConvNormAct_0"]["norm"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="misshapen"):
        bridge.load_flax_params(net, tree)
    cell["ConvNormAct_0"]["norm"]["bias"] = np.zeros(8, np.float32)
    cell["Extra_0"] = {"kernel": np.zeros(1, np.float32)}
    with pytest.raises(ValueError, match="extra"):
        bridge.load_flax_params(net, tree)
