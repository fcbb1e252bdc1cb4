"""The port's checkpoints (nas_3d_unet_tpu_torch/train/checkpoint.py):
bitwise round trips of the training state (parameters, AdamW, step, the
augmentation generator), keep-N pruning, `best`, `metadata.json` and
`latest_checkpoint`; and a JAX checkpoint brought over by
`export_flax_params.py`, whose parameters make the port's forward the JAX
forward (fp32, atol 2e-5 / rtol 1e-4 as in test_torch_parity.py)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import export_flax_params
from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu.train import checkpoint as jckpt
from nas_3d_unet_tpu.train import loop as jloop
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.models.genotype import default_genotype
from nas_3d_unet_tpu_torch.models.unet import DerivedNet
from nas_3d_unet_tpu_torch.train import checkpoint as ck
from nas_3d_unet_tpu_torch.train.loop import make_train_step
from nas_3d_unet_tpu_torch.train.optim import make_optimizer
from tests.torch_helpers import ROOT
from tests.torch_helpers import one_torch_thread  # noqa: F401

SMALL = dict(in_channels=4, num_classes=3, base_channels=4, depth=2,
             n_nodes=2, gn_groups=4)
AUGMENT = dict(flip_prob=0.5, intensity_shift=0.1, intensity_scale=0.1)
ATOL, RTOL = 2e-5, 1e-4


def _trained(seed=0, steps=2):
    """A tiny net, its AdamW and generator after `steps` augmented steps."""
    net = DerivedNet(default_genotype(2), dtype="float32", **SMALL)
    bridge.load_flax_params(net, bridge.random_flax_params(net, seed))
    opt = make_optimizer(net.parameters(), 3e-4, 1e-4)
    gen = torch.Generator()
    gen.manual_seed(seed)
    step = make_train_step(net, opt, augment=AUGMENT, gen=gen)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        x = torch.from_numpy(rng.standard_normal((2, 8, 8, 8, 4))
                             .astype(np.float32))
        step(x, (x[..., :3] > 0.5).float())
    return net, opt, gen


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_round_trip_is_bitwise(tmp_path):
    net, opt, gen = _trained()
    opt.lr = 1.2345e-4
    state = ck.train_state(net, opt, 7, gen)
    assert {k.split("/")[0] for k in state} == {"params", "opt", "step",
                                                "rng"}
    path = ck.save_checkpoint(str(tmp_path), 7, state)
    loaded = ck.load_checkpoint(path)
    _equal(loaded, state)

    net2, opt2, gen2 = _trained(seed=1, steps=1)
    assert ck.restore_train_state(loaded, net2, opt2, gen2) == 7
    _equal(ck.train_state(net2, opt2, 7, gen2), state)
    assert opt2.count == opt.count and opt2.lr == opt.lr
    # the restored generator continues the saved one's draws
    torch.testing.assert_close(torch.rand(5, generator=gen2),
                               torch.rand(5, generator=gen), rtol=0, atol=0)


def test_keep_best_latest_and_metadata(tmp_path):
    net, opt, gen = _trained(steps=0)
    d = str(tmp_path / "ck")
    for step in (3, 6, 9, 12):
        ck.save_checkpoint(d, step, ck.train_state(net, opt, step, gen),
                           keep=2, best=step == 6,
                           metadata={"epoch": step // 3, "mean_dice": 0.5})
    names = sorted(os.listdir(d))
    assert names == ["best.npz", "ckpt_12.npz", "ckpt_9.npz",
                     "metadata.json"]
    assert int(ck.load_checkpoint(os.path.join(d, "best.npz"))["step"]) == 6
    assert ck.latest_checkpoint(d) == (12, os.path.join(d, "ckpt_12.npz"))
    assert json.load(open(os.path.join(d, "metadata.json"))) == {
        "step": 12, "epoch": 4, "mean_dice": 0.5}
    # a torn write of a later step leaves only its .tmp, which is ignored
    (tmp_path / "ck" / "ckpt_15.npz.tmp").write_bytes(b"torn")
    assert ck.latest_checkpoint(d)[0] == 12
    assert ck.latest_checkpoint(str(tmp_path / "none")) is None


def test_load_params_is_strict(tmp_path):
    net, opt, gen = _trained(steps=0)
    state = ck.train_state(net, opt, 0, gen)
    key = next(k for k in state if k.startswith("params/"))
    for bad in ({k: v for k, v in state.items() if k != key},
                {**state, "params/extra.kernel": np.zeros(3, np.float32)},
                {**state, key: np.zeros((1,), np.float32)}):
        with pytest.raises(ValueError, match="does not fit"):
            ck.load_params(net, bad)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint of the JAX package's own `save_checkpoint` (the train
    state the JAX CLI restores) and the JAX net's forward on x."""
    d = tmp_path_factory.mktemp("jck")
    jnet = JaxDerivedNet(genotype=jax_geno(2), remat=False, packed=False,
                         dtype_name="float32", **SMALL)
    x = np.random.default_rng(4).standard_normal((1, 8, 8, 8, 4)) \
        .astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, bridge.random_flax_params(
        DerivedNet(default_genotype(2), **SMALL), 3))
    tx = jloop.make_optimizer(3e-4, 1e-4)
    state = jloop.TrainState(params=params, opt_state=tx.init(params),
                             step=jnp.asarray(5, jnp.int32),
                             rng=jax.random.PRNGKey(0))
    path = jckpt.save_checkpoint(str(d), 5, state, best=True)
    return d, path, x, np.asarray(jax.jit(jnet.apply)(params,
                                                      jnp.asarray(x)))


@pytest.mark.parametrize("name", ["ckpt_5.msgpack", "best.msgpack"])
def test_exported_jax_checkpoint_gives_the_jax_forward(jax_checkpoint,
                                                       tmp_path, name):
    d, _, x, want = jax_checkpoint
    dst = str(tmp_path / "best.npz")
    assert export_flax_params.main([str(d / name), dst]) == 0
    assert os.listdir(tmp_path) == ["best.npz"]
    net = DerivedNet(default_genotype(2), dtype="float32", **SMALL)
    ck.load_params(net, ck.load_checkpoint(dst))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_export_script_runs_as_a_command(jax_checkpoint, tmp_path):
    d, path, _, _ = jax_checkpoint
    dst = tmp_path / "out" / "p.npz"
    out = subprocess.run([sys.executable, str(ROOT / "export_flax_params.py"),
                          path, str(dst)], capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         check=True, timeout=120)
    assert "parameter arrays" in out.stdout
    with np.load(dst) as f:
        assert all(k.startswith("params/") for k in f.files)
