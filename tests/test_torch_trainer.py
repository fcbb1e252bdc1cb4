"""The port's Trainer (nas_3d_unet_tpu_torch/train/loop.py) on the CPU, at
8³ patches with a base-4, depth-2, 2-node net:

  * resume is trajectory-exact: 2 epochs straight equal 1 epoch, then a
    fresh Trainer resumed for the second, bitwise in every parameter, the
    AdamW state, the generator and the logged epoch record;
  * the plateau state is restored, and a changed stream geometry warns;
  * against the JAX package's Trainer, fp32, both with host augmentation
    (`device_augment=False`, so both consume the same numpy batches) and
    from the same parameters through the bridge: per-epoch train and val
    loss within rtol 1e-4, per-region Dice within 2e-3 (a hard threshold:
    a voxel whose probability sits within rounding of 0.5 may flip), the
    LR trajectory equal as fp32 values (the JAX package keeps its LR in
    fp32), the best-epoch decisions equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import make_derived as jax_make_derived
from nas_3d_unet_tpu.train import loop as jloop
from nas_3d_unet_tpu.utils.config import load_config as jax_load_config
from nas_3d_unet_tpu.utils.params import count_params as jax_count_params
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.models.genotype import default_genotype
from nas_3d_unet_tpu_torch.models.unet import make_derived
from nas_3d_unet_tpu_torch.train import checkpoint as ck
from nas_3d_unet_tpu_torch.train.loop import (Trainer,
                                              warn_stream_geometry_mismatch)
from nas_3d_unet_tpu_torch.utils.config import load_config
from nas_3d_unet_tpu_torch.utils.logging import MetricsLogger
from tests.torch_helpers import write_stores
from tests.torch_helpers import one_torch_thread  # noqa: F401

SMALL = {"data.patch_size": (8, 8, 8), "data.batch_size": 2,
         "data.val_fraction": 0.34, "model.base_channels": 4,
         "model.depth": 2, "model.n_nodes": 2, "model.gn_groups": 4,
         "model.dtype": "float32", "model.packed": False,
         "train.microbatch": 1, "train.seed": 0}
RECORD = ("epoch", "train_loss", "val_loss", "dice_wt", "dice_tc", "dice_et",
          "mean_dice", "lr")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return write_stores(str(tmp_path_factory.mktemp("stores")))


def _trainer(npzs, ckpt_dir, log=None, device_augment=True, **ov):
    cfg = load_config(None, {**SMALL, "train.checkpoint_dir": str(ckpt_dir),
                             **ov})
    net = make_derived(cfg.model, cfg.data.num_classes, default_genotype(2))
    return Trainer(net, cfg, npzs, log_path=log,
                   device_augment=device_augment, device="cpu")


def _epochs(log):
    return [json.loads(l) for l in open(log)
            if json.loads(l)["event"] == "epoch"]


def test_resume_is_trajectory_exact(stores, tmp_path):
    _, npzs = stores
    full = _trainer(npzs, tmp_path / "a", str(tmp_path / "a.jsonl"))
    s_full = full.train(epochs=2, steps_per_epoch=3, val_steps=2)
    _trainer(npzs, tmp_path / "b").train(epochs=1, steps_per_epoch=3,
                                         val_steps=2)
    resumed = _trainer(npzs, tmp_path / "b", str(tmp_path / "b.jsonl"))
    s_res = resumed.train(epochs=2, steps_per_epoch=3, val_steps=2)
    assert int(s_full["step"]) == int(s_res["step"]) == 6
    assert set(s_full) == set(s_res)
    for k in s_full:
        assert s_full[k].tobytes() == s_res[k].tobytes(), k
    want, got = _epochs(tmp_path / "a.jsonl")[1], \
        _epochs(tmp_path / "b.jsonl")[0]
    assert {k: want[k] for k in RECORD} == {k: got[k] for k in RECORD}
    events = [json.loads(l) for l in open(tmp_path / "b.jsonl")]
    assert [e["step"] for e in events if e["event"] == "resume"] == [3]
    assert sorted(os.listdir(tmp_path / "b")) == [
        "best.npz", "ckpt_3.npz", "ckpt_6.npz", "metadata.json"]
    meta = json.load(open(tmp_path / "b" / "metadata.json"))
    assert (meta["step"], meta["epoch"], meta["steps_per_epoch"],
            meta["val_steps"]) == (6, 1, 3, 2)
    assert meta["config"] == resumed.cfg.to_dict() | {
        "data": {**resumed.cfg.to_dict()["data"],
                 "patch_size": [8, 8, 8],
                 "modalities": ["t1", "t1ce", "t2", "flair"]},
        "infer": {**resumed.cfg.to_dict()["infer"],
                  "patch_size": [128, 128, 128]}}


def test_resume_restores_the_plateau(stores, tmp_path):
    _, npzs = stores
    tr = _trainer(npzs, tmp_path)
    tr.init_state(0)
    tr.plateau.best, tr.plateau.bad_epochs = 0.75, 2
    ck.save_checkpoint(str(tmp_path), 1, tr.state(),
                       metadata={"plateau": tr.plateau.state_dict()})
    tr2 = _trainer(npzs, tmp_path)
    tr2.resume_or_init(0)
    assert (tr2.plateau.best, tr2.plateau.bad_epochs, tr2.step) == \
        (0.75, 2, 0)


def test_stream_geometry_mismatch_warns(tmp_path):
    log = str(tmp_path / "w.jsonl")
    logger = MetricsLogger(log, stdout=False)
    warn_stream_geometry_mismatch({"steps_per_epoch": 4}, logger,
                                  steps_per_epoch=4, val_steps=2)
    with pytest.warns(UserWarning, match="NOT trajectory-exact"):
        warn_stream_geometry_mismatch({"steps_per_epoch": 4,
                                       "val_steps": 8}, logger,
                                      steps_per_epoch=4, val_steps=2)
    logger.close()
    events = [json.loads(l) for l in open(log)]
    assert [e["event"] for e in events] == ["warn"]
    assert "val_steps=2" in events[0]["msg"]


LR_PATIENCE = {"train.lr": 2e-2, "train.lr_patience": 0,
               "train.lr_factor": 0.5}


@pytest.fixture(scope="module")
def jax_run(stores, tmp_path_factory):
    """The JAX Trainer, 4 epochs of 2 steps, host augmentation, from the
    parameters the port's Trainer starts from: its epoch records and its
    history."""
    h5s, _ = stores
    d = tmp_path_factory.mktemp("jax_run")
    cfg = jax_load_config(None, {**SMALL, **LR_PATIENCE,
                                 "train.checkpoint_dir": str(d / "ck")})
    net = jax_make_derived(cfg.model, cfg.data.num_classes, jax_geno(2))
    port_net = make_derived(load_config(None, SMALL).model, 3,
                            default_genotype(2))
    params = jax.tree_util.tree_map(
        jnp.asarray, bridge.random_flax_params(port_net, 0))
    tr = jloop.Trainer(net, cfg, h5s, log_path=str(d / "log.jsonl"),
                       device_augment=False)
    tr.init_state = lambda rng: jloop.TrainState(
        params=params, opt_state=tr.tx.init(params),
        step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(0))
    tr.train(epochs=4, steps_per_epoch=2, val_steps=2)
    return _epochs(d / "log.jsonl"), tr.history, jax_count_params(params)


def test_trainer_matches_the_jax_trainer(stores, jax_run, tmp_path):
    want, want_hist, want_params = jax_run
    _, npzs = stores
    tr = _trainer(npzs, tmp_path / "ck", str(tmp_path / "log.jsonl"),
                  device_augment=False, **LR_PATIENCE)
    tr.train(epochs=4, steps_per_epoch=2, val_steps=2)
    got = _epochs(tmp_path / "log.jsonl")
    model = [json.loads(l) for l in open(tmp_path / "log.jsonl")][0]
    assert model == {"event": "model", "params": want_params,
                     "t": model["t"]}
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        for k in ("dice_wt", "dice_tc", "dice_et", "mean_dice"):
            np.testing.assert_allclose(g[k], w[k], atol=2e-3, err_msg=k)
    assert [np.float32(h["lr"]) for h in tr.history] == \
        [np.float32(h["lr"]) for h in want_hist]
    assert [h["is_best"] for h in tr.history] == \
        [h["is_best"] for h in want_hist]
    assert len({h["lr"] for h in want_hist}) > 1       # the LR did move


def test_metrics_logger_mirrors_to_tensorboard(tmp_path, monkeypatch):
    """Numeric fields become `<event>/<field>` scalars at the record's
    step (else its epoch); strings and the bookkeeping fields do not."""
    import sys
    import types

    written = []

    class Writer:
        def __init__(self, logdir):
            written.append(("dir", logdir))

        def add_scalar(self, tag, value, step):
            written.append((tag, value, step))

        def flush(self):
            pass

        def close(self):
            written.append(("closed",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    logger = MetricsLogger(str(tmp_path / "m.jsonl"), stdout=False,
                           tb_dir=str(tmp_path / "tb"))
    logger.log(event="epoch", epoch=2, train_loss=0.5, lr=1e-3, msg="x")
    logger.log(event="resume", step=7, path="p")
    logger.close()
    assert written == [("dir", str(tmp_path / "tb")),
                       ("epoch/train_loss", 0.5, 2), ("epoch/lr", 1e-3, 2),
                       ("closed",)]
    assert [json.loads(l)["event"] for l in open(tmp_path / "m.jsonl")] \
        == ["epoch", "resume"]


def test_metrics_logger_without_tensorboard_warns_once(tmp_path, monkeypatch,
                                                       capsys):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = MetricsLogger(str(tmp_path / "m.jsonl"),
                           tb_dir=str(tmp_path / "tb"))
    logger.log(event="epoch", epoch=0, train_loss=1.0)
    logger.close()
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "tensorboard mirror disabled" in err[0]
    assert not (tmp_path / "tb").exists()
    assert len(open(tmp_path / "m.jsonl").readlines()) == 1
