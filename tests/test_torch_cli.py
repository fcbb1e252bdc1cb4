"""The port's CLI (`python -m nas_3d_unet_tpu_torch`) end to end on the
CPU: preprocess → train → predict with `--device cpu` on raw BraTS-layout
NIfTI patients; without `--device cpu` and without a card a command fails;
`search` writes a genotype that `train` then builds.  Then the port's `predict` against the JAX
CLI's on the same raw data and the same weights, brought over by
`export_flax_params.py`: the stitched probabilities within 1e-5, and the
written labels equal wherever every JAX region probability is more than
1e-4 from the 0.5 threshold (elsewhere fp32 rounding may decide)."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import linen as fnn

import export_flax_params
from nas_3d_unet_tpu import cli as jcli
from nas_3d_unet_tpu.data.preprocess import load_patient_h5
from nas_3d_unet_tpu.infer.sliding import \
    SlidingWindowPredictor as JaxPredictor
from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu.models.unet import make_derived as jax_make_derived
from nas_3d_unet_tpu.train import checkpoint as jckpt
from nas_3d_unet_tpu.train import loop as jloop
from nas_3d_unet_tpu.utils.config import load_config as jax_load_config
from nas_3d_unet_tpu_torch import bridge, cli
from nas_3d_unet_tpu_torch.data.preprocess import load_patient
from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor
from nas_3d_unet_tpu_torch.io.nifti import read_nifti
from nas_3d_unet_tpu_torch.models.genotype import Genotype, default_genotype
from nas_3d_unet_tpu_torch.models.unet import make_derived
from nas_3d_unet_tpu_torch.train import checkpoint as ck
from nas_3d_unet_tpu_torch.utils.config import load_config
from tests.torch_helpers import ROOT, write_raw_patients
from tests.torch_helpers import one_torch_thread  # noqa: F401

N_PATIENTS = 3


def _config(d):
    return {
        "data": {"raw_dir": str(d / "raw"), "processed_dir": str(d / "store"),
                 "patch_size": [8, 8, 8], "batch_size": 2,
                 "val_fraction": 0.34},
        "model": {"base_channels": 4, "depth": 2, "n_nodes": 2,
                  "gn_groups": 4, "dtype": "float32", "packed": False},
        "train": {"epochs": 2, "steps_per_epoch": 2, "microbatch": 1,
                  "checkpoint_dir": str(d / "ckpt"),
                  "genotype_path": str(d / "absent.json")},
        "infer": {"patch_size": [8, 8, 8], "overlap": 0.5, "batch_size": 2,
                  "output_dir": str(d / "pred"),
                  "checkpoint_dir": str(d / "ckpt")},
        "parallel": {"data_parallel": 1, "spatial_parallel": 1},
    }


def _events(stdout):
    return [json.loads(l) for l in stdout.splitlines() if l.startswith("{")]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The three commands, each as `python -m nas_3d_unet_tpu_torch`."""
    d = tmp_path_factory.mktemp("cli")
    write_raw_patients(str(d / "raw"), n=N_PATIENTS, seed=1)
    cfg = d / "config.json"
    cfg.write_text(json.dumps(_config(d)))
    out = {}
    for cmd in (["preprocess"], ["train"],
                ["predict", "-o", "infer.overlap=0.25"]):
        proc = subprocess.run(
            [sys.executable, "-m", "nas_3d_unet_tpu_torch", *cmd,
             "-c", str(cfg), "--device", "cpu"], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[cmd[0]] = _events(proc.stdout)
    return d, cfg, out


def test_preprocess_train_predict_on_the_cpu(run):
    d, _, out = run
    assert out["preprocess"] == [{"event": "preprocess_done",
                                  "patients": N_PATIENTS,
                                  "out_dir": str(d / "store")}]
    names = sorted(os.listdir(d / "store"))
    assert names == [f"BraTS_t_{i}.npz" for i in range(N_PATIENTS)]

    train = out["train"]
    assert train[0]["event"] == "warn" and "default_genotype" in \
        train[0]["msg"]
    epochs = [e for e in train if e["event"] == "epoch"]
    assert [e["epoch"] for e in epochs] == [0, 1]
    assert all(np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"])
               for e in epochs)
    assert train[-1] == {"event": "train_done", "ckpt_dir": str(d / "ckpt")}
    assert {"best.npz", "ckpt_4.npz", "metadata.json",
            "metrics.jsonl"} <= set(os.listdir(d / "ckpt"))

    pred = out["predict"]
    assert [p["patient"] for p in pred[:-1]] == \
        [f"BraTS_t_{i}" for i in range(N_PATIENTS)]
    assert pred[-1]["event"] == "predict_done"
    assert pred[-1]["patients"] == N_PATIENTS
    assert all(np.isfinite(v) for v in pred[-1]["mean_dice"].values())
    for p in pred[:-1]:
        img = read_nifti(p["output"])
        assert img.data.shape == (24, 20, 16)
        assert set(np.unique(img.data)) <= {0, 1, 2, 4}


def test_sequential_predict_equals_the_pipelined_one(run, tmp_path,
                                                    capsys):
    """`predict_dataset(overlap_output=False)`, one patient after the
    other, writes the labels and Dice the pipelined loop does."""
    from nas_3d_unet_tpu_torch.infer.predict import predict_dataset

    d, _, _ = run
    net = make_derived(load_config(str(d / "config.json")).model, 3,
                       default_genotype(2))
    ck.load_params(net, ck.load_checkpoint(str(d / "ckpt" / "best.npz")))
    pred = SlidingWindowPredictor(net, (8, 8, 8), 0.5, 2, 3)
    out = {}
    for overlap in (True, False):
        res = predict_dataset(pred, str(d / "store"),
                              str(tmp_path / str(overlap)),
                              overlap_output=overlap)
        out[overlap] = [(r["patient"], r["dice"],
                         read_nifti(r["output"]).data) for r in res]
    assert len(out[True]) == N_PATIENTS
    for (pa, da, la), (pb, db, lb) in zip(out[True], out[False]):
        assert pa == pb and da == db
        np.testing.assert_array_equal(la, lb)
    lines = capsys.readouterr().out.splitlines()
    assert len([ln for ln in lines if '"patient"' in ln]) == 2 * N_PATIENTS


def test_without_a_card_a_command_fails(run, monkeypatch):
    _, cfg, _ = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("preprocess", "search", "train", "predict"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main([cmd, "-c", str(cfg)])


def test_debug_nans_trains_under_anomaly_detection(run, tmp_path,
                                                  monkeypatch):
    """`--debug-nans` goes through `utils/profiling.py` `debug_nans`: on
    for the command (the NaN check on every op and autograd's anomaly
    mode), off after it."""
    d, cfg, _ = run
    seen = []
    real = cli.debug_nans

    def noted(enable=True):
        seen.append((enable, torch.is_anomaly_enabled()))
        real(enable)

    monkeypatch.setattr(cli, "debug_nans", noted)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["train", "-c", str(cfg), "--device", "cpu",
                         "--debug-nans", "-o", "train.epochs=1",
                         "-o", "train.steps_per_epoch=1",
                         "-o", f"train.checkpoint_dir={tmp_path}"]) == 0
    assert seen == [(True, False), (False, True)]
    assert not torch.is_anomaly_enabled()
    assert (tmp_path / "ckpt_1.npz").exists()


def test_search_is_a_command(run, tmp_path, capsys):
    """`search` on the tiny store: one warmup epoch, one bilevel epoch; it
    writes its metrics, checkpoints and a valid genotype.json, and `train`
    builds that genotype (no fallback warning)."""
    _, cfg, _ = run
    ck_dir = tmp_path / "search"
    assert cli.main(["search", "-c", str(cfg), "--device", "cpu",
                     "-o", "search.epochs=2", "-o", "search.warmup_epochs=1",
                     "-o", "search.steps_per_epoch=2",
                     "-o", "search.val_steps=1",
                     "-o", f"search.checkpoint_dir={ck_dir}"]) == 0
    out = [json.loads(l) for l in capsys.readouterr().out.splitlines()
           if l.startswith("{")]
    assert out[-1] == {"event": "search_done",
                       "genotype": str(ck_dir / "genotype.json")}
    epochs = [e for e in out if e["event"] == "epoch"]
    assert [(e["epoch"], e["warmup"]) for e in epochs] == [(0, True),
                                                           (1, False)]
    assert np.isfinite(epochs[1]["eval_loss"])
    assert {"ckpt_2.npz", "ckpt_4.npz", "genotype.json", "metadata.json",
            "metrics.jsonl"} <= set(os.listdir(ck_dir))
    geno = Genotype.load(str(ck_dir / "genotype.json"))
    geno.validate()
    assert geno.n_nodes == 2
    assert cli.main(["train", "-c", str(cfg), "--device", "cpu",
                     "-o", f"train.genotype_path={ck_dir / 'genotype.json'}",
                     "-o", "train.epochs=1", "-o", "train.steps_per_epoch=1",
                     "-o", f"train.checkpoint_dir={tmp_path / 'train'}"]) == 0
    train = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert not any(e["event"] == "warn" for e in train)
    assert train[-1]["event"] == "train_done"


def _template_init(self, *args, **kwargs):
    """flax's `init` as a template: the tree's paths, shapes and dtypes
    (`eval_shape` traces `init` without running it), zeros for values."""
    shapes = jax.eval_shape(lambda *a: fnn.Module.init(self, *a, **kwargs),
                            *args)
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  shapes)


def test_predict_matches_the_jax_cli(run, tmp_path, monkeypatch):
    d, _, _ = run
    # both commands preprocess on their default (native) path
    monkeypatch.delenv("NAS3D_NO_NATIVE", raising=False)
    # the JAX CLI inits its net only for a checkpoint template, whose
    # values the checkpoint replaces: skip running flax's initialisers
    monkeypatch.setattr(JaxDerivedNet, "init", _template_init)
    raw = _config(d)
    raw["data"]["processed_dir"] = str(tmp_path / "h5")
    raw["infer"].update(checkpoint_dir=str(tmp_path / "jck"),
                        output_dir=str(tmp_path / "jpred"))
    ycfg = tmp_path / "config.yml"
    ycfg.write_text(yaml.safe_dump(raw))
    assert jcli.main(["preprocess", "-c", str(ycfg)]) == 0

    # the JAX package's checkpoint of the weights both sides serve
    jcfg = jax_load_config(str(ycfg))
    jnet = jax_make_derived(jcfg.model, 3, jax_geno(2))
    net = make_derived(load_config(None, {"model.base_channels": 4,
                                          "model.depth": 2,
                                          "model.n_nodes": 2,
                                          "model.gn_groups": 4}).model,
                       3, default_genotype(2), dtype_override="float32")
    params = jax.tree_util.tree_map(jnp.asarray,
                                    bridge.random_flax_params(net, 7))
    tx = jloop.make_optimizer(3e-4, 1e-4)
    jckpt.save_checkpoint(str(tmp_path / "jck"), 4, jloop.TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.asarray(4, jnp.int32), rng=jax.random.PRNGKey(0)),
        best=True)
    assert jcli.main(["predict", "-c", str(ycfg)]) == 0

    os.makedirs(tmp_path / "tck")
    export_flax_params.export(str(tmp_path / "jck" / "best.msgpack"),
                              str(tmp_path / "tck" / "best.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["predict", "-c", str(d / "config.json"),
                         "--device", "cpu",
                         "-o", f"infer.checkpoint_dir={tmp_path / 'tck'}",
                         "-o", f"infer.output_dir={tmp_path / 'tpred'}"]) == 0

    ck.load_params(net, ck.load_checkpoint(str(tmp_path / "tck" /
                                               "best.npz")))
    port = SlidingWindowPredictor(net, (8, 8, 8), 0.5, 2, 3)
    ref = JaxPredictor(jnet.apply, params, (8, 8, 8), 0.5, 2, 3)
    names = sorted(os.listdir(tmp_path / "jpred"))
    assert names == sorted(os.listdir(tmp_path / "tpred")) and \
        len(names) == N_PATIENTS
    for name in names:
        stem = name[:-len(".nii.gz")]
        rec = load_patient(str(d / "store" / f"{stem}.npz"))
        jrec = load_patient_h5(str(tmp_path / "h5" / f"{stem}.h5"))
        np.testing.assert_array_equal(rec["image"], jrec["image"])
        p_port = port.predict_volume(rec["image"])
        p_ref = np.asarray(ref.predict_volume(jrec["image"]))
        np.testing.assert_allclose(p_port, p_ref, atol=1e-5, rtol=0)
        lab_port = read_nifti(str(tmp_path / "tpred" / name)).data
        lab_ref = read_nifti(str(tmp_path / "jpred" / name)).data
        s = rec["crop_start"]
        sl = tuple(slice(a, a + n) for a, n in zip(s, p_ref.shape[:3]))
        sure = (np.abs(p_ref - 0.5) > 1e-4).all(-1)
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(lab_port[sl][sure], lab_ref[sl][sure])
        outside = np.ones(lab_ref.shape, bool)
        outside[sl] = False
        assert not lab_port[outside].any() and not lab_ref[outside].any()
