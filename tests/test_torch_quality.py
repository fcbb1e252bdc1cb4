"""Evidence that the port learns and that its search selects signal: the
parity tests hold single steps against JAX, which a Trainer or a Searcher
that learned nothing would pass.  The JAX package's own quality tests,
at their sizes, budgets and thresholds, on the port, on the CPU:

  * tests/test_learnability.py: the port's `Trainer`, and the port's
    commands `preprocess` → `train` → `predict`, reach held-out
    whole-volume WT Dice ≥ 0.7 (the Trainer also TC ≥ 0.5) on the
    designed-learnable blob task;
  * tests/test_search_quality.py: the same first-order search on the
    shifted-blob task (learnable only through conv candidates) and on its
    noise control, `device_augment` off (a flip reverses the shift), and
    its five assertions: conv mass signal > control + 0.08, `none` mass
    signal < control − 0.02, best α-split WT Dice ≥ 0.55 on the signal and
    ≤ 0.35 on the control, the signal's mean α entropy down by > 0.15,
    ≥ 3 conv-family ops in the signal's genotype; and its registry pins.
    The search starts where the JAX test's does: the weights and α the
    JAX `Searcher.init_state` draws from `PRNGKey(search.seed)`, carried
    over by the bridge.  The bars were calibrated on that one draw: from
    other draws the JAX package's own search misses some of them
    (search.seed 1: the control's Dice bar; 2: the signal's), and so does
    the port's from its own draw at seed 0 (the control's Dice bar).
    From the same draw the port's search lands where the JAX one does.

The tasks' patients come from tests/torch_helpers.py's `.npz` writers,
pinned here against tests/helpers.py's h5 writers array for array.  The
chip-scale twins are `chip_smoke.py` phase "quality".
"""

import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.models.genotype import init_alphas as jax_init_alphas
from nas_3d_unet_tpu.models.unet import SuperNet as JaxSuperNet
from nas_3d_unet_tpu.models.unet import \
    arch_weights_from_alphas as jax_arch_weights
from nas_3d_unet_tpu_torch import bridge, cli
from nas_3d_unet_tpu_torch.data.pipeline import split_patients
from nas_3d_unet_tpu_torch.data.preprocess import load_patient
from nas_3d_unet_tpu_torch.infer.predict import predict_patient
from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor
from nas_3d_unet_tpu_torch.io.nifti import write_nifti
from nas_3d_unet_tpu_torch.models.genotype import default_genotype
from nas_3d_unet_tpu_torch.models.unet import DerivedNet, SuperNet
from nas_3d_unet_tpu_torch.ops.primitives import DOWN_OPS, NORMAL_OPS, UP_OPS
from nas_3d_unet_tpu_torch.search.bilevel import Searcher
from nas_3d_unet_tpu_torch.train.loop import Trainer
from nas_3d_unet_tpu_torch.utils.config import load_config
from tests.helpers import write_learnable_h5, write_shifted_h5
from tests.torch_helpers import write_learnable_npz, write_shifted_npz
from tests.torch_helpers import one_torch_thread  # noqa: F401

DICE_WT_THRESHOLD = 0.7
CONV_FAMILY = {"conv3", "dil_conv3", "sep_conv3",
               "down_conv3", "down_dil_conv3", "down_sep_conv3",
               "up_transpose", "up_conv3", "up_sep_conv3"}
# the α groups drawn from NORMAL_OPS, the only ones holding `none`
NORMAL_GROUPS = ("down_mid", "up_skip", "up_mid")


@pytest.mark.parametrize("kind", ["learnable", "shifted", "shifted_noise"])
def test_npz_writers_store_the_h5_writers_arrays(tmp_path, kind):
    write_h5, write_npz, kw = {
        "learnable": (write_learnable_h5, write_learnable_npz, {}),
        "shifted": (write_shifted_h5, write_shifted_npz, {}),
        "shifted_noise": (write_shifted_h5, write_shifted_npz,
                          {"noise": True})}[kind]
    h5s = write_h5(str(tmp_path / "h5"), **kw)
    npzs = write_npz(str(tmp_path / "npz"), **kw)
    assert len(h5s) == len(npzs) == 4
    for h5p, npzp in zip(h5s, npzs):
        rec = load_patient(npzp)
        with h5py.File(h5p) as f:
            want = {"image": f["image"][()], "label": f["label"][()],
                    **{k: f.attrs[k] for k in ("crop_start", "orig_shape",
                                               "affine")}}
            assert rec["patient"] == f.attrs["patient"]
        for k, v in want.items():
            got = np.asarray(rec[k])
            assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k


def _held_out_dice(net, paths, cfg, patch):
    _, val_paths = split_patients(paths, cfg.data.val_fraction, cfg.data.seed)
    assert val_paths, "split must hold out at least one patient"
    predictor = SlidingWindowPredictor(net, patch, overlap=0.5, batch_size=2,
                                       num_classes=3)
    dices = [predict_patient(predictor, load_patient(p))["dice"]
             for p in val_paths]
    return {k: float(np.mean([d[k] for d in dices]))
            for k in ("WT", "TC", "ET")}, dices


def test_trainer_learns_to_segment(tmp_path):
    paths = write_learnable_npz(str(tmp_path / "npz"), n_patients=4)
    cfg = load_config(None, {
        "data.patch_size": (16, 16, 16), "data.batch_size": 2,
        "data.val_fraction": 0.25, "model.base_channels": 8,
        "model.depth": 2, "model.n_nodes": 2, "model.gn_groups": 4,
        "model.dtype": "float32", "model.remat": False,
        "train.lr": 3e-3, "train.checkpoint_dir": str(tmp_path / "ckpt"),
        "train.seed": 0})
    net = DerivedNet(default_genotype(2), in_channels=4, num_classes=3,
                     base_channels=8, depth=2, n_nodes=2, gn_groups=4,
                     dtype="float32")
    trainer = Trainer(net, cfg, paths, log_path=str(tmp_path / "log.jsonl"),
                      device="cpu")
    trainer.train(epochs=3, steps_per_epoch=40, val_steps=2)
    mean, dices = _held_out_dice(trainer.net, paths, cfg, (16, 16, 16))
    assert mean["WT"] >= DICE_WT_THRESHOLD, (mean, dices)
    # the enhancing core is learnable too (its own t1ce signature)
    assert mean["TC"] >= 0.5, (mean, dices)


def test_cli_learns_to_segment(tmp_path, capsys):
    """preprocess → train (default genotype) → predict on raw NIfTI with
    the learnable signal: `predict_done`'s mean WT Dice over the bar."""
    shape = (28, 28, 28)
    rng = np.random.default_rng(0)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    for i in range(3):
        name = f"BraTS19_learn_{i}"
        pdir = tmp_path / "raw" / ("HGG" if i % 2 == 0 else "LGG") / name
        pdir.mkdir(parents=True)
        c = [int(rng.integers(2 * s // 5, 3 * s // 5)) for s in shape]
        r = min(shape) // 3
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        blob = (d2 < r * r).astype(np.float32)
        core = (d2 < (r - 3) ** 2).astype(np.float32)
        for mod in ("t1", "t1ce", "t2", "flair"):
            v = rng.random(shape).astype(np.float32) * 0.2 + 0.1
            if mod == "t1ce":
                v = v + 1.0 * blob + 0.5 * core
            elif mod == "flair":
                v = v + 0.8 * blob
            write_nifti(str(pdir / f"{name}_{mod}.nii.gz"), v)
        seg = np.zeros(shape, np.uint8)
        seg[blob > 0] = 2
        seg[core > 0] = 4
        write_nifti(str(pdir / f"{name}_seg.nii.gz"), seg)

    cfg = {
        "data": {"raw_dir": str(tmp_path / "raw"),
                 "processed_dir": str(tmp_path / "store"),
                 "patch_size": [16, 16, 16], "batch_size": 2,
                 "val_fraction": 0.34},
        "model": {"base_channels": 8, "depth": 2, "n_nodes": 2,
                  "gn_groups": 4, "dtype": "float32", "remat": False},
        "train": {"epochs": 3, "steps_per_epoch": 40, "lr": 3e-3,
                  "checkpoint_dir": str(tmp_path / "ckpt_train"),
                  "genotype_path": str(tmp_path / "nonexistent.json")},
        "infer": {"patch_size": [16, 16, 16], "overlap": 0.5,
                  "batch_size": 2, "output_dir": str(tmp_path / "pred"),
                  "checkpoint_dir": str(tmp_path / "ckpt_train")},
        "parallel": {"data_parallel": 1, "spatial_parallel": 1},
    }
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    for cmd in ("preprocess", "train", "predict"):
        assert cli.main([cmd, "-c", str(cfg_path), "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    done = [ln for ln in lines if ln.get("event") == "predict_done"]
    assert done and "mean_dice" in done[-1], lines
    assert done[-1]["mean_dice"]["WT"] >= DICE_WT_THRESHOLD, done[-1]


def _softmax(a):
    a = np.asarray(a, np.float64)
    p = np.exp(a - a.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def _none_mass(alphas):
    k = NORMAL_OPS.index("none")
    return float(np.mean(np.concatenate(
        [_softmax(alphas[g])[:, k] for g in NORMAL_GROUPS])))


def _conv_mass(alphas):
    idx = [i for i, o in enumerate(NORMAL_OPS) if o in CONV_FAMILY]
    return float(np.mean(np.concatenate(
        [_softmax(alphas[g])[:, idx].sum(-1) for g in NORMAL_GROUPS])))


@pytest.fixture(scope="module")
def jax_start():
    """The JAX test's starting point: `Searcher.init_state(PRNGKey(0))`'s
    weights (flax's init of its supernet) and α, as numpy."""
    k_init, k_alpha, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    alphas = jax_init_alphas(k_alpha, 2)
    net = JaxSuperNet(in_channels=4, num_classes=3, base_channels=4,
                      depth=2, n_nodes=2, gn_groups=4, remat=False,
                      dtype_name="float32")
    params = jax.jit(net.init)(k_init, jnp.zeros((2, 12, 12, 12, 4)),
                               jax_arch_weights(alphas))
    return (jax.tree_util.tree_map(np.asarray, params),
            {k: np.asarray(v) for k, v in alphas.items()})


def _run_search(paths, ckpt_dir, start):
    """tests/test_search_quality.py `_run_search`'s config and budget:
    12³ patches, batch 2, base 4, depth 2, 2 nodes, fp32, α lr 3e-2 (10×
    the default: over ~60 α steps the gradient's direction is under test),
    1 warmup epoch, 4 epochs of 20 steps; from `start` (weights, α)."""
    cfg = load_config(None, {
        "data.patch_size": (12, 12, 12), "data.batch_size": 2,
        "data.val_fraction": 0.25, "model.base_channels": 4,
        "model.depth": 2, "model.n_nodes": 2, "model.gn_groups": 4,
        "model.dtype": "float32", "model.remat": False,
        "search.alpha_lr": 3e-2,
        "search.warmup_epochs": 1, "search.val_steps": 1,
        "search.checkpoint_dir": ckpt_dir, "search.seed": 0})
    net = SuperNet(in_channels=4, num_classes=3, base_channels=4, depth=2,
                   n_nodes=2, gn_groups=4, dtype="float32")
    log = ckpt_dir + ".log.jsonl"
    searcher = Searcher(net, cfg, paths, log_path=log, device="cpu",
                        device_augment=False)
    init = searcher.init_state

    def init_state(seed):
        init(seed)
        bridge.load_flax_params(searcher.net, start[0])
        with torch.no_grad():
            for k, a in searcher.alphas.items():
                a.copy_(torch.from_numpy(start[1][k]))

    searcher.init_state = init_state
    state, genotype = searcher.search(epochs=4, steps_per_epoch=20)
    with open(log) as f:
        recs = [r for r in map(json.loads, f) if r.get("event") == "epoch"]
    ents = [np.mean([v for k, v in r.items() if k.startswith("entropy_")])
            for r in recs]
    return dict(alphas={k[len("alphas/"):]: v for k, v in state.items()
                        if k.startswith("alphas/")},
                genotype=genotype,
                best_dice=max((r.get("dice_wt", 0.0) for r in recs),
                              default=0.0),
                ent_drop=float(ents[0] - ents[-1]))


def test_search_selects_signal_ops_vs_noise_control(tmp_path, jax_start):
    sig = _run_search(write_shifted_npz(str(tmp_path / "npz_sig")),
                      str(tmp_path / "ck_sig"), jax_start)
    ctl = _run_search(write_shifted_npz(str(tmp_path / "npz_ctl"),
                                        noise=True),
                      str(tmp_path / "ck_ctl"), jax_start)
    report = {name: {"conv_mass": _conv_mass(r["alphas"]),
                     "none_mass": _none_mass(r["alphas"]),
                     "best_dice": r["best_dice"], "ent_drop": r["ent_drop"]}
              for name, r in (("signal", sig), ("control", ctl))}
    # 1) α keeps mass on conv-family candidates only under signal
    assert report["signal"]["conv_mass"] \
        > report["control"]["conv_mass"] + 0.08, report
    # 2) `none` inflates only without signal
    assert report["signal"]["none_mass"] \
        < report["control"]["none_mass"] - 0.02, report
    # 3) the supernet under the searched α solves the signal task only
    assert sig["best_dice"] >= 0.55, report
    assert ctl["best_dice"] <= 0.35, report
    # 4) α moved (entropy falls on noise too: not itself the evidence)
    assert sig["ent_drop"] > 0.15, report
    # 5) conv-family ops beyond the structural floor of 2 (`below` edges)
    g = sig["genotype"]
    ops = [op for node in g.down + g.up for _, op in node]
    assert sum(op in CONV_FAMILY for op in ops) >= 3, (ops, report)


def test_registry_contract_for_contrast_metrics():
    """The registry facts the masses rely on."""
    assert "none" in NORMAL_OPS
    assert all(o in CONV_FAMILY or o in ("none", "identity", "avg_pool3",
                                         "max_pool3") for o in NORMAL_OPS)
    assert all(o in CONV_FAMILY or o.endswith("_pool") for o in DOWN_OPS)
    assert all(o in CONV_FAMILY for o in UP_OPS)
