"""One rank of the port's data-parallel tests, on the CPU over gloo.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python -m tests.torch_dp_worker OUT_DIR STORE_DIR

Imports torch, numpy and the port, nothing of JAX: each rank is a process
of its own, as torchrun starts them, and joins the group through
`parallel.mesh.maybe_initialize_distributed`.  It runs every scenario of
`STEP_CASES` (the train, warmup and search steps, from the same weights
and global batches as the parent's JAX references) and, with more than one
rank, the loops (`Trainer`, `Searcher`, `predict_dataset`) on STORE_DIR's
patients, and writes its results to OUT_DIR/<case>_rank<r>.npz.  The
parent test (tests/test_torch_parallel.py) builds the same inputs from the
functions below and compares.
"""

from __future__ import annotations

import json
import os
import sys
from unittest import mock

import numpy as np
import torch

from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.models.genotype import alpha_shapes, \
    default_genotype
from nas_3d_unet_tpu_torch.models.unet import DerivedNet, SuperNet
from nas_3d_unet_tpu_torch.parallel import mesh as dp
from nas_3d_unet_tpu_torch.search import bilevel
from nas_3d_unet_tpu_torch.train import checkpoint, loop
from nas_3d_unet_tpu_torch.train.optim import make_optimizer

# the derived net and the supernet: base 4, depth 1, 1 node, at 8^3
D_KW = dict(in_channels=4, num_classes=3, base_channels=4, depth=1,
            n_nodes=1, gn_groups=4)
S_KW = D_KW
EDGE = 8
TRAIN_BATCH, SEARCH_BATCH, STEPS = 4, 2, 2     # global batches
LR, WD = 1e-3, 1e-4
W_LR, W_WD, A_LR, A_WD = 3e-4, 1e-4, 3e-3, 1e-3
XI = 0.5
AUGMENT = dict(flip_prob=0.5, intensity_shift=0.1, intensity_scale=0.1)
LOOP_CFG = {"data.patch_size": (EDGE,) * 3, "data.batch_size": 2,
              "data.val_fraction": 0.34, "model.base_channels": 4,
              "model.depth": 2,
              "model.n_nodes": 1, "model.gn_groups": 4,
              "model.dtype": "float32", "train.lr_patience": 0,
              "search.warmup_epochs": 1, "search.val_steps": 1}


def batch(seed: int, b: int):
    """(x, y) numpy: x ~ N(0, 1) of (b, EDGE^3, 4), y the WT mask
    (x[..., 1] > 0.5) in all three region channels."""
    x = np.random.default_rng(seed).standard_normal(
        (b, EDGE, EDGE, EDGE, 4)).astype(np.float32)
    wt = (x[..., 1] > 0.5).astype(np.float32)
    return x, np.stack([wt, wt, wt], axis=-1)


def flax_params(net: torch.nn.Module, seed: int = 1) -> dict:
    """A flax tree for `net` from `seed`, GroupNorm affines random too."""
    flat = bridge.params_from_flax(bridge.random_flax_params(net, seed))
    rng = np.random.default_rng(seed + 100)
    for key, t in flat.items():
        if key.endswith("norm.scale") or key.endswith("norm.bias"):
            t.copy_(torch.from_numpy((rng.standard_normal(t.shape) * 0.3
                                      + key.endswith("scale"))
                                     .astype(np.float32)))
    return bridge.params_to_flax(flat)


def alphas_np(seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in sorted(alpha_shapes(S_KW["n_nodes"]).items())}


def derived_net(**kw) -> DerivedNet:
    net = DerivedNet(default_genotype(D_KW["n_nodes"]), dtype="float32",
                     **D_KW, **kw)
    bridge.load_flax_params(net, flax_params(net))
    return net


def supernet(pc_k: int = 1, **kw) -> SuperNet:
    net = SuperNet(dtype="float32", pc_k=pc_k, **S_KW, **kw)
    bridge.load_flax_params(net, flax_params(net))
    return net


def rows(mesh, *arrays):
    """This rank's rows of global-batch arrays (its data index's, full D),
    as tensors."""
    out = []
    for a in arrays:
        if mesh is not None:
            n = a.shape[0] // mesh.data_world
            a = a[mesh.data_rank * n:(mesh.data_rank + 1) * n]
        out.append(torch.from_numpy(np.ascontiguousarray(a)))
    return out


def _state(net, alphas=None) -> dict:
    out = {f"params/{k}": v.detach().numpy().copy()
           for k, v in net.state_dict().items()}
    for k, a in (alphas or {}).items():
        out[f"alphas/{k}"] = a.detach().numpy().copy()
    return out


def train_case(mesh, microbatch: int = 0, augment=None) -> dict:
    """STEPS train steps of the derived net on global batches of
    TRAIN_BATCH: the losses and the parameters after them."""
    net = derived_net()
    gen = torch.Generator()
    gen.manual_seed(0)
    step = loop.make_train_step(net, make_optimizer(net.parameters(), LR, WD),
                                augment, microbatch=microbatch, gen=gen,
                                mesh=mesh)
    losses = [step(*rows(mesh, *batch(10 + i, TRAIN_BATCH))).item()
              for i in range(STEPS)]
    return {"loss": np.asarray(losses), **_state(net)}


def search_batches(i: int):
    return (*batch(20 + 2 * i, SEARCH_BATCH), *batch(21 + 2 * i,
                                                     SEARCH_BATCH))


def search_case(mesh, kind: str) -> dict:
    """STEPS steps of `kind` ("warmup", "search", "unrolled" or "pc": the
    first-order step at pc_k 2) on the supernet from the same weights and
    α: the losses, the weights and α after them."""
    net = supernet(2 if kind == "pc" else 1)
    alphas = {k: torch.from_numpy(v).requires_grad_()
              for k, v in alphas_np().items()}
    w_opt = make_optimizer(net.parameters(), W_LR, W_WD)
    a_opt = make_optimizer(alphas.values(), A_LR, A_WD)
    if kind == "warmup":
        step = bilevel.make_warmup_step(net, w_opt, alphas, mesh=mesh)
    elif kind == "unrolled":
        step = bilevel.make_search_step_unrolled(net, w_opt, a_opt, alphas,
                                                 XI, mesh=mesh)
    else:
        step = bilevel.make_search_step(net, w_opt, a_opt, alphas,
                                        mesh=mesh)
    losses = []
    for i in range(STEPS):
        b = rows(mesh, *search_batches(i))
        m = step(*(b[:2] if kind == "warmup" else b))
        losses.append([m["train_loss"].item(), m["val_loss"].item()])
    return {"loss": np.asarray(losses), **_state(net, alphas)}


STEP_CASES = {
    "train": lambda mesh: train_case(mesh),
    "train_micro": lambda mesh: train_case(mesh, microbatch=2),
    "train_aug": lambda mesh: train_case(mesh, augment=AUGMENT),
    "warmup": lambda mesh: search_case(mesh, "warmup"),
    "search": lambda mesh: search_case(mesh, "search"),
    "unrolled": lambda mesh: search_case(mesh, "unrolled"),
    "pc": lambda mesh: search_case(mesh, "pc"),
}


def loop_config(ckpt_dir: str, **extra):
    from nas_3d_unet_tpu_torch.utils.config import load_config

    return load_config(None, {**LOOP_CFG,
                               "train.checkpoint_dir": ckpt_dir,
                               "search.checkpoint_dir": ckpt_dir, **extra})


class _Writes:
    """Counts the files this rank writes through the checkpoint module and
    `Genotype.save`."""

    def __init__(self):
        self.n = 0
        self._ctx = []

    def __enter__(self):
        from nas_3d_unet_tpu_torch.models.genotype import Genotype

        for obj, name in ((checkpoint, "_write_npz"), (Genotype, "save")):
            orig = getattr(obj, name)

            def counted(*a, _orig=orig, **k):
                self.n += 1
                return _orig(*a, **k)

            patch = mock.patch.object(obj, name, counted)
            patch.start()
            self._ctx.append(patch)
        return self

    def __exit__(self, *exc):
        for p in self._ctx:
            p.stop()


def trainer_case(mesh, store: str, out: str, extra=None) -> dict:
    """A 2-epoch Trainer run, and the same run stopped after 1 epoch and
    resumed: both final states, their LR trajectories, the files this
    rank wrote and whether its logger holds a file.  `extra`: config
    overrides."""
    from nas_3d_unet_tpu_torch.data.pipeline import dataset_paths
    from nas_3d_unet_tpu_torch.models.unet import make_derived

    paths = dataset_paths(store, mesh.data_rank, mesh.data_world)
    res = {}
    with _Writes() as writes:
        for run, epochs in (("full", (2,)), ("resumed", (1, 2))):
            ckpt = os.path.join(out, f"trainer_{run}")
            for e in epochs:
                cfg = loop_config(ckpt, **(extra or {}))
                tr = loop.Trainer(make_derived(cfg.model, 3,
                                               default_genotype(1)),
                                  cfg, paths,
                                  log_path=os.path.join(ckpt, "log.jsonl"),
                                  device="cpu", mesh=mesh)
                state = tr.train(epochs=e, steps_per_epoch=2, val_steps=1)
                res[f"logger_file_{run}"] = tr.logger._file is not None
                tr.logger.close()
            res[f"state_{run}"] = state
            res[f"history_{run}"] = tr.history
    res["writes"] = writes.n
    return res


def searcher_case(mesh, store: str, out: str, extra=None) -> dict:
    """As `trainer_case`, for a 1 warmup + 1 bilevel epoch search; with
    the genotypes."""
    from nas_3d_unet_tpu_torch.data.pipeline import dataset_paths
    from nas_3d_unet_tpu_torch.models.unet import make_supernet

    paths = dataset_paths(store, mesh.data_rank, mesh.data_world)
    res = {}
    with _Writes() as writes:
        for run, epochs in (("full", (2,)), ("resumed", (1, 2))):
            ckpt = os.path.join(out, f"searcher_{run}")
            for e in epochs:
                cfg = loop_config(ckpt, **{"model.depth": 1, **(extra or {})})
                s = bilevel.Searcher(make_supernet(cfg.model, 3), cfg, paths,
                                     device="cpu", mesh=mesh)
                state, geno = s.search(epochs=e, steps_per_epoch=2)
                s.logger.close()
            res[f"state_{run}"] = state
            res[f"genotype_{run}"] = geno.to_json()
    res["writes"] = writes.n
    return res


def predict_case(mesh, store: str, out: str) -> list:
    """`predict_dataset` of the fp32 derived net over the store, NIfTI
    labels written to out/predict; every rank's result records."""
    from nas_3d_unet_tpu_torch.infer.predict import predict_dataset
    from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor

    predictor = SlidingWindowPredictor(derived_net(), (EDGE,) * 3, 0.5, 2, 3)
    with torch.no_grad():
        return predict_dataset(predictor, store,
                               os.path.join(out, "predict"), mesh=mesh)


def _save(out: str, name: str, rank: int, arrays: dict) -> None:
    np.savez(os.path.join(out, f"{name}_rank{rank}.npz"), **arrays)


def main(out: str, store: str) -> int:
    torch.set_num_threads(1)
    dp.maybe_initialize_distributed("cpu")
    mesh = dp.make_mesh()
    r = mesh.rank
    for name, fn in STEP_CASES.items():
        _save(out, name, r, fn(mesh))
    if mesh.world > 1:
        loops = {"trainer": trainer_case(mesh, store, out),
                   "searcher": searcher_case(mesh, store, out)}
        for name, res in loops.items():
            for run in ("full", "resumed"):
                _save(out, f"{name}_{run}", r, res.pop(f"state_{run}"))
        loops["predict"] = predict_case(mesh, store, out)
        loops["backend"] = dist_backend()
        with open(os.path.join(out, f"loops_rank{r}.json"), "w") as f:
            json.dump(loops, f)
    dp.destroy()
    return 0


def dist_backend() -> str:
    return str(torch.distributed.get_backend())


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
