"""Data parallelism in the port (nas_3d_unet_tpu_torch/parallel/mesh.py and
its users: the train, warmup and search steps, the Trainer, the Searcher,
predict_dataset and the CLI) on the CPU, two ranks over gloo.

One module fixture starts everything at once, then waits:
  * two ranks of tests/torch_dp_worker.py (torch only, one process each,
    as torchrun starts them) and, beside them, a rank of a world of 1;
  * `python -m torch.distributed.run --nproc_per_node 2 -m
    nas_3d_unet_tpu_torch train --device cpu` on a tiny store;
and, while they run, the JAX references in this process: the JAX
package's train step (full batch and microbatch 2), warmup step, first-
order, second-order and `pc_k` 2 search steps, each jitted on the fake
8-device CPU mesh's first two devices (`make_mesh(data_parallel=2)`, the
state replicated, the batch sharded over `data`), from the same weights
(through the bridge), α and global batches (numpy, from seeds).

Held here, at tests/test_parallel.py's tolerance (atol 2e-5, rtol 2e-4,
after 2 steps; the losses at rtol 2e-5):
  * every step of the two ranks against JAX's DP step: the losses, the
    parameters and α.  The `pc_k` 2 step leaves out the weight entries
    whose JAX gradient at the start is zero to rounding (`_rounding_zeros`:
    at most ZERO_REL of the largest: entries of the GroupNorm biases of
    the cell inputs' projections, whose exact gradient is 0, at ~2e-8):
    AdamW turns such fp32 noise into ±lr whatever its size.  Every other
    entry is held;
  * the augmented step of two ranks against the one-process step on the
    global batch with the same generator (no JAX counterpart: JAX draws
    from its own keys);
  * both ranks bit-equal to each other after every step, and a world of
    1 bit-equal to the one-process step (this module, as the workers, runs
    torch on one thread, `one_torch_thread`: a CPU conv's summation order
    depends on the thread count);
  * `dataset_paths` and `local_batch_size` equal to the JAX package's;
  * two-rank `Trainer` and `Searcher` runs: the same LR trajectory,
    parameters, α and genotype on both ranks, files from rank 0 alone,
    and a run stopped after an epoch and resumed equal, bit for bit, to
    the uninterrupted one;
  * two-rank `predict_dataset` (each rank its own patients) gathering
    labels bit-equal to one rank's;
  * the CLI under torchrun at 2 ranks, and the layouts and settings
    `parallel.spatial_parallel` 2 does not run refused with their reason
    (tests/test_torch_spatial.py holds spatial sharding itself).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nas_3d_unet_tpu.data.pipeline import dataset_paths as jax_paths
from nas_3d_unet_tpu.metrics.dice import get_loss_fn as jax_loss_fn
from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu.models.unet import SuperNet as JaxSuperNet
from nas_3d_unet_tpu.models.unet import arch_weights_from_alphas as jax_aw
from nas_3d_unet_tpu.parallel import mesh as jmesh
from nas_3d_unet_tpu.search import bilevel as jbilevel
from nas_3d_unet_tpu.train import loop as jloop
from nas_3d_unet_tpu_torch import bridge, cli
from nas_3d_unet_tpu_torch.data.pipeline import dataset_paths
from nas_3d_unet_tpu_torch.infer.predict import predict_dataset
from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor
from nas_3d_unet_tpu_torch.io.nifti import read_nifti
from nas_3d_unet_tpu_torch.parallel import mesh as dp
from tests import torch_dp_worker as w
from tests.torch_helpers import ROOT, write_stores
from tests.torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs 2 fake devices")

ATOL, RTOL, LOSS_RTOL = 2e-5, 2e-4, 2e-5       # tests/test_parallel.py's
ZERO_REL = 1e-7     # a gradient entry this far below the largest is noise
SHAPES = ((20, 18, 16), (12, 14, 10), (24, 20, 18), (16, 16, 12))
CLI_OVERRIDES = ["data.patch_size=(8,8,8)", "data.batch_size=2",
                 "data.val_fraction=0.34", "model.base_channels=4",
                 "model.depth=2", "model.n_nodes=1", "model.gn_groups=4",
                 "model.dtype=float32", "train.epochs=1",
                 "train.steps_per_epoch=2", "parallel.data_parallel=2"]
TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(world, out, store):
    """`world` worker processes, one per rank, as torchrun starts them."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        log = open(os.path.join(out, f"log{r}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dp_worker", out, store],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _torchrun(store, ckpt, log_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), "-m", "nas_3d_unet_tpu_torch",
           "train", "--device", "cpu",
           "-o", f"data.processed_dir={store}",
           "-o", f"train.checkpoint_dir={ckpt}",
           "-o", f"train.genotype_path={ckpt}/none.json"]
    for ov in CLI_OVERRIDES:
        cmd += ["-o", ov]
    log = open(log_path, "w")
    return subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ,
                                                    OMP_NUM_THREADS="1"),
                            stdout=log, stderr=subprocess.STDOUT), log


def _wait(proc, log, name):
    try:
        rc = proc.wait(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    assert rc == 0, f"{name} exited {rc}:\n" + open(log.name).read()[-4000:]


def _jax_flat(tree) -> dict:
    return {f"params/{k}": v.numpy()
            for k, v in bridge.params_from_flax(tree).items()}


def _jax_train(microbatch):
    """JAX's DP train step, STEPS times: (losses, parameters)."""
    net = JaxDerivedNet(genotype=jax_geno(w.D_KW["n_nodes"]), remat=False,
                        packed=False, dtype_name="float32", **w.D_KW)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    w.flax_params(w.derived_net()))
    tx = jloop.make_optimizer(w.LR, w.WD)
    mesh = jmesh.make_mesh(data_parallel=2)
    state = jmesh.replicate(mesh, jloop.TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(0)))
    step = jloop.make_train_step(net.apply, tx, augment=None,
                                 microbatch=microbatch)
    losses = []
    for i in range(w.STEPS):
        b = jmesh.shard_batch(mesh, tuple(map(jnp.asarray, w.batch(
            10 + i, w.TRAIN_BATCH))))
        state, m = step(state, *b)
        losses.append(float(m["loss"]))
    return {"loss": np.asarray(losses), **_jax_flat(state.params)}


def _jax_search(kind):
    """JAX's DP warmup / search / unrolled / pc step, STEPS times."""
    pc_k = 2 if kind == "pc" else 1
    net = JaxSuperNet(remat=False, packed=False, dtype_name="float32",
                      pc_k=pc_k, **w.S_KW)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    w.flax_params(w.supernet(pc_k)))
    alphas = {k: jnp.asarray(v) for k, v in w.alphas_np().items()}
    w_tx = optax.flatten(optax.adamw(w.W_LR, weight_decay=w.W_WD))
    a_tx = optax.adamw(w.A_LR, weight_decay=w.A_WD)
    mesh = jmesh.make_mesh(data_parallel=2)
    state = jmesh.replicate(mesh, jbilevel.SearchState(
        params=params, w_opt=w_tx.init(params), alphas=alphas,
        a_opt=a_tx.init(alphas), step=jnp.asarray(0, jnp.int32),
        rng=jax.random.PRNGKey(0)))
    if kind == "warmup":
        step = jbilevel.make_warmup_step(net.apply, w_tx)
    elif kind == "unrolled":
        step = jbilevel.make_search_step_unrolled(net.apply, w_tx, a_tx,
                                                  w.XI)
    else:
        step = jbilevel.make_search_step(net.apply, w_tx, a_tx)
    losses = []
    for i in range(w.STEPS):
        b = jmesh.shard_batch(mesh, tuple(map(jnp.asarray,
                                              w.search_batches(i))))
        state, m = step(state, *(b[:2] if kind == "warmup" else b))
        losses.append([float(m["train_loss"]), float(m["val_loss"])])
    return {"loss": np.asarray(losses), **_jax_flat(state.params),
            **{f"alphas/{k}": np.asarray(v)
               for k, v in state.alphas.items()}}


def _rounding_zeros(pc_k: int) -> dict:
    """Per weight entry of the JAX `pc_k` supernet, whether its train-loss
    gradient at the start (the first global train batch) is zero to
    rounding: at most ZERO_REL of the gradient's largest entry."""
    net = JaxSuperNet(remat=False, packed=False, dtype_name="float32",
                      pc_k=pc_k, **w.S_KW)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    w.flax_params(w.supernet(pc_k)))
    aw = jax_aw({k: jnp.asarray(v) for k, v in w.alphas_np().items()})
    x, y = map(jnp.asarray, w.search_batches(0)[:2])
    loss = jax_loss_fn("regions")
    g = _jax_flat(jax.jit(jax.grad(lambda p: loss(net.apply(p, x, aw), y)))(
        params))
    top = max(np.abs(v).max() for v in g.values() if v.size)
    return {k: np.abs(v) <= ZERO_REL * top for k, v in g.items()}


JAX_CASES = {"train": lambda: _jax_train(0),
             "train_micro": lambda: _jax_train(2),
             "warmup": lambda: _jax_search("warmup"),
             "search": lambda: _jax_search("search"),
             "unrolled": lambda: _jax_search("unrolled"),
             "pc": lambda: _jax_search("pc")}


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    _, npzs = write_stores(str(root / "store"), SHAPES)
    store = os.path.dirname(npzs[0])
    out2, out1 = root / "w2", root / "w1"
    out2.mkdir()
    out1.mkdir()
    procs = [(*p, "world 2 rank") for p in _ranks(2, str(out2), store)]
    procs += [(*p, "world 1 rank") for p in _ranks(1, str(out1), store)]
    procs.append((*_torchrun(store, str(root / "cli"),
                             str(root / "torchrun.txt")), "torchrun"))
    try:
        jax_refs = {name: fn() for name, fn in JAX_CASES.items()}
        pc_zeros = _rounding_zeros(2)
    finally:
        for proc, log, name in procs:
            _wait(proc, log, name)
    return {"root": root, "store": store, "jax": jax_refs,
            "pc_zeros": pc_zeros,
            "w2": [{name: _load(out2 / f"{name}_rank{r}.npz")
                    for name in w.STEP_CASES} for r in range(2)],
            "w1": {name: _load(out1 / f"{name}_rank0.npz")
                   for name in w.STEP_CASES},
            "loops": [json.load(open(out2 / f"loops_rank{r}.json"))
                        for r in range(2)],
            "loop_states": [{f"{d}_{run}": _load(
                out2 / f"{d}_{run}_rank{r}.npz")
                for d in ("trainer", "searcher")
                for run in ("full", "resumed")} for r in range(2)]}


def _close(got, want, keys, name, skip=None):
    """`got` against `want` on `keys`; entries `skip` marks True (by key)
    are left out."""
    for k in keys:
        if k == "loss":
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       err_msg=f"{name} {k}")
        else:
            held = ~skip[k] if skip and k in skip else ...
            np.testing.assert_allclose(got[k][held], want[k][held],
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_two_rank_step_matches_jax_dp_step(runs, name):
    got, want = runs["w2"][0][name], runs["jax"][name]
    assert set(got) == set(want)
    skip = runs["pc_zeros"] if name == "pc" else None
    if skip:        # a few bias entries, not a whole weight
        left_out = sum(int(m.sum()) for m in skip.values())
        assert 0 < left_out <= 16, left_out
        assert all(not m.any() for k, m in skip.items()
                   if not k.endswith("norm.bias"))
    _close(got, want, list(want), name, skip)
    if not name.startswith("train"):           # α frozen in warmup alone
        a0 = w.alphas_np()
        moved = [not np.array_equal(got[k], a0[k[7:]]) for k in got
                 if k.startswith("alphas/") and got[k].size]
        assert all(moved) if name != "warmup" else not any(moved)


def test_two_rank_augmented_step_matches_the_global_batch_step(runs):
    got = runs["w2"][0]["train_aug"]
    want = w.STEP_CASES["train_aug"](None)
    _close(got, want, list(want), "train_aug")
    assert not np.array_equal(want["loss"], runs["w2"][0]["train"]["loss"])


@pytest.mark.parametrize("name", list(w.STEP_CASES))
def test_ranks_are_bit_equal(runs, name):
    a, b = (runs["w2"][r][name] for r in range(2))
    assert set(a) == set(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("name", list(w.STEP_CASES))
def test_world_of_one_is_the_one_process_step(runs, name):
    """A 1-rank process group launches no collective and keeps every
    bit."""
    got, want = runs["w1"][name], w.STEP_CASES[name](None)
    assert set(got) == set(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_mesh_helpers_match_the_jax_package(tmp_path, monkeypatch):
    h5s, npzs = write_stores(str(tmp_path), SHAPES)
    store, h5_dir = os.path.dirname(npzs[0]), os.path.dirname(h5s[0])

    def names(paths):
        return [os.path.splitext(os.path.basename(p))[0] for p in paths]

    assert names(dataset_paths(store)) == names(jax_paths(h5_dir))
    for rank, world in ((0, 2), (1, 2), (0, 3), (2, 3), (0, 1)):
        assert names(dataset_paths(store, rank, world)) == \
            names(jax_paths(h5_dir, rank, world))
    for world in (1, 2, 4):
        monkeypatch.setattr(jmesh.jax, "process_count", lambda: world)
        for b in (4, 8):
            assert dp.local_batch_size(b, world=world) == \
                jmesh.local_batch_size(b)
        for what in ("data.batch_size", "search batch size"):
            if world > 1:
                with pytest.raises(ValueError) as want:
                    jmesh.local_batch_size(3, what)
                with pytest.raises(ValueError, match=str(want.value)):
                    dp.local_batch_size(3, what, world=world)
    mesh = dp.make_mesh()
    assert (mesh.rank, mesh.world) == (0, 1) and dp.is_main()
    t = [torch.ones(3)]
    assert mesh.all_reduce_mean_(t)[0] is t[0] and \
        mesh.all_reduce_mean(t)[0] is t[0] and mesh.gather(5) == [5]


@pytest.mark.parametrize("loop", ["trainer", "searcher"])
def test_two_rank_loops_agree_and_resume_exactly(runs, loop):
    d = [runs["loops"][r][loop] for r in range(2)]
    s = [runs["loop_states"][r] for r in range(2)]
    for run in ("full", "resumed"):
        a, b = s[0][f"{loop}_{run}"], s[1][f"{loop}_{run}"]
        assert set(a) == set(b)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    full, res = s[0][f"{loop}_full"], s[0][f"{loop}_resumed"]
    assert set(full) == set(res)
    for k in full:
        assert full[k].tobytes() == res[k].tobytes(), k
    assert d[0]["writes"] > 0 and d[1]["writes"] == 0
    if loop == "trainer":
        assert d[0]["history_full"] == d[1]["history_full"]
        assert d[0]["history_resumed"] == d[0]["history_full"][1:]
        assert len({h["lr"] for h in d[0]["history_full"]}) > 1
        assert d[0]["logger_file_full"] and not d[1]["logger_file_full"]
    else:
        assert d[0]["genotype_full"] == d[1]["genotype_full"] == \
            d[0]["genotype_resumed"]
        ckpt = runs["root"] / "w2" / "searcher_full"
        assert json.loads((ckpt / "genotype.json").read_text()) == \
            json.loads(d[0]["genotype_full"])
    assert runs["loops"][0]["backend"] == "gloo"


def test_two_rank_predict_labels_equal_one_rank(runs):
    predictor = SlidingWindowPredictor(w.derived_net(), (w.EDGE,) * 3, 0.5,
                                       2, 3)
    out = runs["root"] / "predict_one"
    with torch.no_grad():
        want = predict_dataset(predictor, runs["store"], str(out))
    got = runs["loops"][0]["predict"]
    assert got == runs["loops"][1]["predict"]
    assert [r["patient"] for r in got] == [r["patient"] for r in want]
    for g, r in zip(got, want):
        assert g["dice"] == r["dice"]
        a, b = read_nifti(g["output"]).data, read_nifti(r["output"]).data
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_torchrun_trains_two_ranks_from_the_cli(runs):
    out = open(runs["root"] / "torchrun.txt").read()
    done = [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{") and '"train_done"' in ln]
    assert len(done) == 1                       # rank 0 alone prints it
    ckpt = runs["root"] / "cli"
    epochs = [json.loads(ln) for ln in open(ckpt / "metrics.jsonl")
              if '"epoch"' in ln]
    assert [e["epoch"] for e in epochs] == [0]  # rank 0 alone writes
    assert (ckpt / "best.npz").exists() and (ckpt / "ckpt_2.npz").exists()


SPATIAL_REFUSED = [
    # a layout whose data × spatial is not the world (one process here)
    (["parallel.spatial_parallel=2"], "must divide the world size 1"),
    # a patch D that slabs do not split evenly at the model's depth
    (["parallel.spatial_parallel=2", "data.patch_size=(24,24,24)"],
     "multiple of 2·2\\^3"),
    # the second-order search under spatial sharding loads: at one rank
    # only the layout is refused (tests/test_torch_spatial.py runs it)
    (["parallel.spatial_parallel=2", "search.unrolled=True"],
     "must divide the world size 1")]


@pytest.mark.parametrize("ov,match", SPATIAL_REFUSED,
                         ids=["layout", "slab_rule", "unrolled"])
def test_spatial_parallel_is_refused_by_the_cli(tmp_path, ov, match):
    """What the port does not run under `parallel.spatial_parallel` > 1
    is refused with the reason."""
    args = ["train", "--device", "cpu", "-o",
            f"train.checkpoint_dir={tmp_path}"]
    for o in ov:
        args += ["-o", o]
    with pytest.raises(ValueError, match=match):
        cli.main(args)
