"""Spatial sharding in the port (nas_3d_unet_tpu_torch/parallel/spatial.py,
parallel/mesh.py and their users: the ops, the losses, the train, warmup
and search steps, the Trainer, the Searcher, predict_dataset and the CLI)
on the CPU over gloo.

One module fixture starts everything at once, then waits:
  * two ranks of tests/torch_spatial_worker.py at data 1 × spatial 2, and
    four at data 2 × spatial 2 (torch only, one process each, as torchrun
    starts them);
  * `python -m torch.distributed.run --nproc_per_node 2 -m
    nas_3d_unet_tpu_torch train --device cpu -o
    parallel.spatial_parallel=2`, then `predict` likewise, and `search`
    likewise, on a tiny store;
and, while they run, the JAX references in this process: the JAX
package's train step, 3 steps, on `make_mesh(data_parallel=1 or 2,
spatial_parallel=2)` with the batch's D sharded over `spatial`
(tests/test_parallel.py:136-195), its first-order and `pc_k` 2 search
steps on the (1, 2) mesh and its second-order step on the (1, 2) and (2, 2)
meshes, from the same weights (through the bridge), α and global batches
(numpy, from seeds).

Held here:
  * every candidate op, both `use_pallas` values, on slabs against the
    one-process op: y, dx and the parameters' gradients at atol 2e-5
    (rtol 1e-4, tests/test_torch_parity.py's); the parameter-free ops'
    forwards bit for bit; the max pool's gradient on tied input at 1e-7
    (tests/test_parallel.py:197's);
  * the train steps against JAX's spatially sharded step: the losses at
    rtol 2e-5, the parameters at atol 1e-4 / rtol 2e-4
    (tests/test_parallel.py:173-195's);
  * the search steps against JAX's at tests/test_torch_parallel.py's
    tolerance (atol 2e-5 / rtol 2e-4, the `pc_k` 2 step without the
    entries whose JAX gradient is zero to rounding), the second-order one
    at data 1 × spatial 2 and at 2 × 2, where the spatial sum of the inner
    gradient and its data mean are apart;
  * the second-order α gradient of the supernet and of its `use_pallas`
    twin on slabs against one process at atol 2e-5 / rtol 1e-4, failing
    with the loss sums' identity adjoint kept in the inner graph (a
    planted fault), and on the `use_pallas` net with K3's statistics held
    constant;
  * `gradcheck` and `gradgradcheck` of the halo exchange, its adjoint and
    the differentiable sum across the two ranks;
  * the `use_pallas` net's and a net of pools, dilations and the upsample
    gradients against one process, and remat bit-equal to remat off;
  * every rank of a layout bit-equal to the others;
  * the Trainer and the Searcher: ranks equal, resume exact, files from
    rank 0 alone; `predict_dataset`'s labels and the CLI's NIfTI files
    bit-identical to one process;
  * the second-order step built under spatial sharding, and the refusal
    of a patch D against the slab rule.
"""

import json
import os
import shlex
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nas_3d_unet_tpu.models.genotype import init_alphas, parse_alphas
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu.models.unet import SuperNet as JaxSuperNet
from nas_3d_unet_tpu.parallel import mesh as jmesh
from nas_3d_unet_tpu.search import bilevel as jbilevel
from nas_3d_unet_tpu.train import loop as jloop
from nas_3d_unet_tpu_torch import bridge, cli
from nas_3d_unet_tpu_torch.infer.predict import predict_dataset
from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor
from nas_3d_unet_tpu_torch.io.nifti import read_nifti
from tests import torch_dp_worker as w
from tests import torch_spatial_worker as sw
from tests.test_torch_parallel import (SHAPES, _free_port, _jax_flat,
                                       _load, _rounding_zeros, _wait)
from tests.torch_helpers import ROOT, write_stores
from tests.torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 fake devices")

ATOL, RTOL = 2e-5, 1e-4             # tests/test_torch_parity.py's
STEP_ATOL, STEP_RTOL, LOSS_RTOL = 1e-4, 2e-4, 2e-5  # test_parallel.py:190
SEARCH_ATOL, SEARCH_RTOL = 2e-5, 2e-4   # tests/test_torch_parallel.py's
TIE_ATOL, TIE_RTOL = 1e-7, 1e-6     # tests/test_parallel.py:219
LAYOUTS = {"1x2": 2, "2x2": 4}      # data × spatial: the world
CLI_OVERRIDES = ["data.patch_size=(8,8,8)", "infer.patch_size=(8,8,8)",
                 "data.batch_size=2", "data.val_fraction=0.34",
                 "model.base_channels=4", "model.depth=1",
                 "model.n_nodes=1", "model.gn_groups=4",
                 "model.dtype=float32", "train.epochs=1",
                 "train.steps_per_epoch=2", "search.epochs=2",
                 "search.warmup_epochs=1", "search.steps_per_epoch=2",
                 "search.val_steps=1"]
# the command's search: the second-order step on the use_pallas supernet
SEARCH_OVERRIDES = ["search.unrolled=True", "model.use_pallas=True"]
PARAM_FREE = ("none", "identity", "avg_pool3", "max_pool3", "down_avg_pool",
              "down_max_pool")


def _ranks(world, out, store):
    """`world` worker processes at spatial 2, one per rank."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1", SPATIAL="2")
        log = open(os.path.join(out, f"log{r}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_spatial_worker", out, store],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log,
            f"{world}-rank worker {r}"))
    return procs


def _cli_args(cmd, root, store, spatial=True, extra=()):
    args = [cmd, "--device", "cpu", "-o", f"data.processed_dir={store}",
            "-o", f"train.checkpoint_dir={root}/ckpt",
            "-o", f"infer.checkpoint_dir={root}/ckpt",
            "-o", f"infer.output_dir={root}/pred{'' if spatial else '1'}",
            "-o", f"search.checkpoint_dir={root}/search",
            "-o", f"train.genotype_path={root}/none.json"]
    for ov in CLI_OVERRIDES + list(extra) + (
            ["parallel.spatial_parallel=2"] if spatial else []):
        args += ["-o", ov]
    return args


def _torchrun(args):
    return [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
            "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
            "--master_port", str(_free_port()), "-m",
            "nas_3d_unet_tpu_torch", *args]


def _shell(cmds, log_path, name):
    """The commands one after the other, in one process."""
    log = open(log_path, "w")
    line = " && ".join(shlex.join(c) for c in cmds)
    return (subprocess.Popen(["bash", "-c", line], cwd=ROOT,
                             env=dict(os.environ, OMP_NUM_THREADS="1"),
                             stdout=log, stderr=subprocess.STDOUT), log, name)


def _jax_net():
    """tests/test_parallel.py:29 `tiny_derived`, unpacked."""
    geno = parse_alphas(init_alphas(jax.random.PRNGKey(0), 2), 2)
    return JaxDerivedNet(genotype=geno, remat=False, packed=False,
                         dtype_name="float32", **sw.D_KW), geno


def _ref_params():
    """`tiny_derived`'s weights as tests/test_parallel.py:160 makes them,
    as numpy."""
    net, _ = _jax_net()
    x = jnp.zeros((1, sw.EDGE, sw.EDGE, sw.EDGE, 4), jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(net.init)(jax.random.PRNGKey(1), x))


def _jax_train(data, params):
    """tests/test_parallel.py:136 `_train_equality_vs_single_device`'s
    sharded run on a data × 2 spatial mesh: sw.STEPS steps on one batch."""
    net, _ = _jax_net()
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jloop.make_optimizer(sw.LR, sw.WD)
    mesh = jmesh.make_mesh(data_parallel=data, spatial_parallel=2)
    state = jmesh.replicate(mesh, jloop.TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(2)))
    step = jloop.make_train_step(net.apply, tx, augment=None)
    b = jmesh.shard_batch(mesh, tuple(map(jnp.asarray, sw.batch(
        0, 2 * data))), spatial=True)
    losses = []
    for _ in range(sw.STEPS):
        state, m = step(state, *b)
        losses.append(float(m["loss"]))
    return {"loss": np.asarray(losses), **_jax_flat(state.params)}


def _jax_search(kind, data=1):
    """JAX's first-order, `pc_k` 2 or second-order search step on the
    `data` × 2 spatial mesh, `torch_dp_worker.STEPS` times."""
    pc_k = 2 if kind == "pc" else 1
    net = JaxSuperNet(remat=False, packed=False, dtype_name="float32",
                      pc_k=pc_k, **w.S_KW)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    w.flax_params(w.supernet(pc_k)))
    alphas = {k: jnp.asarray(v) for k, v in w.alphas_np().items()}
    w_tx = optax.flatten(optax.adamw(w.W_LR, weight_decay=w.W_WD))
    a_tx = optax.adamw(w.A_LR, weight_decay=w.A_WD)
    mesh = jmesh.make_mesh(data_parallel=data, spatial_parallel=2)
    state = jmesh.replicate(mesh, jbilevel.SearchState(
        params=params, w_opt=w_tx.init(params), alphas=alphas,
        a_opt=a_tx.init(alphas), step=jnp.asarray(0, jnp.int32),
        rng=jax.random.PRNGKey(0)))
    if kind == "unrolled":
        step = jbilevel.make_search_step_unrolled(net.apply, w_tx, a_tx,
                                                  w.XI)
    else:
        step = jbilevel.make_search_step(net.apply, w_tx, a_tx)
    losses = []
    for i in range(w.STEPS):
        b = jmesh.shard_batch(mesh, tuple(map(jnp.asarray,
                                              w.search_batches(i))),
                              spatial=True)
        state, m = step(state, *b)
        losses.append([float(m["train_loss"]), float(m["val_loss"])])
    return {"loss": np.asarray(losses), **_jax_flat(state.params),
            **{f"alphas/{k}": np.asarray(v)
               for k, v in state.alphas.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    _, npzs = write_stores(str(root / "store"), SHAPES)
    store = os.path.dirname(npzs[0])
    procs = []
    for layout, world in LAYOUTS.items():
        (root / layout).mkdir()
        procs += _ranks(world, str(root / layout), store)
    procs.append(_shell([_torchrun(_cli_args("train", root, store)),
                         _torchrun(_cli_args("predict", root, store))],
                        root / "train_predict.txt", "torchrun train+predict"))
    procs.append(_shell([_torchrun(_cli_args("search", root, store,
                                             extra=SEARCH_OVERRIDES))],
                        root / "search.txt", "torchrun search"))
    try:
        # the workers' train case waits for the weights (written whole)
        params = _ref_params()
        flat = {k: v.numpy()
                for k, v in bridge.params_from_flax(params).items()}
        for layout in LAYOUTS:
            tmp = root / layout / "params_tmp.npz"
            np.savez(tmp, **flat)
            os.replace(tmp, root / layout / sw.REF_PARAMS)
        jax_refs = {"train_1x2": _jax_train(1, params),
                    "train_2x2": _jax_train(2, params),
                    **{k: _jax_search(k) for k in sw.SEARCH_KINDS},
                    sw.UNROLLED_2X2: _jax_search("unrolled", 2)}
        pc_zeros = _rounding_zeros(2)
    finally:
        for proc, log, name in procs:
            _wait(proc, log, name)
    out = {"root": root, "store": store, "jax": jax_refs,
           "pc_zeros": pc_zeros}
    for layout, world in LAYOUTS.items():
        d = root / layout
        names = ["train"] + (["ops", "nets", *sw.SEARCH_KINDS,
                              "second_order",
                              "trainer_full", "trainer_resumed",
                              "searcher_full", "searcher_resumed"]
                             if layout == "1x2" else [sw.UNROLLED_2X2])
        out[layout] = [{n: _load(d / f"{n}_rank{r}.npz") for n in names}
                       for r in range(world)]
        out[f"{layout}_loops"] = [json.load(open(d / f"loops_rank{r}.json"))
                                  for r in range(world)]
    return out


def _ops(runs, key):
    """Each rank's arrays of op case `key`: [(name, got, want)]."""
    return [[(k.split("/")[1], f[k], f[k + "_want"]) for k in sorted(f)
             if k.startswith(key + "/") and not k.endswith("_want")]
            for f in (runs["1x2"][r]["ops"] for r in range(2))]


@pytest.mark.parametrize("name,pallas", sw.OPS,
                         ids=[f"{n}-{'pallas' if p else 'default'}"
                              for n, p in sw.OPS])
def test_op_on_slabs_matches_one_process(runs, name, pallas):
    """y and dx on each rank's slab, and the parameters' gradients summed
    over the group, against the one-process op."""
    for rank_arrays in _ops(runs, f"{name}_{int(pallas)}"):
        assert {k for k, _, _ in rank_arrays} >= {"y", "dx"}
        for k, got, want in rank_arrays:
            if k == "y" and name in PARAM_FREE:     # no sum reassociated
                assert got.tobytes() == want.tobytes(), (name, k)
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{name} {k}")


def test_upsample_on_slabs_is_bit_exact(runs):
    """The trilinear upsample on a slab with a neighbour's plane each side
    (none at a global end): the one-process forward's bits, dx close."""
    for rank_arrays in _ops(runs, "upsample2x"):
        arrays = {k: (got, want) for k, got, want in rank_arrays}
        assert arrays["y"][0].tobytes() == arrays["y"][1].tobytes()
        np.testing.assert_allclose(*arrays["dx"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_tied_max_pool_gradient_matches_one_process(runs, stride):
    for rank_arrays in _ops(runs, f"tied_max_pool_{stride}"):
        ((_, got, want),) = rank_arrays
        assert (want == 0).mean() > 0.1      # the ties are there
        np.testing.assert_allclose(got, want, atol=TIE_ATOL, rtol=TIE_RTOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_train_steps_match_jax_spatial_step(runs, layout):
    assert sw.REF_GENO.to_json() == _jax_net()[1].to_json()
    got, want = runs[layout][0]["train"], runs["jax"][f"train_{layout}"]
    assert set(got) == set(want)
    for k in want:
        if k == "loss":
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_ATOL,
                                       rtol=STEP_RTOL, err_msg=k)


def _search_mismatches(got, want, skip=None):
    """The keys of `want` that `got` misses at the search tolerance (the
    losses at LOSS_RTOL; entries `skip` marks True left out)."""
    assert set(got) == set(want)
    bad = []
    for k in want:
        held = ~skip[k] if skip and k in skip else ...
        ok = (np.allclose(got[k], want[k], rtol=LOSS_RTOL, atol=0)
              if k == "loss" else
              np.allclose(got[k][held], want[k][held], atol=SEARCH_ATOL,
                          rtol=SEARCH_RTOL))
        bad += [] if ok else [k]
    return bad


@pytest.mark.parametrize("kind", [*sw.SEARCH_KINDS, sw.UNROLLED_2X2])
def test_search_step_matches_jax_spatial_step(runs, kind):
    """The first-order, `pc_k` 2 and second-order steps at data 1 ×
    spatial 2, and the second-order one at 2 × 2."""
    layout = "2x2" if kind == sw.UNROLLED_2X2 else "1x2"
    got, want = runs[layout][0][kind], runs["jax"][kind]
    skip = runs["pc_zeros"] if kind == "pc" else {}
    assert not _search_mismatches(got, want, skip), kind
    a0 = w.alphas_np()
    assert all(not np.array_equal(got[k], a0[k[7:]]) for k in got
               if k.startswith("alphas/") and got[k].size)


def _second_order(runs, net):
    """{α leaf or "loss": {tag: array}} of the worker's `second_order`
    case for `net` ("default" or "pallas"), rank 0's."""
    out = {}
    for key, a in runs["1x2"][0]["second_order"].items():
        name, tag = key[len(net) + 1:].rsplit("_", 1)
        if key.startswith(net + "/") and a.size:
            out.setdefault(name, {})[tag] = a
    return out


def _held(leaves, tag):
    return all(np.allclose(v[tag], v["want"], atol=ATOL, rtol=RTOL)
               for k, v in leaves.items() if k != "loss")


@pytest.mark.parametrize("net", ["default", "pallas"])
def test_second_order_gradient_on_slabs_matches_one_process(runs, net):
    """The second-order α gradient and val loss of the supernet and of
    its `use_pallas` twin (K6, K7, K4 and K3 through their twins, every
    backward differentiated on the slab) against one process; with the
    loss sums' identity adjoint kept in the inner graph (a planted fault:
    the cross-slab Hessian terms dropped) they miss, and so they do on the
    `use_pallas` net with K3's statistics held constant."""
    leaves = _second_order(runs, net)
    assert len(leaves) > 2
    for k, v in leaves.items():
        np.testing.assert_allclose(v["got"], v["want"], atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert not _held(leaves, "adjoint")
    if net == "pallas":
        assert not _held(leaves, "k3")


@pytest.mark.parametrize("check", ["halo_zero", "halo_none", "halo_adjoint",
                                   "summed"])
def test_exchanges_are_twice_differentiable_across_ranks(runs, check):
    """`gradcheck` and `gradgradcheck` in float64 on the 2-rank group:
    the halo exchange (zero fill, no fill), its adjoint's Function and
    the differentiable sum."""
    assert all(runs["1x2_loops"][r]["grad_checks"][check] for r in range(2))


@pytest.mark.parametrize("net", ["pallas", "wide"])
def test_net_gradients_on_slabs_match_one_process(runs, net):
    """The `use_pallas` derived net (K6, K7, K4, K3 through their twins)
    and a net of pools, dilated and stride-2 dilated convs and the
    upsample: one full-D batch's loss and gradients."""
    for r in range(2):
        f = runs["1x2"][r]["nets"]
        np.testing.assert_allclose(f[f"{net}/loss_got"],
                                   f[f"{net}/loss_want"], rtol=LOSS_RTOL)
        n = sum(1 for k in f if k.startswith(f"{net}/g") and
                k.endswith("_got"))
        assert n > 20
        for i in range(n):
            np.testing.assert_allclose(f[f"{net}/g{i}_got"],
                                       f[f"{net}/g{i}_want"], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{net} g{i}")


def test_remat_under_spatial_sharding_is_bit_equal_to_off(runs):
    """Remat's recompute runs the halo exchanges and sums again, in the
    same order on both ranks, and changes no bit."""
    for r in range(2):
        f = runs["1x2"][r]["nets"]
        keys = [k for k in f if k.startswith("remat0/")]
        assert keys
        for k in keys:
            assert f[k].tobytes() == f["remat1/" + k[7:]].tobytes(), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_are_bit_equal(runs, layout):
    ranks = runs[layout]
    for name in ranks[0]:
        for other in ranks[1:]:
            if name == "ops" or name == "nets":
                continue        # per slab; their sums are checked above
            a, b = ranks[0][name], other[name]
            assert set(a) == set(b)
            for k in a:
                assert a[k].tobytes() == b[k].tobytes(), (name, k)


@pytest.mark.parametrize("loop", ["trainer", "searcher"])
def test_loops_under_spatial_sharding_agree_and_resume_exactly(runs, loop):
    d = [runs["1x2_loops"][r][loop] for r in range(2)]
    full = runs["1x2"][0][f"{loop}_full"]
    res = runs["1x2"][0][f"{loop}_resumed"]
    assert set(full) == set(res)
    for k in full:
        assert full[k].tobytes() == res[k].tobytes(), k
    assert d[0]["writes"] > 0 and d[1]["writes"] == 0
    if loop == "trainer":
        assert d[0]["history_full"] == d[1]["history_full"]
        assert d[0]["history_resumed"] == d[0]["history_full"][1:]
    else:
        assert d[0]["genotype_full"] == d[1]["genotype_full"] == \
            d[0]["genotype_resumed"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_predict_labels_equal_one_process(runs, layout):
    """Each rank of a spatial group stitches its D-slab; patients go over
    the data axis; the first rank of a group writes."""
    predictor = SlidingWindowPredictor(w.derived_net(), (w.EDGE,) * 3, 0.5,
                                       2, 3)
    with torch.no_grad():
        want = predict_dataset(predictor, runs["store"],
                               str(runs["root"] / "predict_one"))
    loops = runs[f"{layout}_loops"]
    got = loops[0]["predict"]
    assert all(r["predict"] == got for r in loops[1:])
    assert [r["patient"] for r in got] == [r["patient"] for r in want]
    for g, r in zip(got, want):
        assert g["dice"] == r["dice"]
        a, b = read_nifti(g["output"]).data, read_nifti(r["output"]).data
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_torchrun_runs_train_predict_and_search_spatially(runs):
    """The commands under torchrun at spatial 2 (`search` with the
    second-order step on the `use_pallas` supernet): rank 0 alone prints
    and writes, and `predict`'s NIfTI files are one process's bits."""
    root, store = runs["root"], runs["store"]
    for log, event in (("train_predict.txt", "train_done"),
                       ("train_predict.txt", "predict_done"),
                       ("search.txt", "search_done")):
        done = [json.loads(ln) for ln in open(root / log)
                if ln.startswith("{") and f'"{event}"' in ln]
        assert len(done) == 1 and done[0]["world"] == 2, (event, done)
    assert (root / "search" / "genotype.json").exists()
    assert cli.main(_cli_args("predict", root, store, spatial=False)) == 0
    names = sorted(os.listdir(root / "pred1"))
    assert names and names == sorted(os.listdir(root / "pred"))
    for n in names:
        a = read_nifti(str(root / "pred" / n)).data
        b = read_nifti(str(root / "pred1" / n)).data
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), n


def test_refusals_under_spatial_sharding(runs):
    """The second-order step, once refused here, is built and runs a
    step; a patch D against the slab rule is still refused."""
    ref = runs["1x2_loops"][0]["refusals"]
    assert np.isfinite(ref["unrolled"])
    assert "patch D 8" in ref["slab_rule"] and "2·2^2" in ref["slab_rule"]
