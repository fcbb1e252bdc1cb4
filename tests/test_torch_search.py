"""The port's bilevel search (nas_3d_unet_tpu_torch/search/bilevel.py) on
the CPU, at base 4, depth 2, 2 nodes, 8³ patches, fp32:

  * two `make_search_step` steps and one `make_warmup_step` step against
    the JAX package's jitted steps, from the same weights (the bridge)
    and α (numpy), without augmentation: both losses of each step within
    1e-5 (the second step's starts from updated weights), then every
    weight and α leaf at rtol 1e-4 / atol 1e-5 as test_torch_train.py
    (two AdamW steps of lr 3e-4 on gradients that agree to 1e-5); the
    warmup step leaves α exactly as it was on both sides;
  * the α-step computes no weight gradient and the w-step no α gradient;
  * (the `Searcher` tests at depth 1, which holds every α group, since
    they compare batches and the port with itself, not numbers with JAX)
  * the `Searcher`'s three patch streams (w, α and eval) batch for batch
    against the JAX `Searcher`'s on the same patients (the JAX side's
    steps stubbed to record their batches: its streams do not depend on
    them), bitwise;
  * `Searcher(device_augment=False)` against the JAX
    `Searcher(device_augment=False)` at depth 2 from the same weights and
    α: a warmup and a bilevel epoch's losses and eval within 1e-5, the
    final weights and α as the steps' test, the genotype;
  * a resumed search equals an uninterrupted one bit for bit: weights,
    both AdamW states, α, step, the augmentation generator, the genotype;
  * `search.unrolled` and `search.partial_channels` > 1 run in the
    `Searcher` and emit a genotype; `search.unrolled` with
    `model.use_pallas` is refused, naming its ROADMAP.md item.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nas_3d_unet_tpu.models.genotype import init_alphas as jax_init_alphas
from nas_3d_unet_tpu.models.unet import SuperNet as JaxSuperNet
from nas_3d_unet_tpu.search import bilevel as jbilevel
from nas_3d_unet_tpu.utils.config import load_config as jax_load_config
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.models.unet import SuperNet, make_supernet
from nas_3d_unet_tpu_torch.search import bilevel
from nas_3d_unet_tpu_torch.train.optim import make_optimizer
from nas_3d_unet_tpu_torch.utils.config import load_config
from tests.test_torch_supernet import SMALL, _alphas, _params, _x
from tests.torch_helpers import write_stores
from tests.torch_helpers import one_torch_thread  # noqa: F401

W_LR, W_WD, A_LR, A_WD = 3e-4, 1e-4, 3e-4, 1e-3
CFG = {"data.patch_size": (8, 8, 8), "data.batch_size": 2,
       "data.val_fraction": 0.34, "model.base_channels": 4,
       "model.depth": 1, "model.n_nodes": 2, "model.gn_groups": 4,
       "model.dtype": "float32", "model.packed": False,
       "search.warmup_epochs": 1, "search.val_steps": 2, "search.seed": 0}


def _batch(seed):
    x = _x((1, 8, 8, 8, 4), seed)
    return x, np.repeat((x[..., 1:2] > 0.5).astype(np.float32), 3, -1)


def _close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _port(params, al):
    net = SuperNet(**SMALL)
    bridge.load_flax_params(net, params)
    alphas = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in sorted(al.items())}
    w_opt = make_optimizer(net.parameters(), W_LR, W_WD)
    a_opt = make_optimizer(alphas.values(), A_LR, A_WD)
    return net, alphas, w_opt, a_opt


def _jax_state(params, al):
    """JAX's search state (its own buffers: the steps donate them)."""
    params = jax.tree_util.tree_map(jnp.asarray, params)
    w_tx = optax.flatten(optax.adamw(W_LR, weight_decay=W_WD))
    a_tx = optax.adamw(A_LR, weight_decay=A_WD)
    alphas = {k: jnp.asarray(v) for k, v in al.items()}
    state = jbilevel.SearchState(
        params=params, w_opt=w_tx.init(params), alphas=alphas,
        a_opt=a_tx.init(alphas), step=jnp.asarray(0, jnp.int32),
        rng=jax.random.PRNGKey(0))
    return w_tx, a_tx, state


@pytest.fixture(scope="module")
def weights():
    """Flax weights as numpy (the smooth point of test_torch_supernet.py's
    merged case) and α."""
    params = _params(SuperNet(**SMALL), 1)
    return jax.tree_util.tree_map(np.asarray, params), _alphas(2, 2)


def _compare(net, alphas, state):
    got = {n: p.detach().numpy() for n, p in net.named_parameters()}
    want = bridge.params_from_flax(state.params)
    assert set(got) == set(want)
    for k, g in got.items():
        _close(g, want[k].numpy(), msg=k)
    for k, a in alphas.items():
        _close(a.detach().numpy(), state.alphas[k], atol=1e-6, msg=k)


def test_two_search_steps_match_jax(weights):
    params, al = weights
    batches = [(*_batch(10 + 2 * i), *_batch(11 + 2 * i)) for i in range(2)]
    w_tx, a_tx, state = _jax_state(params, al)
    jstep = jbilevel.make_search_step(
        JaxSuperNet(remat=False, packed=False, dtype_name="float32",
                    **SMALL).apply, w_tx, a_tx)
    net, alphas, w_opt, a_opt = _port(params, al)
    step = bilevel.make_search_step(net, w_opt, a_opt, alphas)
    for b in batches:
        state, jm = jstep(state, *map(jnp.asarray, b))
        m = step(*map(torch.from_numpy, b))
        for k in ("train_loss", "val_loss"):
            assert abs(m[k].item() - float(jm[k])) <= 1e-5, k
    assert not all(np.array_equal(alphas[k].detach().numpy(), al[k])
                   for k in al)
    _compare(net, alphas, state)


def test_warmup_step_matches_jax_and_freezes_alpha(weights):
    params, al = weights
    b = _batch(20)
    w_tx, _, state = _jax_state(params, al)
    jstep = jbilevel.make_warmup_step(
        JaxSuperNet(remat=False, packed=False, dtype_name="float32",
                    **SMALL).apply, w_tx)
    state, jm = jstep(state, *map(jnp.asarray, b))
    net, alphas, w_opt, _ = _port(params, al)
    m = bilevel.make_warmup_step(net, w_opt, alphas)(*map(torch.from_numpy,
                                                          b))
    assert abs(m["train_loss"].item() - float(jm["train_loss"])) <= 1e-5
    assert m["val_loss"].item() == 0.0
    for k in al:
        assert np.array_equal(alphas[k].detach().numpy(), al[k])
        assert np.array_equal(np.asarray(state.alphas[k]), al[k])
    _compare(net, alphas, state)


def test_each_half_step_differentiates_only_its_own_parameters(weights):
    """The α-step runs with the weights' `requires_grad` off (no dW is
    computed) and the w-step takes α's softmax without a graph."""
    params, al = weights
    net, alphas, _, _ = _port(params, al)
    seen = []

    class Recorder:
        def __init__(self, ps, name):
            self.params, self.name = list(ps), name

        def step(self, grads):
            seen.append((self.name, [p.requires_grad for p in self.params],
                         [p.grad is None for p in self.params]))

    net.zero_grad(set_to_none=True)
    w_rec, a_rec = Recorder(net.parameters(), "w"), Recorder(
        alphas.values(), "a")
    bilevel.make_search_step(net, w_rec, a_rec, alphas)(
        *map(torch.from_numpy, (*_batch(30), *_batch(31))))
    (a_name, _, w_grads_after_a), (w_name, w_req, _) = seen
    assert (a_name, w_name) == ("a", "w")
    assert all(w_grads_after_a) and all(w_req)     # no dW in the α-step
    assert all(a.grad is None for a in alphas.values())   # none in w-step


def test_augmentation_draws_from_the_callers_generator(weights):
    """With `augment` the steps need the caller's generator (a checkpoint
    carries it); the same seed gives the same step."""
    params, al = weights
    aug = dict(flip_prob=0.5, intensity_shift=0.1, intensity_scale=0.1)
    net, alphas, w_opt, a_opt = _port(params, al)
    with pytest.raises(ValueError, match="generator"):
        bilevel.make_search_step(net, w_opt, a_opt, alphas, aug)
    with pytest.raises(ValueError, match="generator"):
        bilevel.make_warmup_step(net, w_opt, alphas, aug)
    losses = []
    for _ in range(2):
        net, alphas, w_opt, _ = _port(params, al)
        gen = torch.Generator()
        gen.manual_seed(7)
        m = bilevel.make_warmup_step(net, w_opt, alphas, aug, gen=gen)(
            *map(torch.from_numpy, _batch(40)))
        losses.append(m["train_loss"].item())
    assert losses[0] == losses[1]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return write_stores(str(tmp_path_factory.mktemp("search_stores")))


def _searcher(npzs, ckpt, **ov):
    cfg = load_config(None, {**CFG, "search.checkpoint_dir": str(ckpt),
                             **ov})
    return bilevel.Searcher(make_supernet(cfg.model, cfg.data.num_classes),
                            cfg, npzs, device="cpu")


def test_searcher_streams_match_jax_batch_for_batch(stores, tmp_path,
                                                    monkeypatch):
    h5s, npzs = stores
    seen = {"jax": [], "port": []}

    def note(side, kind, *arrays):
        seen[side].append((kind, *(np.asarray(a) for a in arrays)))

    # the JAX Searcher, its steps, eval and checkpoint stubbed
    monkeypatch.setattr(jbilevel, "save_checkpoint", lambda *a, **k: None)
    jcfg = jax_load_config(None, {**CFG, "search.checkpoint_dir":
                                  str(tmp_path / "j")})
    os.makedirs(tmp_path / "j")
    js = jbilevel.Searcher(JaxSuperNet(remat=False, packed=False,
                                       dtype_name="float32",
                                       **{**SMALL, "depth": 1}), jcfg, h5s)
    zero = {"train_loss": jnp.float32(0), "val_loss": jnp.float32(0)}

    def init(rng):
        js._resume_meta = {}
        return jbilevel.SearchState(
            params={"w": jnp.zeros(1)}, w_opt=(),
            alphas=jax_init_alphas(jax.random.PRNGKey(0), 2), a_opt=(),
            step=jnp.asarray(0, jnp.int32), rng=rng)

    js.resume_or_init = init
    js.warmup_step = lambda s, x, y: (note("jax", "w", x, y),
                                      (s.replace(step=s.step + 1), zero))[1]
    js.search_step = lambda s, x, y, xv, yv: (
        note("jax", "wa", x, y, xv, yv), (s.replace(step=s.step + 1),
                                          zero))[1]
    js.eval_step = lambda bundle, x, y: (note("jax", "e", x, y), {
        k: 0.0 for k in ("loss", "dice_wt", "dice_tc", "dice_et")})[1]
    js.search(epochs=2, steps_per_epoch=3)

    ps = _searcher(npzs, tmp_path / "p")
    warm, step, ev = ps.warmup_step, ps.search_step, ps.eval_step
    ps.warmup_step = lambda x, y: (note("port", "w", x, y), warm(x, y))[1]
    ps.search_step = lambda x, y, xv, yv: (note("port", "wa", x, y, xv, yv),
                                           step(x, y, xv, yv))[1]
    ps.eval_step = lambda x, y: (note("port", "e", x, y), ev(x, y))[1]
    ps.search(epochs=2, steps_per_epoch=3)

    kinds = [s[0] for s in seen["port"]]
    assert kinds == ["w"] * 3 + ["wa"] * 3 + ["e"] * 2
    assert [s[0] for s in seen["jax"]] == kinds
    for (_, *a), (_, *b) in zip(seen["port"], seen["jax"]):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and np.array_equal(u, v)


def _epochs(path):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("event") == "epoch"]


def test_searcher_without_device_augment_matches_jax(stores, weights,
                                                     tmp_path):
    """`Searcher(device_augment=False)` against the JAX
    `Searcher(device_augment=False)` from the same weights and α (both
    inits replaced): a warmup epoch and a bilevel epoch of 2 steps, every
    epoch's losses and α-split eval within 1e-5, then the final weights,
    α and genotype.  With the default `device_augment` the port's warmup
    losses differ: the flag is what turns the flips and jitter off."""
    h5s, npzs = stores
    params, al = weights
    ov = {**CFG, "model.depth": 2, "search.val_steps": 1}
    jcfg = jax_load_config(None, {**ov, "search.checkpoint_dir":
                                  str(tmp_path / "j")})
    js = jbilevel.Searcher(JaxSuperNet(remat=False, packed=False,
                                       dtype_name="float32", **SMALL),
                           jcfg, h5s, log_path=str(tmp_path / "j.jsonl"),
                           device_augment=False)

    def jax_init(rng):
        js._resume_meta = {}
        p = jax.tree_util.tree_map(jnp.asarray, params)
        a = {k: jnp.asarray(v) for k, v in al.items()}
        return jbilevel.SearchState(
            params=p, w_opt=js.w_tx.init(p), alphas=a,
            a_opt=js.a_tx.init(a), step=jnp.asarray(0, jnp.int32), rng=rng)

    js.resume_or_init = jax_init
    jstate, jgeno = js.search(epochs=2, steps_per_epoch=2)

    def port(name, **kw):
        cfg = load_config(None, {**ov, "search.checkpoint_dir":
                                 str(tmp_path / name)})
        s = bilevel.Searcher(make_supernet(cfg.model, cfg.data.num_classes),
                             cfg, npzs,
                             log_path=str(tmp_path / f"{name}.jsonl"),
                             device="cpu", **kw)
        init = s.init_state

        def init_state(seed):
            init(seed)
            bridge.load_flax_params(s.net, params)
            with torch.no_grad():
                for k, a in s.alphas.items():
                    a.copy_(torch.from_numpy(al[k]))

        s.init_state = init_state
        _, geno = s.search(epochs=2, steps_per_epoch=2)
        return s, geno

    ps, geno = port("p", device_augment=False)
    got, want = _epochs(tmp_path / "p.jsonl"), _epochs(tmp_path / "j.jsonl")
    assert [r["warmup"] for r in got] == [r["warmup"] for r in want] \
        == [True, False]
    for g, w in zip(got, want):
        for k in ("train_loss", "val_loss", "eval_loss", "dice_wt",
                  "dice_tc", "dice_et"):
            if k in w:
                assert abs(g[k] - w[k]) <= 1e-5, (g["epoch"], k)
    _compare(ps.net, ps.alphas, jstate)
    assert json.loads(geno.to_json()) == json.loads(jgeno.to_json())
    port("aug")
    assert _epochs(tmp_path / "aug.jsonl")[0]["train_loss"] \
        != got[0]["train_loss"]


def test_search_resume_is_trajectory_exact(stores, tmp_path):
    _, npzs = stores
    s_full, g_full = _searcher(npzs, tmp_path / "a").search(
        epochs=2, steps_per_epoch=3)
    _searcher(npzs, tmp_path / "b").search(epochs=1, steps_per_epoch=3)
    resumed = _searcher(npzs, tmp_path / "b")
    s_res, g_res = resumed.search(epochs=2, steps_per_epoch=3)
    assert int(s_full["step"]) == int(s_res["step"]) == 6
    assert set(s_full) == set(s_res)
    assert any(k.startswith("alphas/") for k in s_full)
    assert any(k.startswith("a_opt/") for k in s_full)
    for k in s_full:
        assert s_full[k].tobytes() == s_res[k].tobytes(), k
    assert g_full == g_res
    assert json.loads(open(tmp_path / "b" / "genotype.json").read()) == \
        json.loads(g_full.to_json())
    meta = json.load(open(tmp_path / "b" / "metadata.json"))
    assert (meta["step"], meta["epoch"], meta["steps_per_epoch"],
            meta["val_steps"], meta["warmup_epochs"]) == (6, 1, 3, 2, 1)


@pytest.mark.parametrize("ov", [{"search.unrolled": True},
                                {"search.partial_channels": 2}],
                         ids=["unrolled", "partial_channels"])
def test_ported_search_settings_run_in_the_searcher(stores, tmp_path, ov):
    """The second-order step and PC-DARTS, which the Searcher once
    refused, search a warmup and a bilevel epoch and emit a genotype."""
    _, npzs = stores
    state, geno = _searcher(npzs, tmp_path, **ov).search(epochs=2,
                                                         steps_per_epoch=2)
    assert int(state["step"]) == 4
    geno.validate()
    assert json.loads(open(tmp_path / "genotype.json").read()) == \
        json.loads(geno.to_json())


@pytest.mark.parametrize("ov,item", [({"search.unrolled": True,
                                       "model.use_pallas": True}, "item 14")],
                         ids=["unrolled_use_pallas"])
def test_unported_search_settings_are_refused_by_the_searcher(stores,
                                                             tmp_path, ov,
                                                             item):
    """The second-order step on the `use_pallas` supernet, which the
    Searcher refused until `item`, loads and searches a warmup and a
    bilevel epoch to a genotype."""
    _, npzs = stores
    load_config(None, ov)
    s = _searcher(npzs, tmp_path, **ov)
    assert any(getattr(m, "k6", False) for m in s.net.modules())
    state, geno = s.search(epochs=2, steps_per_epoch=2)
    assert int(state["step"]) == 4
    geno.validate()
