"""The port's second-order DARTS step (nas_3d_unet_tpu_torch/search/
bilevel.py `unrolled_alpha_grads`, `make_search_step_unrolled`) and the
twice-differentiable backwards it runs through, on the CPU.

  * The α gradient and the loss of L_val(w − ξ·∇_w L_train(w, α), α)
    against `jax.value_and_grad` of the JAX step's
    `val_after_virtual_step` (`search/bilevel.py:128-132`) on the plain
    supernet (`packed=False`; base 4, depth 1, 2 nodes, 8³, fp32, merged
    ops, full and partial channels), weights through the bridge and α as
    numpy, at ATOL 2e-5 / RTOL 1e-4.  ξ is 0.5, large enough that the
    Hessian term moves the gradient well past the tolerance: it differs
    from the first-order one (the reference's
    `test_second_order_step_runs_and_differs`), and K1-dx's second-order
    path alone moves it by 1e-4 (the sound port sits within 5e-8).  The
    point is checked smooth first (a 1e-6 relative change of x moves the port's α
    gradients by less than 1e-4), as test_torch_supernet.py does.  The
    kernels' wrappers (`pgemm._k1`, `_k2`, `stats._moments`,
    `_weighted_sums`) run on detached inputs there and in the checks
    below, so autograd sees them no more than it sees a launch on the
    card: only the Functions' backwards carry the second derivative.
  * The control: with GroupNorm's mean and inv held constant in its
    differentiable backward (the second-order path through them cut), the
    same comparison fails.
  * Second derivatives op by op: `torch.autograd.gradgradcheck` in float64
    of K1 (`_ConvStats`, dilation 1 and 2), K1-dx (`_Conv3x3x3`), K2
    (`_GemmStats`), the GroupNorm (from K1's moments and from K5a's, with
    and without its ReLU) and the K5 Functions (K5a, K5b, masked K5b);
    the pools and the trilinear upsample against JAX's reverse-over-
    reverse (a Hessian-vector product) in fp32.
  * The first-order step enters none of the second-order code, and the
    first-order GroupNorm backward keeps its formula's bits.
  * `search.unrolled` with `search.partial_channels: 2`: a `Searcher`
    search and its resume, trajectory-exact, and the `search` command,
    each emitting a valid genotype; `search.xi` 0 means ξ = `search.w_lr`.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.metrics.dice import get_loss_fn as jax_loss_fn
from nas_3d_unet_tpu.models.unet import SuperNet as JaxSuperNet
from nas_3d_unet_tpu.models.unet import arch_weights_from_alphas as jax_aw
from nas_3d_unet_tpu.ops import primitives as jp
from nas_3d_unet_tpu_torch import cli
from nas_3d_unet_tpu_torch.metrics.losses import get_loss_fn
from nas_3d_unet_tpu_torch.models.genotype import Genotype
from nas_3d_unet_tpu_torch.models.unet import (SuperNet,
                                               arch_weights_from_alphas)
from nas_3d_unet_tpu_torch.ops import groupnorm, pgemm, pool, stats
from nas_3d_unet_tpu_torch.search import bilevel
from nas_3d_unet_tpu_torch.train.optim import make_optimizer
from tests.test_torch_search import _searcher, stores  # noqa: F401
from tests.test_torch_supernet import _alphas, _params, _x
from tests.torch_helpers import write_stores
from tests.torch_helpers import one_torch_thread  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
XI = 0.5
KW = dict(in_channels=4, num_classes=3, base_channels=4, depth=1,
          n_nodes=2, gn_groups=4)
EDGE = 8


def _batch(seed):
    x = _x((1, EDGE, EDGE, EDGE, 4), seed)
    return x, np.repeat((x[..., 1:2] > 0.5).astype(np.float32), 3, -1)


@contextlib.contextmanager
def opaque_kernels():
    """Every kernel wrapper runs on detached inputs, without a graph: on
    the CPU its twin is then as invisible to autograd as a launch is on
    the card."""
    def opaque(fn):
        def run(*args):
            with torch.no_grad():
                return fn(*(a.detach() if isinstance(a, torch.Tensor)
                            else a for a in args))
        return run

    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((pgemm, "_k1"), (pgemm, "_k2"),
                          (stats, "_moments"), (stats, "_weighted_sums")):
            mp.setattr(mod, name, opaque(getattr(mod, name)))
        yield


def _port_unrolled(net, al, batches, x_scale=1.0):
    """(val loss, α gradients by group) of the port's unrolled α-step."""
    at = {k: torch.from_numpy(v).requires_grad_() for k, v in
          sorted(al.items())}
    x_tr, y_tr, x_val, y_val = map(torch.from_numpy, batches)
    with opaque_kernels():
        loss, grads = bilevel.unrolled_alpha_grads(
            net, at, list(at.values()), XI, x_tr * x_scale, y_tr,
            x_val * x_scale, y_val, get_loss_fn("regions"))
    return loss.item(), {k: g.numpy() for k, g in zip(at, grads)}


@pytest.fixture(scope="module", params=[1, 2], ids=["full", "pc2"])
def unrolled_pair(request):
    """(port supernet, α, batches, JAX val loss, JAX α gradients): one
    `jax.value_and_grad` of the JAX step's `val_after_virtual_step`
    through the plain JAX supernet, weights from seed 1."""
    pc_k = request.param
    net = SuperNet(pc_k=pc_k, **KW)
    params = _params(net, 1)
    al = _alphas(2, 2)
    batches = (*_batch(3), *_batch(4))
    jnet = JaxSuperNet(remat=False, packed=False, pc_k=pc_k,
                       dtype_name="float32", **KW)
    loss = jax_loss_fn("regions")
    x_tr, y_tr, x_val, y_val = map(jnp.asarray, batches)

    def loss_fn(p, a, x, y):
        return loss(jnet.apply(p, x, jax_aw(a)), y)

    def val_after_virtual_step(alphas, p):      # bilevel.py:128-132
        g_w = jax.grad(loss_fn, argnums=0)(p, alphas, x_tr, y_tr)
        w_virt = jax.tree_util.tree_map(lambda q, g: q - XI * g, p, g_w)
        return loss_fn(w_virt, alphas, x_val, y_val)

    jl, jg = jax.jit(jax.value_and_grad(val_after_virtual_step))(
        {k: jnp.asarray(v) for k, v in al.items()}, params)
    return net, al, batches, float(jl), {k: np.asarray(v)
                                         for k, v in jg.items()}


def _mismatches(got, want):
    return [k for k in want if not np.allclose(got[k], want[k], rtol=RTOL,
                                               atol=ATOL)]


def test_unrolled_alpha_gradient_matches_jax(unrolled_pair):
    net, al, batches, jl, jg = unrolled_pair
    loss, grads = _port_unrolled(net, al, batches)
    # a smooth point: no mask or maximum decided by fp32 rounding
    _, moved = _port_unrolled(net, al, batches, np.float32(1 + 1e-6))
    assert max(np.abs(moved[k] - g).max() / np.abs(g).max()
               for k, g in grads.items()) < 1e-4
    assert abs(loss - jl) <= ATOL + RTOL * abs(jl)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jg[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the Hessian term matters at this ξ: the first-order gradient is off
    at = {k: torch.from_numpy(v).requires_grad_() for k, v in al.items()}
    x_val, y_val = map(torch.from_numpy, batches[2:])
    first = torch.autograd.grad(
        get_loss_fn("regions")(net(x_val, arch_weights_from_alphas(at)),
                               y_val), list(at.values()))
    assert _mismatches({k: g.numpy() for k, g in zip(at, first)}, jg)


def test_the_parity_fails_with_groupnorm_statistics_held_constant(
        unrolled_pair, monkeypatch):
    net, al, batches, _, jg = unrolled_pair
    cut = groupnorm._grad_statistics
    monkeypatch.setattr(groupnorm, "_grad_statistics",
                        lambda *a: tuple(t.detach() for t in cut(*a)))
    _, grads = _port_unrolled(net, al, batches)
    assert _mismatches(grads, jg)


def _gradgradcheck(fn, inputs):
    """`gradgradcheck` under `opaque_kernels`, after checking that every
    first derivative is itself part of a graph: gradgradcheck passes over
    a derivative autograd cannot see.  One thread: thousands of tiny ops,
    which threads only slow down beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with opaque_kernels():
            out = fn(*inputs)
            outs = out if isinstance(out, tuple) else (out,)
            grads = torch.autograd.grad(
                outs, inputs, [torch.ones_like(o, requires_grad=True)
                               for o in outs], create_graph=True)
            assert all(g.requires_grad for g in grads)
            return torch.autograd.gradgradcheck(fn, inputs)
    finally:
        torch.set_num_threads(threads)


def _f64(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape)).requires_grad_()


@pytest.mark.parametrize("dilation", [1, 2])
def test_k1_and_k1dx_are_twice_differentiable(dilation):
    x, w = _f64(1, 3, 3, 4, 1, seed=1), _f64(3, 3, 3, 1, 2, seed=2)
    dy = _f64(1, 3, 3, 4, 2, seed=3)
    wt = _f64(3, 3, 3, 2, 1, seed=4)
    assert _gradgradcheck(
        lambda a, b: pgemm.conv3x3x3_stats(a, b, dilation)[0], (x, w))
    assert _gradgradcheck(lambda a, b: pgemm.conv3x3x3(a, b, dilation),
                          (dy, wt))


def test_k2_is_twice_differentiable():
    x3, w = _f64(2, 7, 3, seed=5), _f64(3, 4, seed=6)
    assert _gradgradcheck(lambda a, b: pgemm.gemm_stats(a, b)[0], (x3, w))


@pytest.mark.parametrize("relu", [False, True], ids=["affine", "relu"])
@pytest.mark.parametrize("producer", ["k1", "k5a"])
def test_groupnorm_is_twice_differentiable(producer, relu):
    x = _f64(2, 2, 3, 2, 2, seed=7)
    w = _f64(3, 3, 3, 2, 4, seed=8).detach()     # x's gradient is the point
    scale = torch.from_numpy(1 + 0.3 * np.random.default_rng(9)
                             .standard_normal(4)).requires_grad_()
    bias = _f64(4, seed=10)

    def k1_gn(a, g, s):
        y, s1, s2 = pgemm.conv3x3x3_stats(a, w)
        return groupnorm.group_norm_from_moments(y, s1, s2, g, s, 2, relu)

    def k5a_gn(a, g, s):
        return groupnorm.group_norm(pgemm.conv3x3x3(a, w), g, s, 2, relu)

    fn = k1_gn if producer == "k1" else k5a_gn
    assert _gradgradcheck(fn, (x, scale, bias))


@pytest.mark.parametrize("masked", [False, True])
def test_k5_functions_are_twice_differentiable(masked):
    x, g = _f64(2, 3, 2, 4, 3, seed=11), _f64(2, 3, 2, 4, 3, seed=12)
    y = torch.from_numpy(np.random.default_rng(13).standard_normal(
        x.shape)) if masked else None
    assert _gradgradcheck(stats.moments, (x,))
    assert _gradgradcheck(lambda a, b: stats.weighted_sums(a, b, y), (g, x))


POOLS = {"max_pool3": (lambda x: pool.max_pool3(x, 1), "max_pool3"),
         "down_max_pool": (lambda x: pool.max_pool3(x, 2), "down_max_pool"),
         "avg_pool3": (lambda x: pool.avg_pool3(x, 1), "avg_pool3"),
         "down_avg_pool": (lambda x: pool.avg_pool3(x, 2), "down_avg_pool"),
         "upsample2x": (pool.upsample2x, None)}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pools_hessian_vector_products_match_jax(name):
    """H·v of ½ Σ c·op(x)² against `jax.grad` of ⟨∇L, v⟩ (tie-free x)."""
    port_op, jname = POOLS[name]
    shape = (1, 5, 6, 7, 3)
    x, v = _x(shape, 20), _x(shape, 21)
    if jname is None:
        jop = lambda t: jax.image.resize(
            t, (1, 10, 12, 14, 3), "trilinear")
    else:
        jmod = jp.make_op(jname, 3, "group", 1, jnp.float32)
        jop = lambda t: jmod.apply({}, t)
    c = _x(tuple(jax.eval_shape(jop, jnp.asarray(x)).shape), 22)

    def loss(t):
        return 0.5 * jnp.sum(jnp.asarray(c) * jop(t) ** 2)

    want = jax.jit(jax.grad(lambda t: jnp.vdot(jax.grad(loss)(t),
                                               jnp.asarray(v))))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(
        0.5 * (torch.from_numpy(c) * port_op(xt) ** 2).sum(), xt,
        create_graph=True)
    (hv,) = torch.autograd.grad((g * torch.from_numpy(v)).sum(), xt)
    np.testing.assert_allclose(hv.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)


def test_first_order_step_runs_no_second_order_code(monkeypatch):
    """The first-order search step's backwards record no graph, so none of
    the second-order code runs, and the GroupNorm backward returns the
    bits of its first-order formula."""
    def refuse(*_a, **_k):
        raise AssertionError("second-order code on the first-order path")

    for mod, name in ((groupnorm, "_differentiable_backward"),
                      (stats._Moments, "forward"),
                      (stats._WeightedSums, "forward"),
                      (pgemm._Conv3x3x3, "forward")):
        monkeypatch.setattr(mod, name, refuse)
    net = SuperNet(**KW)
    _params(net, 1)
    al = {k: torch.from_numpy(v).requires_grad_()
          for k, v in sorted(_alphas(2, 2).items())}
    step = bilevel.make_search_step(
        net, make_optimizer(net.parameters(), 3e-4, 1e-4),
        make_optimizer(al.values(), 3e-4, 1e-3), al)
    m = step(*map(torch.from_numpy, (*_batch(5), *_batch(6))))
    assert np.isfinite(m["train_loss"].item() + m["val_loss"].item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_order_groupnorm_backward_keeps_its_bits(dtype):
    """The first-order backward against its formula, written out: dy
    masked by the forward's ReLU, K5b's sums, one fp32 pass rounded once."""
    x = torch.from_numpy(_x((2, 3, 4, 5, 8), 30)).to(dtype).requires_grad_()
    scale = torch.from_numpy(1 + 0.3 * _x((8,), 31)).requires_grad_()
    bias = torch.from_numpy(_x((8,), 32)).requires_grad_()
    dy = torch.from_numpy(_x((2, 3, 4, 5, 8), 33)).to(dtype)
    s1, s2 = stats.moments_twin(x.detach())
    y = groupnorm.group_norm_from_moments(x, s1, s2, scale, bias, 4, True)
    got = torch.autograd.grad(y, (x, scale, bias), dy)
    xd, gsize, n = x.detach(), 2, 3 * 4 * 5 * 2
    mean, inv = groupnorm._fold(s1, s2, 4, n, groupnorm.EPS)
    a0, b0 = groupnorm._affine(xd, mean, inv, scale.detach(), bias.detach(),
                               gsize)
    dym = torch.where(groupnorm._normalize(xd, a0, b0) > 0, dy, 0)
    r1, r2 = stats.weighted_sums_twin(dym, xd)
    sc = scale.detach()
    t1 = (sc * r1).view(2, -1, gsize).sum(-1)
    t2 = (sc * r2).view(2, -1, gsize).sum(-1)
    c2 = -(inv * inv) * (inv * (t2 - mean * t1)) / n
    c1 = -inv * t1 / n - c2 * mean
    shape = (2, 1, 1, 1, 8)
    inv_c, mean_c = (groupnorm._by_channel(t, gsize) for t in (inv, mean))
    dx = dym * (inv_c * sc).view(shape)
    dx.addcmul_(xd, groupnorm._by_channel(c2, gsize).view(shape))
    dx += groupnorm._by_channel(c1, gsize).view(shape)
    want = (dx.to(dtype), (inv_c * (r2 - mean_c * r1)).sum(0), r1.sum(0))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


BOTH = {"search.unrolled": True, "search.partial_channels": 2}


def test_searcher_with_both_settings_resumes_exactly(stores, tmp_path):
    """Unrolled steps on the PC-DARTS supernet: a search of 2 epochs and
    one stopped after the first and resumed end in the same bits."""
    _, npzs = stores
    full = _searcher(npzs, tmp_path / "a", **BOTH)
    assert full.net.settings["pc_k"] == 2
    s_full, g_full = full.search(epochs=2, steps_per_epoch=2)
    _searcher(npzs, tmp_path / "b", **BOTH).search(epochs=1,
                                                   steps_per_epoch=2)
    s_res, g_res = _searcher(npzs, tmp_path / "b", **BOTH).search(
        epochs=2, steps_per_epoch=2)
    assert int(s_full["step"]) == int(s_res["step"]) == 4
    assert set(s_full) == set(s_res)
    for k in s_full:
        assert s_full[k].tobytes() == s_res[k].tobytes(), k
    assert g_full == g_res
    g_full.validate()


def test_searcher_takes_xi_from_the_config(stores, tmp_path, monkeypatch):
    """ξ = `search.xi`, or `search.w_lr` where it is 0
    (`bilevel.py:221`)."""
    _, npzs = stores
    seen = []
    real = bilevel.make_search_step_unrolled
    monkeypatch.setattr(bilevel, "make_search_step_unrolled",
                        lambda *a, **k: (seen.append(a[4]), real(*a, **k))[1])
    for ov in ({}, {"search.xi": 0.01}):
        _searcher(npzs, tmp_path / str(len(seen)),
                  **{"search.unrolled": True, "search.w_lr": 2e-3, **ov})
    assert seen == [2e-3, 0.01]


def test_search_command_with_both_settings(tmp_path, capsys):
    _, npzs = write_stores(str(tmp_path / "stores"))
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({
        "data": {"processed_dir": os.path.dirname(npzs[0]),
                 "patch_size": [8, 8, 8], "batch_size": 1,
                 "val_fraction": 0.34},
        "model": {"base_channels": 4, "depth": 1, "n_nodes": 2,
                  "gn_groups": 4, "dtype": "float32", "packed": False},
        "search": {"unrolled": True, "partial_channels": 2, "epochs": 1,
                   "warmup_epochs": 0, "steps_per_epoch": 2,
                   "val_steps": 1,
                   "checkpoint_dir": str(tmp_path / "search")},
        "parallel": {"data_parallel": 1, "spatial_parallel": 1}}))
    assert cli.main(["search", "-c", str(cfg), "--device", "cpu"]) == 0
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert out[-1]["event"] == "search_done"
    (epoch,) = [e for e in out if e["event"] == "epoch"]
    assert not epoch["warmup"] and np.isfinite(epoch["val_loss"])
    Genotype.load(str(tmp_path / "search" / "genotype.json")).validate()
