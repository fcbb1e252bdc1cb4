"""Activation checkpointing in the port (`model.remat` per cell,
`model.remat_edges` per supernet edge: models/cell.py `checkpointed`,
models/unet.py) on the CPU.

  * Bit for bit: the loss and every gradient with remat on (cells; cells
    and edges; edges alone) equal remat off, for the derived net (a train
    step's microbatched gradients) and the supernet (the first-order
    gradients in w and α, and the second-order step's α gradient through
    the virtual weights), in fp32 and bf16, merged and per-edge.
  * The recompute launches the same kernels on the same inputs: every
    call of a kernel wrapper (`pgemm._k1`, `_k2`, `stats._moments`,
    `_weighted_sums`) with remat on has the inputs of a call with remat
    off, and the extra calls are the checkpointed regions' forward
    kernels, once per backward that walks through them (one a first-
    order backward, three for the second-order α gradient: the inner
    gradient's backward and the outer one through both forwards).
  * Against the JAX package's `remat=True` nets (`packed=False,
    use_pallas=False`: interpret mode fails under `nn.remat`, ROADMAP.md
    §3), same weights through the bridge, at atol 2e-5 / rtol 1e-4: the
    derived net's loss and gradients, the supernet's first-order loss and
    gradients, and the second-order α gradient (`val_after_virtual_step`,
    `search/bilevel.py:128-132`, ξ 0.5).
  * `torch.autograd.gradgradcheck` (fast mode) in float64 of a
    checkpointed supernet cell with its edges checkpointed too:
    non-reentrant checkpointing holds
    under the second-order step's `create_graph`, through the kernels'
    Functions (their wrappers opaque to autograd, as on the card).
"""

import collections
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.metrics.dice import get_loss_fn as jax_loss_fn
from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu.models.unet import SuperNet as JaxSuperNet
from nas_3d_unet_tpu.models.unet import arch_weights_from_alphas as jax_aw
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.metrics.losses import dice_ce_loss
from nas_3d_unet_tpu_torch.models import cell
from nas_3d_unet_tpu_torch.models.genotype import (alpha_shapes,
                                                   default_genotype)
from nas_3d_unet_tpu_torch.models.unet import (DerivedNet, SuperNet,
                                               arch_weights_from_alphas)
from nas_3d_unet_tpu_torch.ops import pgemm, stats
from nas_3d_unet_tpu_torch.search.bilevel import unrolled_alpha_grads
from nas_3d_unet_tpu_torch.train.loop import loss_and_grads
from tests import torch_dp_worker as w
from tests.test_torch_search_unrolled import opaque_kernels
from tests.torch_helpers import one_torch_thread  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4
KW = dict(in_channels=4, num_classes=3, base_channels=4, gn_groups=4)
SETTINGS = {"cells": dict(remat=True, remat_edges=False),
            "cells_edges": dict(remat=True),
            "edges": dict(remat=False, remat_edges=True)}


def _alphas(n_nodes, seed=2):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(s) * 0.5)
                                .astype(np.float32)).requires_grad_()
            for k, s in sorted(alpha_shapes(n_nodes).items())}


def _derived(dtype, **remat):
    net = DerivedNet(default_genotype(2), depth=2, n_nodes=2, dtype=dtype,
                     **KW, **remat)
    bridge.load_flax_params(net, w.flax_params(net))
    return net


def _supernet(dtype, merge_ops, **remat):
    net = SuperNet(depth=1, n_nodes=2, dtype=dtype, merge_ops=merge_ops,
                   **KW, **remat)
    bridge.load_flax_params(net, w.flax_params(net))
    return net


def _derived_grads(net):
    x, y = map(torch.from_numpy, w.batch(30, 2))
    loss, grads = loss_and_grads(net, x, y, dice_ce_loss, microbatch=1)
    return [loss] + [g.clone() for g in grads]


def _super_grads(net, order):
    al = _alphas(2)
    x, y, xv, yv = map(torch.from_numpy, w.search_batches(5))
    if order == "second":
        loss, grads = unrolled_alpha_grads(net, al, list(al.values()),
                                           w.XI, x[:1], y[:1], xv[:1],
                                           yv[:1], dice_ce_loss)
        return [loss] + grads
    loss = dice_ce_loss(net(x[:1], arch_weights_from_alphas(al)), y[:1])
    return [loss] + list(torch.autograd.grad(
        loss, [*net.parameters(), *al.values()]))


def _bit_equal(got, want):
    assert len(got) == len(want)
    for i, (g, t) in enumerate(zip(got, want)):
        assert g.dtype == t.dtype and torch.equal(g, t), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_derived_remat_is_bit_equal(dtype):
    _bit_equal(_derived_grads(_derived(dtype, remat=True)),
               _derived_grads(_derived(dtype)))


@pytest.mark.parametrize("merge_ops", [True, False],
                         ids=["merged", "per_edge"])
@pytest.mark.parametrize("order", ["first", "second"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_supernet_remat_is_bit_equal(dtype, order, merge_ops):
    want = _super_grads(_supernet(dtype, merge_ops), order)
    for name, remat in SETTINGS.items():
        _bit_equal(_super_grads(_supernet(dtype, merge_ops, **remat), order),
                   want)


class _Calls:
    """Every call of the kernel wrappers: (kernel, digest of its inputs)."""

    def __init__(self, mp):
        self.calls = []
        for mod, name in ((pgemm, "_k1"), (pgemm, "_k2"), (stats, "_moments"),
                          (stats, "_weighted_sums")):
            mp.setattr(mod, name, self._noting(name, getattr(mod, name)))

    def _noting(self, name, fn):
        def run(*args):
            h = hashlib.sha1()
            for a in args:
                h.update(a.detach().contiguous().numpy().tobytes()
                         if isinstance(a, torch.Tensor) else repr(a).encode())
            kernel = name if name != "_k1" else ("_k1" if args[3] else "_k1dx")
            self.calls.append((kernel, h.hexdigest()))
            return fn(*args)
        return run

    def take(self):
        out, self.calls = collections.Counter(self.calls), []
        return out


def _kernels(calls):
    """The forward kernels among `calls`, by kernel."""
    return collections.Counter({k: n for k, n in calls.items()
                                if k in ("_k1", "_k2", "_moments")})


@pytest.mark.parametrize("order", ["first", "second"])
def test_recompute_launches_the_same_kernels_on_the_same_inputs(order):
    """The supernet in fp32 with cells and edges checkpointed: the calls
    with remat on are the calls with remat off, plus the checkpointed
    regions' forward kernels once more per backward through them."""
    net = _supernet("float32", True)
    with pytest.MonkeyPatch.context() as mp:
        calls = _Calls(mp)
        _super_grads(net, order)
        off = calls.take()
        _super_grads(_supernet("float32", True, remat=True), order)
        on = calls.take()
        # one forward's kernels: the whole net's, the stem's and those of
        # the cells' input projections (the rest are the edges')
        x = torch.from_numpy(w.search_batches(5)[0][:1])
        with torch.no_grad():
            net(x, arch_weights_from_alphas(_alphas(2)))
            whole = calls.take()
            net.ConvNormAct_0(x)
            stem = calls.take()
            for c in (getattr(net, n) for n in (*net._down, *net._up)):
                for name in c.pre:
                    p = getattr(c, name)
                    p(torch.zeros(1, 4, 4, 4, p.conv.kernel.shape[-2]))
            proj = calls.take()
    assert set(on) == set(off)              # no input a call had not had
    extra = collections.Counter(k for k, _ in (on - off).elements())
    per = [_kernels(collections.Counter(k for k, _ in c.elements()))
           for c in (whole, stem, proj)]
    in_cells = per[0] - per[1]
    in_edges = in_cells - per[2]
    passes = 3 if order == "second" else 1
    assert extra == collections.Counter(
        {k: passes * (in_cells[k] + in_edges[k]) for k in in_cells})
    assert extra["_k1"] > 0 and extra["_moments"] > 0


def _jax_params(net):
    return jax.tree_util.tree_map(jnp.asarray, w.flax_params(net))


def _close(got, want, msg):
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=msg)


def test_derived_remat_matches_jax_remat():
    net = DerivedNet(default_genotype(1), dtype="float32", remat=True,
                     **w.D_KW)
    bridge.load_flax_params(net, w.flax_params(net))
    jnet = JaxDerivedNet(genotype=jax_geno(1), remat=True, packed=False,
                         use_pallas=False, dtype_name="float32", **w.D_KW)
    x, y = w.batch(30, 2)
    loss_fn = jax_loss_fn("regions")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(jnet.apply(p, x), y)))(_jax_params(net))
    x, y = map(torch.from_numpy, (x, y))
    loss, grads = loss_and_grads(net, x, y, dice_ce_loss)
    _close(loss.item(), float(jl), "loss")
    want = bridge.params_from_flax(jg)
    for (name, _), g in zip(net.named_parameters(), grads):
        _close(g.numpy(), want[name].numpy(), name)


@pytest.fixture(scope="module")
def jax_supernet():
    """The JAX supernet with remat (cells and edges), its loss function
    and the batches: w.S_KW's net (1 node, depth 1) at 8³."""
    jnet = JaxSuperNet(remat=True, packed=False, use_pallas=False,
                       dtype_name="float32", **w.S_KW)
    loss = jax_loss_fn("regions")

    def loss_fn(p, a, x, y):
        return loss(jnet.apply(p, x, jax_aw(a)), y)

    return loss_fn, tuple(jnp.asarray(b[:1]) for b in w.search_batches(5))


def _port_supernet():
    net = SuperNet(dtype="float32", remat=True, **w.S_KW)
    bridge.load_flax_params(net, w.flax_params(net))
    al = {k: torch.from_numpy(v).requires_grad_()
          for k, v in w.alphas_np().items()}
    return net, al


def test_supernet_remat_matches_jax_remat(jax_supernet):
    loss_fn, (x, y, _, _) = jax_supernet
    net, al = _port_supernet()
    jl, (jgw, jga) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        _jax_params(net), {k: jnp.asarray(v) for k, v in
                           w.alphas_np().items()}, x, y)
    loss = dice_ce_loss(net(torch.from_numpy(np.array(x)),
                            arch_weights_from_alphas(al)),
                        torch.from_numpy(np.array(y)))
    grads = torch.autograd.grad(loss, [*net.parameters(), *al.values()],
                                allow_unused=True, materialize_grads=True)
    _close(loss.item(), float(jl), "loss")
    want = bridge.params_from_flax(jgw)
    names = [n for n, _ in net.named_parameters()]
    for name, g in zip(names, grads):
        _close(g.numpy(), want[name].numpy(), name)
    for k, g in zip(al, grads[len(names):]):
        _close(g.numpy(), jga[k], k)


def test_second_order_remat_matches_jax_remat(jax_supernet):
    loss_fn, (x_tr, y_tr, x_val, y_val) = jax_supernet
    net, al = _port_supernet()

    def val_after_virtual_step(alphas, p):      # bilevel.py:128-132
        g_w = jax.grad(loss_fn, argnums=0)(p, alphas, x_tr, y_tr)
        w_virt = jax.tree_util.tree_map(lambda q, g: q - w.XI * g, p, g_w)
        return loss_fn(w_virt, alphas, x_val, y_val)

    jl, jg = jax.jit(jax.value_and_grad(val_after_virtual_step))(
        {k: jnp.asarray(v) for k, v in w.alphas_np().items()},
        _jax_params(net))
    batches = [torch.from_numpy(np.array(b))
               for b in (x_tr, y_tr, x_val, y_val)]
    with opaque_kernels():
        loss, grads = unrolled_alpha_grads(net, al, list(al.values()), w.XI,
                                           *batches, dice_ce_loss)
    _close(loss.item(), float(jl), "val loss")
    for k, g in zip(al, grads):
        _close(g.numpy(), jg[k], k)


def test_checkpointed_cell_is_twice_differentiable():
    """gradgradcheck (float64) of a supernet down cell run under
    `checkpointed`, its edges checkpointed inside, in its inputs and
    weight rows: the second derivative through the recompute, with every
    kernel wrapper opaque to autograd.  `fast_mode` checks random
    projections of the Jacobians of the backward (the kernels' own
    second derivatives are checked in full in
    test_torch_search_unrolled.py)."""
    torch.manual_seed(0)
    c = cell.SuperDownCell(2, 2, 4, 1, gn_groups=2, remat_edges=True)
    c = c.double()
    with torch.no_grad():
        for p in c.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    s0 = torch.randn(1, 4, 4, 4, 2, dtype=torch.float64)
    s1 = torch.randn(1, 4, 4, 4, 2, dtype=torch.float64, requires_grad=True)
    w_in = torch.softmax(torch.randn(2, 5, dtype=torch.float64), -1) \
        .requires_grad_()
    w_mid = torch.zeros(0, 7, dtype=torch.float64)

    def f(s1, w_in):
        return cell.checkpointed(c, s0, s1, w_in, w_mid)

    with opaque_kernels():
        out = f(s1, w_in)
        g = torch.autograd.grad(out.sum(), (s1, w_in), create_graph=True)
        assert all(t.grad_fn is not None for t in g)
        assert torch.autograd.gradgradcheck(f, (s1, w_in), atol=1e-5,
                                            rtol=1e-4, fast_mode=True)
