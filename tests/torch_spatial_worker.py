"""One rank of the port's spatial-sharding tests, on the CPU over gloo.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        SPATIAL=s python -m tests.torch_spatial_worker OUT_DIR STORE_DIR

Imports torch, numpy and the port, nothing of JAX: each rank is a process
of its own, as torchrun starts them, and joins the group through
`parallel.mesh.maybe_initialize_distributed`; the mesh is data × SPATIAL.
It runs the cases of its layout and writes OUT_DIR/<case>_rank<r>.npz (and
OUT_DIR/loops_rank<r>.json): at data 1 × spatial 2 every candidate op on
slabs against the one-process op (forward, dx and the parameters'
gradients, both `use_pallas` values), the max pool on tied input, three
train steps of the derived net, the first-order, `pc_k` 2 and
second-order search steps, the second-order α gradient of the supernet
and of its `use_pallas` twin against one process (and with planted
faults: the loss sums' identity adjoint kept in the inner graph, K3's
statistics held constant), `gradcheck` and `gradgradcheck` of the halo
exchange, its adjoint and the differentiable sum across the two ranks, a
`use_pallas` and a pools-dilations-upsample net's gradients against one
process, remat bit-equal to remat off, the Trainer, the Searcher and
`predict_dataset`, the second-order step built under spatial sharding and
the slab rule's refusal; at data 2 × spatial 2 the train and second-order
search steps and `predict_dataset`.  The parent test
(tests/test_torch_spatial.py) builds the JAX references from the same
functions and compares.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.models.genotype import Genotype, default_genotype
from nas_3d_unet_tpu_torch.metrics.losses import dice_ce_loss
from nas_3d_unet_tpu_torch.models.unet import DerivedNet
from nas_3d_unet_tpu_torch.ops import groupnorm
from nas_3d_unet_tpu_torch.ops.primitives import (DOWN_OPS, NORMAL_OPS,
                                                  UP_OPS, make_op)
from nas_3d_unet_tpu_torch.ops.pool import max_pool3, upsample2x
from nas_3d_unet_tpu_torch.parallel import mesh as dp
from nas_3d_unet_tpu_torch.parallel import spatial
from nas_3d_unet_tpu_torch.search import bilevel
from nas_3d_unet_tpu_torch.train import loop
from nas_3d_unet_tpu_torch.train.optim import make_optimizer
from tests import torch_dp_worker as w

# the derived net of tests/test_parallel.py:29 `tiny_derived`: base 4,
# depth 2, 2 nodes, at 16^3 (2 planes a slab at the deepest level under
# spatial 2, the slab rule's least), the genotype the JAX package's
# `parse_alphas(init_alphas(PRNGKey(0), 2), 2)` decodes, its weights flax's
# `init(PRNGKey(1))` (written by the parent test to OUT_DIR/REF_PARAMS)
D_KW = dict(in_channels=4, num_classes=3, base_channels=4, depth=2,
            n_nodes=2, gn_groups=4)
REF_GENO = Genotype(
    n_nodes=2,
    down=((("in1", "down_dil_conv3"), ("in0", "down_avg_pool")),
          (("in0", "down_sep_conv3"), ("in1", "down_dil_conv3"))),
    up=((("below", "up_conv3"), ("skip", "max_pool3")),
        (("below", "up_conv3"), ("n0", "conv3"))))
REF_PARAMS = "ref_params.npz"
PARAMS_WAIT = 600               # s the train case waits for REF_PARAMS
EDGE = 16
STEPS = 3
LR, WD = 1e-3, 1e-4           # tests/test_parallel.py's optimizer
# pools, dilations, the upsample and the stride-2 dilated conv, which the
# flagship's genotype does not hold
WIDE = Genotype(n_nodes=2,
                down=((("in0", "down_dil_conv3"), ("in1", "down_max_pool")),
                      (("in1", "down_avg_pool"), ("n0", "dil_conv3"))),
                up=((("below", "up_conv3"), ("skip", "max_pool3")),
                    (("below", "up_sep_conv3"), ("n0", "avg_pool3"))))
# the ops' volume: D 8 (4 planes a slab; a stride-2 op's 2), C 4
OP_SHAPE = (2, 8, 6, 5, 4)
OPS = [(name, up) for name in (*NORMAL_OPS, *DOWN_OPS, *UP_OPS)
       for up in (False, True)]
SEARCH_KINDS = ("search", "pc", "unrolled")
UNROLLED_2X2 = "unrolled_2x2"       # the second-order step at 2 × 2
LOOP_OV = {"model.depth": 1, "parallel.spatial_parallel": 2}


def batch(seed: int, b: int, edge: int = EDGE):
    """(x, y) numpy as `torch_dp_worker.batch`, at edge^3."""
    x = np.random.default_rng(seed).standard_normal(
        (b, edge, edge, edge, 4)).astype(np.float32)
    wt = (x[..., 1] > 0.5).astype(np.float32)
    return x, np.stack([wt, wt, wt], axis=-1)


def derived_net(genotype=None, **kw) -> DerivedNet:
    net = DerivedNet(genotype or default_genotype(D_KW["n_nodes"]),
                     dtype="float32", **D_KW, **kw)
    bridge.load_flax_params(net, w.flax_params(net))
    return net


def train_case(mesh, out: str) -> dict:
    """STEPS train steps of tests/test_parallel.py's
    `_train_equality_vs_single_device`: REF_GENO's net from OUT_DIR's
    REF_PARAMS, one global batch of 2 rows a data index (seed 0), taken
    STEPS times: the losses and the parameters after them."""
    net = DerivedNet(REF_GENO, dtype="float32", **D_KW)
    path = os.path.join(out, REF_PARAMS)
    deadline = time.monotonic() + PARAMS_WAIT
    while not os.path.exists(path):     # the parent writes it meanwhile
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {PARAMS_WAIT} s")
        time.sleep(0.1)
    with np.load(path) as f:
        flat = {k: torch.from_numpy(f[k]) for k in f.files}
    bridge.load_flax_params(net, bridge.params_to_flax(flat))
    xy = w.rows(mesh, *batch(0, 2 * mesh.data_world))
    step = loop.make_train_step(net, make_optimizer(net.parameters(), LR, WD),
                                mesh=mesh)
    losses = [step(*xy).item() for _ in range(STEPS)]
    return {"loss": np.asarray(losses), **w._state(net)}


def _init(mod: torch.nn.Module, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape)
                                     .astype(np.float32) * 0.5 + 0.1))


def _run(fn, x, g, slab=None, params=()):
    """(y, dx, the parameters' gradients) of fn at x with cotangent g;
    on `slab`, of its slabs of x and g in its sharded-D context, the
    parameters' gradients summed over the spatial group."""
    if slab is not None:
        x, g = slab.cut(x), slab.cut(g)
    x = x.clone().requires_grad_()
    with spatial.sharded_d(slab):
        y = fn(x)
        grads = ([torch.zeros_like(t) for t in (x, *params)]
                 if not y.requires_grad else       # the "none" op
                 torch.autograd.grad(y, [x, *params], g, allow_unused=True,
                                     materialize_grads=True))
    dx, dps = grads[0], list(grads[1:])
    if slab is not None and dps:
        dps = spatial.all_reduce_sums(dps, slab)
    return y.detach(), dx, dps


def op_cases(mesh) -> dict:
    """Every candidate op, both `use_pallas` values, on this rank's slab
    and in one process: y and dx (the slab's and the one-process run's
    slab) and the parameters' gradients, keyed `<op>_<pallas>/...`."""
    out = {}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(OP_SHAPE).astype(np.float32))
    for i, (name, up) in enumerate(OPS):
        op = make_op(name, OP_SHAPE[-1], OP_SHAPE[-1], gn_groups=2,
                     use_pallas=up)
        _init(op, i)
        with torch.no_grad():
            shape = op(x).shape
        g = torch.from_numpy(np.random.default_rng(100 + i).standard_normal(
            shape).astype(np.float32))
        params = list(op.parameters())
        y1, dx1, dp1 = _run(op, x, g, None, params)
        ys, dxs, dps = _run(op, x, g, mesh.slab, params)
        key = f"{name}_{int(up)}"
        out.update({f"{key}/y": ys.numpy(), f"{key}/y_want":
                    mesh.slab.cut(y1).numpy(), f"{key}/dx": dxs.numpy(),
                    f"{key}/dx_want": mesh.slab.cut(dx1).numpy()})
        for j, (a, b) in enumerate(zip(dps, dp1)):
            out[f"{key}/dp{j}"], out[f"{key}/dp{j}_want"] = a.numpy(), b.numpy()
    # the trilinear upsample alone (no conv after it)
    g = torch.from_numpy(np.random.default_rng(99).standard_normal(
        (OP_SHAPE[0], 2 * OP_SHAPE[1], 2 * OP_SHAPE[2], 2 * OP_SHAPE[3],
         OP_SHAPE[4])).astype(np.float32))
    y1, dx1, _ = _run(upsample2x, x, g)
    ys, dxs, _ = _run(upsample2x, x, g, mesh.slab)
    out.update({"upsample2x/y": ys.numpy(),
                "upsample2x/y_want": mesh.slab.cut(y1).numpy(),
                "upsample2x/dx": dxs.numpy(),
                "upsample2x/dx_want": mesh.slab.cut(dx1).numpy()})
    # the max pool on tied input (ReLU plateaus of zeros), as
    # tests/test_parallel.py:197 holds the reference's
    xt = torch.from_numpy(np.maximum(rng.standard_normal(
        (2, 8, 8, 8, 4)), 0.0).astype(np.float32))
    for stride in (1, 2):
        with torch.no_grad():
            y = max_pool3(xt, stride)
        g = 2 * y / y.numel()             # d mean(y²) / dy
        _, dx1, _ = _run(lambda t: max_pool3(t, stride), xt, g)
        _, dxs, _ = _run(lambda t: max_pool3(t, stride), xt, g, mesh.slab)
        out[f"tied_max_pool_{stride}/dx"] = dxs.numpy()
        out[f"tied_max_pool_{stride}/dx_want"] = mesh.slab.cut(dx1).numpy()
    return out


def _net_grads(net, x, y, slab):
    """The loss and gradients of one full-D batch: in one process, or this
    rank's slab's (summed over the spatial group)."""
    from nas_3d_unet_tpu_torch.metrics.losses import dice_ce_loss

    (x, y) = loop.cut_slab(slab, net, x, y)
    with spatial.sharded_d(slab):
        loss, grads = loop.loss_and_grads(net, x, y, dice_ce_loss)
    grads = [g.clone() for g in grads]
    if slab is not None:
        grads = spatial.all_reduce_sums(grads, slab)
    return loss, grads


def net_cases(mesh) -> dict:
    """Gradients of the `use_pallas` derived net and of the WIDE
    genotype's on slabs against one process; remat on the cells under
    spatial sharding against remat off."""
    out = {}
    x, y = map(torch.from_numpy, batch(40, 2))
    for key, kw in (("pallas", dict(use_pallas=True)),
                    ("wide", dict(genotype=WIDE))):
        net = derived_net(**kw)
        for tag, slab in (("want", None), ("got", mesh.slab)):
            loss, grads = _net_grads(net, x, y, slab)
            out[f"{key}/loss_{tag}"] = loss.numpy()
            for i, g in enumerate(grads):
                out[f"{key}/g{i}_{tag}"] = g.numpy()
    for remat in (False, True):
        net = derived_net(WIDE, remat=remat)
        _, grads = _net_grads(net, x, y, mesh.slab)
        for i, g in enumerate(grads):
            out[f"remat{int(remat)}/g{i}"] = g.numpy()
    return out


def identity_adjoint_kept():
    """A planted fault: the second-order step's slabs keep the first-order
    convention (the loss sums' identity adjoint, each rank's loss seeded
    with 1), so its inner graph drops the cross-slab Hessian terms."""
    return mock.patch.object(bilevel, "_exact", lambda slab: slab)


def k3_statistics_constant():
    """A planted fault: the differentiated GroupNorm backward holds its
    statistics constant (K3's, on a `use_pallas` net)."""
    cut = groupnorm._grad_statistics
    return mock.patch.object(groupnorm, "_grad_statistics",
                             lambda *a: tuple(t.detach() for t in cut(*a)))


def second_order(mesh) -> dict:
    """The second-order α gradient and val loss (ξ = XI, the first global
    batch's first row) of the supernet and of its `use_pallas` twin, keyed
    `<net>/<α leaf>_<tag>`: in one process ("want"), on this rank's slab
    reduced over the group as the step reduces them ("got"), and on the
    slab with a planted fault: the loss sums' identity adjoint kept in the
    inner graph ("adjoint"), and, on the `use_pallas` net, K3's
    statistics held constant ("k3")."""
    out = {}
    for net_key, up in (("default", False), ("pallas", True)):
        cases = [("want", None, None), ("got", mesh, None),
                 ("adjoint", mesh, identity_adjoint_kept())]
        if up:
            cases.append(("k3", mesh, k3_statistics_constant()))
        for tag, m, fault in cases:
            net = w.supernet(use_pallas=up)
            alphas = {k: torch.from_numpy(v).requires_grad_()
                      for k, v in w.alphas_np().items()}
            b = [torch.from_numpy(a[:1]) for a in w.search_batches(0)]
            b = loop.cut_slab(None if m is None else m.slab, net, *b)
            with fault or contextlib.nullcontext():
                loss, grads = bilevel.unrolled_alpha_grads(
                    net, alphas, list(alphas.values()), w.XI, *b,
                    dice_ce_loss, m)
            grads = [g.contiguous() for g in grads]
            if m is not None:
                m.all_reduce_mean_([*grads, loss], slab_parts=len(grads))
            out[f"{net_key}/loss_{tag}"] = loss.numpy()
            for k, g in zip(alphas, grads):
                out[f"{net_key}/{k}_{tag}"] = g.numpy()
    return out


def _flipped(fn, slab):
    """fn on D-flipped tensors on the last slab: with two ranks each then
    sends its last planes and receives the other's, so the two ranks'
    Jacobians are the same matrices and `gradcheck`'s numerical
    perturbations, made at the same entries on both ranks at once, meet
    the analytical ones (every collective is one call on both)."""
    if not slab.last:
        return fn
    return lambda t: fn(t.flip(1)).flip(1)


def grad_checks(mesh) -> dict:
    """`gradcheck` and `gradgradcheck` in float64 across the two ranks of
    the spatial group: the halo exchange (zero fill and no fill at the
    global ends), its adjoint as a Function of its own, and the
    differentiable sum."""
    slab = mesh.slab
    torch.manual_seed(0)
    x = torch.randn((1, 3, 2, 2), dtype=torch.float64, requires_grad=True)
    halo = {"halo_zero": (1, 1, 0.0), "halo_none": (2, 2, None)}
    checks = {k: _flipped(lambda t, a=a: spatial.halo_d(t, *a, slab), slab)
              for k, a in halo.items()}
    lo_n = 0 if slab.first else 1
    checks["halo_adjoint"] = _flipped(
        lambda g: spatial._HaloAdjoint.apply(g, slab, 1, 1, 2, lo_n, None),
        slab)
    checks["summed"] = lambda t: spatial.summed(t * t, slab.group)
    out = {}
    for name, fn in checks.items():
        t = x[:, :3 if name == "halo_adjoint" else 2].detach() \
            .requires_grad_()
        out[name] = all(check(fn, (t,), raise_exception=False) for check in
                        (torch.autograd.gradcheck,
                         torch.autograd.gradgradcheck))
    return out


def refusals(mesh) -> dict:
    """The second-order step built under spatial sharding (one step's
    val loss), and the slab rule's refusal of a patch at the wrong depth,
    as its message."""
    out = {}
    net = w.supernet()
    alphas = {k: torch.from_numpy(v).requires_grad_()
              for k, v in w.alphas_np().items()}
    step = bilevel.make_search_step_unrolled(
        net, make_optimizer(net.parameters(), 1e-3, 0.0),
        make_optimizer(alphas.values(), 1e-3, 0.0), alphas, 0.5, mesh=mesh)
    out["unrolled"] = step(*w.rows(mesh, *w.search_batches(0)))[
        "val_loss"].item()
    net = derived_net()
    step = loop.make_train_step(net, make_optimizer(net.parameters(), LR, WD),
                                mesh=mesh)
    try:
        step(*w.rows(mesh, *batch(0, 2, edge=8)))
    except ValueError as e:
        out["slab_rule"] = str(e)
    return out


def loops(mesh, store: str, out: str) -> dict:
    """The Trainer and the Searcher under `mesh` (`torch_dp_worker`'s
    runs, stopped and resumed, at depth 1 and spatial 2) and
    `predict_dataset`."""
    res = {}
    if mesh.data_world == 1:
        res["trainer"] = w.trainer_case(mesh, store, out, LOOP_OV)
        res["searcher"] = w.searcher_case(mesh, store, out, LOOP_OV)
    res["predict"] = w.predict_case(mesh, store, out)
    return res


def _save(out: str, name: str, rank: int, arrays: dict) -> None:
    np.savez(os.path.join(out, f"{name}_rank{rank}.npz"), **arrays)


def main(out: str, store: str) -> int:
    torch.set_num_threads(1)
    dp.maybe_initialize_distributed("cpu")
    mesh = dp.make_mesh(-1, int(os.environ["SPATIAL"]))
    r = mesh.rank
    if mesh.data_world == 1:
        _save(out, "ops", r, op_cases(mesh))
        _save(out, "nets", r, net_cases(mesh))
        for kind in SEARCH_KINDS:
            _save(out, kind, r, w.search_case(mesh, kind))
        _save(out, "second_order", r, second_order(mesh))
    else:
        _save(out, UNROLLED_2X2, r, w.search_case(mesh, "unrolled"))
    res = loops(mesh, store, out)
    for name in ("trainer", "searcher"):
        if name in res:
            for run in ("full", "resumed"):
                _save(out, f"{name}_{run}", r, res[name].pop(f"state_{run}"))
    if mesh.data_world == 1:
        res["refusals"] = refusals(mesh)
        res["grad_checks"] = grad_checks(mesh)
    with open(os.path.join(out, f"loops_rank{r}.json"), "w") as f:
        json.dump(res, f)
    _save(out, "train", r, train_case(mesh, out))   # last: REF_PARAMS
    dp.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
