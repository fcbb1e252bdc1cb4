"""The port's supernet (nas_3d_unet_tpu_torch/models/cell.py `MixedOp`,
`_SourceOps`, `SuperDownCell`, `SuperUpCell`; models/unet.py `SuperNet`,
`arch_weights_from_alphas`; models/genotype.py α bookkeeping) against the
JAX package's, on the CPU in fp32.

The same weights on both sides through the bridge (the supernet's
`state_dict` keys are the flax paths, with random GroupNorm affines) and α
handed to both as numpy arrays (`jax.random` streams are not reproduced).
Tolerances as test_torch_ops.py / test_torch_train.py: outputs rtol 1e-4 /
atol 5e-5 where GroupNorm normalizes; every weight-gradient leaf rtol 1e-4
/ atol 1e-5; α gradients rtol 1e-4 / atol 1e-7 (they are 1e-3..1e-1).
The gradient comparison needs a point where fp32 rounding decides no
ReLU mask or pool maximum: with the depth-2 per-edge net's weights of
seed 1 a 1e-6 relative change of x moves the port's own gradients by
1.4 %, and they sit 1.5 % from JAX's there (as the base-8 derived net's one mask,
test_torch_grad_base8.py).  Each case draws its weights from its own seed
and the test first checks that its gradients move less than 1e-4 under
such a change.  Inside the port, the merged (source-major) cell equals the
per-edge `MixedOp` oracle with the wide kernels split edge by edge, at
rtol 1e-5 / atol 5e-6 (a wide conv sums in another fp32 order than its
narrow slices).
A genotype decoded from random α builds a derived net that matches the
JAX derived net with that genotype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.metrics.dice import get_loss_fn as jax_loss_fn
from nas_3d_unet_tpu.models import cell as jcell
from nas_3d_unet_tpu.models import genotype as jgeno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu.models.unet import SuperNet as JaxSuperNet
from nas_3d_unet_tpu.models.unet import arch_weights_from_alphas as jax_aw
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.metrics.losses import get_loss_fn
from nas_3d_unet_tpu_torch.models import cell, genotype
from nas_3d_unet_tpu_torch.models.unet import (DerivedNet, SuperNet,
                                               arch_weights_from_alphas)
from nas_3d_unet_tpu_torch.ops.primitives import DOWN_OPS, NORMAL_OPS, UP_OPS
from tests.test_torch_search_ops import jax_vjp
from tests.torch_helpers import one_torch_thread  # noqa: F401

SMALL = dict(in_channels=4, num_classes=3, base_channels=4, depth=2,
             n_nodes=2, gn_groups=4)
GN_ATOL = 5e-5


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _alphas(n_nodes, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in genotype.alpha_shapes(n_nodes).items()}


def _params(mod, seed):
    """A flax tree for `mod` from `seed` (GroupNorm affines random too),
    loaded into `mod`; returned as jnp arrays."""
    flat = bridge.params_from_flax(bridge.random_flax_params(mod, seed))
    rng = np.random.default_rng(seed + 100)
    for key, t in flat.items():
        if key.endswith("norm.scale") or key.endswith("norm.bias"):
            t.copy_(torch.from_numpy((rng.standard_normal(t.shape) * 0.3
                                      + key.endswith("scale"))
                                     .astype(np.float32)))
    tree = bridge.params_to_flax(flat)
    bridge.load_flax_params(mod, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close_tree(got: dict, want, rtol=1e-4, atol=1e-5):
    want = bridge.params_from_flax(want)
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


def test_alpha_bookkeeping_matches_jax():
    for n in (1, 2, 3, 4):
        assert genotype.num_mid_edges(n) == jgeno.num_mid_edges(n)
        assert genotype.alpha_shapes(n) == jgeno.alpha_shapes(n)
        for i in range(n):
            for j in range(i):
                assert genotype.mid_index(i, j) == jgeno.mid_index(i, j)
    g = torch.Generator()
    g.manual_seed(3)
    a = genotype.init_alphas(g, 3)
    assert list(a) == sorted(a)
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        jgeno.alpha_shapes(3)
    assert all(v.dtype == torch.float32 for v in a.values())
    flat = torch.cat([v.flatten() for v in a.values()])
    assert 0.5e-3 < float(flat.std()) < 2e-3        # scale 1e-3
    g.manual_seed(3)
    b = genotype.init_alphas(g, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    al = _alphas(3, 4)
    got = arch_weights_from_alphas({k: torch.from_numpy(v)
                                    for k, v in al.items()})
    want = jax_aw({k: jnp.asarray(v) for k, v in al.items()})
    for k in al:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_bf16_alpha_gradient_rounds_where_jax_casts():
    """An edge term w·y in bf16: the weight is cast to bf16 first (as
    `weights[o].astype(out.dtype)`), so its gradient multiplies g·y in bf16
    (one rounding a product) and rounds the volume's sum to bf16.  The
    port's is within 1 bf16 ulp of the float64 sum of the bf16 products,
    rounded to bf16 (its own sum runs in fp32); the JAX package on the CPU
    accumulates that sum in bf16 (at 8·8³ terms it misses by ~20 %), which
    the port does not follow."""
    y = torch.from_numpy(_x((1, 8, 8, 8, 8), 50)).bfloat16()
    g = torch.from_numpy(_x((1, 8, 8, 8, 8), 51)).bfloat16()
    w = torch.tensor(0.3, requires_grad=True)
    cell._weighted(w, y).backward(g)
    assert w.grad.dtype == torch.float32
    assert w.grad == w.grad.bfloat16().float()          # a bf16 value
    want = (g * y).double().sum().bfloat16().double()   # products in bf16
    ulp = 2.0 ** (np.frexp(abs(float(want)))[1] - 8)
    assert abs(float(w.grad) - float(want)) <= ulp


def _vjp_pair(tmod, jmod, params, x, w, n_out):
    """Forward and VJP (x, weights, parameters) of the port's and the JAX
    module called as (x, weights); `n_out` outputs (a tuple when > 1)."""
    outs, cts, (dp, dx, dw) = jax_vjp(
        lambda p, xx, ww: jmod.apply(p, xx, ww),
        (params, jnp.asarray(x), jnp.asarray(w)), 20)
    outs = outs if n_out > 1 else (outs,)
    cts = [np.array(c) for c in (cts if n_out > 1 else (cts,))]
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = tmod(xt, wt)
    got = list(got) if n_out > 1 else [got]
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cts])
    for g, o in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(o),
                                   rtol=1e-4, atol=GN_ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-4,
                               atol=GN_ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw), rtol=1e-4,
                               atol=1e-5)
    _close_tree({n: p.grad.numpy() for n, p in tmod.named_parameters()}, dp,
                atol=GN_ATOL)


OP_SETS = {"normal": (NORMAL_OPS, (1, 7, 5, 6, 8)),
           "down": (DOWN_OPS, (1, 7, 5, 6, 8)),
           "up": (UP_OPS, (1, 3, 4, 4, 8))}


@pytest.mark.parametrize("kind", sorted(OP_SETS))
def test_mixed_op_matches_jax(kind):
    ops, shape = OP_SETS[kind]
    x = _x(shape, 1)
    w = np.array(jax.nn.softmax(_x((len(ops),), 2)))
    tmod = cell.MixedOp(8, ops, gn_groups=4)
    params = _params(tmod, 3)
    jmod = jcell.MixedOp(8, ops, gn_groups=4)
    _vjp_pair(tmod, jmod, params, x, w, 1)


@pytest.mark.parametrize("kind", sorted(OP_SETS))
def test_source_ops_match_jax(kind):
    """k = 3 outgoing edges: the conv family as one 3·C-wide op with 3·g
    groups, the parameter-free ops once, separable convs per edge."""
    ops, shape = OP_SETS[kind]
    x = _x(shape, 4)
    w = np.array(jax.nn.softmax(_x((3, len(ops)), 5), axis=-1))
    tmod = cell._SourceOps(ops, 8, 3, gn_groups=4)
    params = _params(tmod, 6)
    jmod = jcell._SourceOps(ops, 8, 3, gn_groups=4)
    _vjp_pair(tmod, jmod, params, x, w, 3)


def _split_merged(cell_m, cell_e):
    """Load per-edge cell `cell_e` with merged cell `cell_m`'s weights:
    edge e of a source takes slice e of each wide op's kernel and affine,
    and the source's e-th separable conv."""
    sd_m, sd_e = cell_m.state_dict(), cell_e.state_dict()
    out = {}
    n = cell_m.n_nodes
    for key in sd_e:
        if not key.startswith("CheckpointMixedOp_"):
            out[key] = sd_m[key]            # the projections
    idx = 0
    for i in range(n):
        for p in range(2 + i):              # in0/below, in1/skip, n_j
            src = (f"src_{cell_m.in_srcs[p]}" if p < 2 else f"src_n{p - 2}")
            e = i if p < 2 else i - (p - 2) - 1
            k = n if p < 2 else n - (p - 2) - 1
            prefix = f"CheckpointMixedOp_{idx}."
            for key in sd_e:
                if not key.startswith(prefix):
                    continue
                child, rest = key[len(prefix):].split(".", 1)
                cls, num = child.rsplit("_", 1)
                if cls == "SepConv":
                    out[key] = sd_m[f"{src}.SepConv_{e}.{rest}"]
                elif cls == "UpSampleConv" and num == "1":     # separable
                    out[key] = sd_m[f"{src}.UpSampleConv_{1 + e}.{rest}"]
                else:                       # slice e of the wide op
                    t = sd_m[f"{src}.{child}.{rest}"]
                    width = t.shape[-1] // k
                    out[key] = t[..., e * width:(e + 1) * width]
            idx += 1
    cell_e.load_state_dict(out)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_merged_cell_equals_the_per_edge_oracle(kind):
    """The source-major cell (merge_ops) against the per-edge MixedOp
    chain with the same weights (wide kernels split by edge), 3 nodes:
    output, and gradients to both inputs and to the arch weights."""
    n, c = 3, 8
    if kind == "down":
        make = lambda m: cell.SuperDownCell(6, 5, c, n, gn_groups=4,
                                            merge_ops=m, s0_stride=2)
        xs = (_x((1, 8, 8, 8, 6), 7), _x((1, 4, 4, 4, 5), 8))
        ws = (_alphas(n, 9)["down_in"], _alphas(n, 9)["down_mid"])
    else:
        make = lambda m: cell.SuperUpCell(6, 5, c, n, gn_groups=4,
                                          merge_ops=m)
        xs = (_x((1, 8, 8, 8, 6), 7), _x((1, 4, 4, 4, 5), 8))
        al = _alphas(n, 9)
        ws = (al["up_skip"], al["up_below"], al["up_mid"])
    ws = [np.array(jax.nn.softmax(w, axis=-1)) for w in ws]
    cm, ce = make(True), make(False)
    _params(cm, 10)
    _split_merged(cm, ce)
    res = []
    for mod in (cm, ce):
        xt = [torch.from_numpy(a).requires_grad_() for a in xs]
        wt = [torch.from_numpy(a).requires_grad_() for a in ws]
        y = mod(*xt, *wt)
        y.backward(torch.from_numpy(_x(tuple(y.shape), 11)))
        res.append([y.detach()] + [t.grad for t in xt + wt])
    for a, b in zip(*res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=5e-6)


@pytest.fixture(scope="module", params=[(True, 1, 2), (False, 5, 1)],
                ids=["merged", "per_edge"])
def supernet_pair(request):
    """(port SuperNet, α, x, y, JAX loss, logits, w grads, α grads): one
    `jax.value_and_grad` of the Dice+CE loss through the JAX supernet
    (`packed=False`, remat off) per merge setting, weights from its seed;
    the per-edge net at depth 1 (every α group, the mid edges), as its
    JAX trace and compile take twice the merged net's."""
    merge, seed, depth = request.param
    net = SuperNet(merge_ops=merge, **{**SMALL, "depth": depth})
    params = _params(net, seed)
    al = _alphas(2, 2)
    x = _x((2, 8, 8, 8, 4), 3)
    y = np.repeat((x[..., 1:2] > 0.5).astype(np.float32), 3, -1)
    jnet = JaxSuperNet(remat=False, packed=False, merge_ops=merge,
                       dtype_name="float32", **{**SMALL, "depth": depth})
    loss = jax_loss_fn("regions")

    def f(p, a):
        logits = jnet.apply(p, jnp.asarray(x), jax_aw(a))
        return loss(logits, jnp.asarray(y)), logits

    (jl, logits), (gp, ga) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in al.items()})
    return net, al, x, y, float(jl), np.asarray(logits), gp, ga


def test_supernet_forward_matches_jax(supernet_pair):
    net, al, x, _, _, logits, _, _ = supernet_pair
    with torch.no_grad():
        got = net(torch.from_numpy(x), arch_weights_from_alphas(
            {k: torch.from_numpy(v) for k, v in al.items()}))
    assert got.dtype == torch.float32 and got.shape == logits.shape
    np.testing.assert_allclose(got.numpy(), logits, rtol=1e-4, atol=GN_ATOL)


def _port_grads(net, al, x, y):
    """(loss, w grads by name, α grads by group) of the port's supernet."""
    at = {k: torch.from_numpy(v).requires_grad_() for k, v in al.items()}
    net.zero_grad(set_to_none=True)
    loss = get_loss_fn("regions")(net(torch.from_numpy(x),
                                      arch_weights_from_alphas(at)),
                                  torch.from_numpy(y))
    loss.backward()
    return (loss.item(),
            {n: p.grad.numpy().copy() for n, p in net.named_parameters()},
            {k: a.grad.numpy() for k, a in at.items()})


def test_supernet_w_and_alpha_gradients_match_jax_grad(supernet_pair):
    net, al, x, y, jl, _, gp, ga = supernet_pair
    loss, gw, gal = _port_grads(net, al, x, y)
    # a smooth point: no mask or maximum decided by fp32 rounding
    _, gw2, _ = _port_grads(net, al, x * np.float32(1 + 1e-6), y)
    assert max(np.abs(gw2[k] - g).max() / np.abs(g).max()
               for k, g in gw.items()) < 1e-4
    assert abs(loss - jl) <= 1e-6
    _close_tree(gw, gp)
    for k, g in gal.items():
        np.testing.assert_allclose(g, np.asarray(ga[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_searched_genotype_builds_the_jax_derived_net():
    """A genotype decoded from random α (pools, identity and upsample
    convs among its edges) parses alike in both packages and builds a
    derived net that matches the JAX one."""
    al = _alphas(2, 31, scale=2.0)
    geno = genotype.parse_alphas(al, 2)
    assert geno.to_json() == jgeno.parse_alphas(al, 2).to_json()
    ops = {o for node in geno.down + geno.up for _, o in node}
    assert ops & {"identity", "avg_pool3", "max_pool3", "down_avg_pool",
                  "down_max_pool", "up_conv3", "up_sep_conv3"}, ops
    net = DerivedNet(geno, **SMALL)
    params = _params(net, 32)
    jnet = JaxDerivedNet(genotype=geno, remat=False, packed=False,
                         dtype_name="float32", **SMALL)
    x = _x((2, 8, 8, 8, 4), 33)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=GN_ATOL)
