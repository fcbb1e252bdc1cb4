"""The port's partial-channel supernet (PC-DARTS, `search.partial_channels`
> 1: nas_3d_unet_tpu_torch/models/cell.py `_pc_shuffle`, `_pc_bypass`,
`_pc_split`, `MixedOp`, `_SourceOps` and the super cells with `pc_k`;
models/unet.py `SuperNet(pc_k=…)`) against the JAX package's, on the CPU
in fp32.

  * The channel shuffle, out[i·k+g] = in[g·(C/k)+i], bit for bit the
    reference's unpacked `_pc_shuffle`, in fp32 and bf16; the bypass (the
    stride-2 max pool on down edges, the trilinear upsample on up edges,
    identity on normal ones) against the reference's `_pc_bypass`.
  * `SuperNet(pc_k=2)` (base 8, 2 nodes, 8³, batch 2) against the JAX
    `SuperNet(pc_k=2, packed=False)`, merged (depth 2) and per edge (depth
    1): the JAX initialiser's tree loads through the bridge (the candidate
    ops' widths are C/2 on both sides), the forward within rtol 1e-4 /
    atol 5e-5, and one `jax.value_and_grad` of the Dice+CE loss: every
    weight leaf at rtol 1e-4 / atol 5e-5, α at rtol 1e-4 / atol 1e-7, at
    a point checked smooth first (test_torch_supernet.py's tolerances).
  * Inside the port, the merged cell equals the per-edge oracle at
    pc_k = 2, in float64 to 1e-10 (the sums' order is all that differs);
    every α row gets a gradient and the supernet shrinks; a
    pc_k that does not divide the base width raises the reference's
    error; the `use_pallas` supernet runs with pc_k = 2 and matches the
    default path's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from nas_3d_unet_tpu.metrics.dice import get_loss_fn as jax_loss_fn
from nas_3d_unet_tpu.models import cell as jcell
from nas_3d_unet_tpu.models.genotype import init_alphas as jax_init_alphas
from nas_3d_unet_tpu.models.unet import SuperNet as JaxSuperNet
from nas_3d_unet_tpu.models.unet import arch_weights_from_alphas as jax_aw
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.models import cell
from nas_3d_unet_tpu_torch.models.unet import (SuperNet,
                                               arch_weights_from_alphas)
from nas_3d_unet_tpu_torch.ops.primitives import DOWN_OPS, NORMAL_OPS, UP_OPS
from nas_3d_unet_tpu_torch.utils.params import count_params
from tests.test_torch_supernet import (GN_ATOL, _alphas, _close_tree,
                                       _params, _port_grads, _split_merged,
                                       _x)

PC = dict(in_channels=4, num_classes=3, base_channels=8, n_nodes=2,
          gn_groups=4)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [2, 3])
def test_shuffle_is_the_reference_shuffle_bit_for_bit(k, dtype):
    x = jnp.asarray(_x((1, 4, 3, 5, 12), 1)).astype(dtype)
    want = np.asarray(jcell._pc_shuffle(x, k).astype(jnp.float32))
    t = torch.from_numpy(np.array(x.astype(jnp.float32)))
    if dtype is not np.float32:
        t = t.bfloat16()
    got = cell._pc_shuffle(t, k)
    assert got.dtype == t.dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), want)
    cp = 12 // k
    for i in range(cp):
        for g in range(k):
            assert torch.equal(got[..., i * k + g], t[..., g * cp + i])


@pytest.mark.parametrize("ops", [DOWN_OPS, UP_OPS, NORMAL_OPS],
                         ids=["down", "up", "normal"])
def test_bypass_matches_the_reference(ops):
    class Bypass(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jcell._pc_bypass(x, ops)

    x = _x((1, 6, 4, 5, 3), 2)
    want = jax.jit(Bypass().apply)({}, jnp.asarray(x))
    got = cell._pc_bypass(torch.from_numpy(x), ops)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module", params=[(True, 2, 11), (False, 1, 12)],
                ids=["merged", "per_edge"])
def pc_pair(request):
    """(port SuperNet(pc_k=2), α, x, y, JAX loss, logits, w grads, α
    grads): the JAX initialiser's tree, loaded into the port through the
    bridge, then weights from the case's seed on both sides."""
    merge, depth, seed = request.param
    kw = {**PC, "depth": depth}
    net = SuperNet(merge_ops=merge, pc_k=2, **kw)
    jnet = JaxSuperNet(remat=False, packed=False, merge_ops=merge, pc_k=2,
                       dtype_name="float32", **kw)
    al = _alphas(2, 2)
    x = _x((2, 8, 8, 8, 4), 3)
    y = np.repeat((x[..., 1:2] > 0.5).astype(np.float32), 3, -1)
    bridge.load_flax_params(net, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(x),
        jax_aw(jax_init_alphas(jax.random.PRNGKey(1), 2))))
    params = _params(net, seed)
    loss = jax_loss_fn("regions")

    def f(p, a):
        logits = jnet.apply(p, jnp.asarray(x), jax_aw(a))
        return loss(logits, jnp.asarray(y)), logits

    (jl, logits), (gp, ga) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in al.items()})
    return net, al, x, y, float(jl), np.asarray(logits), gp, ga


def test_pc_supernet_forward_matches_jax(pc_pair):
    net, al, x, _, _, logits, _, _ = pc_pair
    with torch.no_grad():
        got = net(torch.from_numpy(x), arch_weights_from_alphas(
            {k: torch.from_numpy(v) for k, v in al.items()}))
    assert got.shape == logits.shape
    np.testing.assert_allclose(got.numpy(), logits, rtol=1e-4, atol=GN_ATOL)


def test_pc_supernet_gradients_match_jax_grad(pc_pair):
    net, al, x, y, jl, _, gp, ga = pc_pair
    loss, gw, gal = _port_grads(net, al, x, y)
    _, gw2, _ = _port_grads(net, al, x * np.float32(1 + 1e-6), y)
    assert max(np.abs(gw2[k] - g).max() / np.abs(g).max()
               for k, g in gw.items()) < 1e-4
    assert abs(loss - jl) <= 1e-6
    _close_tree(gw, gp, atol=GN_ATOL)
    for k, g in gal.items():
        np.testing.assert_allclose(g, np.asarray(ga[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_pc_merged_cell_equals_the_per_edge_oracle(kind):
    n, c = 3, 8
    if kind == "down":
        make = lambda m: cell.SuperDownCell(6, 5, c, n, gn_groups=4,
                                            merge_ops=m, s0_stride=2, pc_k=2)
        ws = (_alphas(n, 9)["down_in"], _alphas(n, 9)["down_mid"])
    else:
        make = lambda m: cell.SuperUpCell(6, 5, c, n, gn_groups=4,
                                          merge_ops=m, pc_k=2)
        al = _alphas(n, 9)
        ws = (al["up_skip"], al["up_below"], al["up_mid"])
    xs = (_x((1, 8, 8, 8, 6), 7), _x((1, 4, 4, 4, 5), 8))
    ws = [np.array(jax.nn.softmax(w, axis=-1)) for w in ws]
    cm, ce = make(True), make(False)
    _params(cm, 10)
    _split_merged(cm, ce)
    res = []
    for mod in (cm.double(), ce.double()):
        xt = [torch.from_numpy(a).double().requires_grad_() for a in xs]
        wt = [torch.from_numpy(a).double().requires_grad_() for a in ws]
        out = mod(*xt, *wt)
        out.backward(torch.from_numpy(_x(tuple(out.shape), 11)).double())
        res.append([out.detach()] + [t.grad for t in xt + wt])
    for a, b in zip(*res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_pc_alpha_grads_cover_every_row_and_the_net_shrinks():
    kw = {**PC, "depth": 2}
    net, full = SuperNet(pc_k=2, **kw), SuperNet(**kw)
    assert count_params(net) < count_params(full)
    assert net.clone().settings == net.settings
    assert count_params(full.clone(pc_k=2)) == count_params(net)
    bridge.load_flax_params(net, bridge.random_flax_params(net, 4))
    at = {k: torch.from_numpy(v).requires_grad_()
          for k, v in _alphas(2, 5).items()}
    out = net(torch.from_numpy(_x((1, 16, 16, 16, 4), 6)),
              arch_weights_from_alphas(at))
    assert tuple(out.shape) == (1, 16, 16, 16, 3)
    (out ** 2).sum().backward()
    for k, a in at.items():
        assert (a.grad.abs().sum(-1) > 0).all(), k


def test_pc_requires_divisibility():
    with pytest.raises(ValueError, match="partial_channels") as want:
        JaxSuperNet(pc_k=3, **{**PC, "base_channels": 4, "depth": 1}).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 4)),
            jax_aw(jax_init_alphas(jax.random.PRNGKey(1), 2)))
    with pytest.raises(ValueError) as got:
        SuperNet(pc_k=3, **{**PC, "base_channels": 4, "depth": 1})
    assert str(got.value) == str(want.value)


def test_pc_supernet_runs_on_the_use_pallas_path():
    """use_pallas with partial channels needs no new differentiation: its
    forward and gradients equal the default path's in fp32."""
    kw = {**PC, "depth": 1, "pc_k": 2}
    nets = [SuperNet(**kw), SuperNet(use_pallas=True, **kw)]
    _params(nets[0], 13)
    nets[1].load_state_dict(nets[0].state_dict())
    al = _alphas(2, 14)
    x = _x((1, 8, 8, 8, 4), 15)
    y = np.repeat((x[..., 1:2] > 0.5).astype(np.float32), 3, -1)
    (la, wa, aa), (lb, wb, ab) = (_port_grads(n, al, x, y) for n in nets)
    assert abs(la - lb) <= 1e-5
    for got, want in ((wb, wa), (ab, aa)):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
