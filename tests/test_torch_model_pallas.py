"""The port's `use_pallas` configuration (`DerivedNet(use_pallas=True)`:
K6/K7/K4 on the edge ops, K3 for every GroupNorm; on the CPU the kernels'
twins) against the JAX package's `packed=False, use_pallas=True` net.

A small derived net (`default_genotype(2)`, depth 2, 16³, batch 2) with
the same weights on both sides through the bridge, random GroupNorm
affines, inputs from a numpy seed.
  * The forward against JAX's `use_pallas` net applied once under
    `pltpu.force_tpu_interpret_mode()` (~10 s, one module-scoped fixture),
    base 8, so that the level-2 convs (32 channels) run the reference's
    K6 body (`conv3d_pallas_viable`): rtol/atol 2e-4, as
    test_torch_model.py.
  * One fp32 train step (loss, every parameter after AdamW) and every
    gradient leaf against JAX's `make_train_step` / `jax.grad` on the
    `packed=False, use_pallas=False` net, rtol 1e-4 / atol 1e-5 as
    test_torch_train.py, at its base 4: at base 8 one ReLU mask is
    decided by fp32 rounding and the gradients of a few conv kernels sit
    up to 8e-5 from JAX's fp32 ones (test_torch_grad_base8.py holds both
    port paths at base 8 against JAX in float64).  `jax.grad` through the
    `use_pallas` net itself
    fails in interpret mode: the interpret callbacks carry effects, which
    `nn.remat` (around every cell) cannot partial-evaluate.  That net's
    convs and GroupNorms are the kernels' own plain references
    (`conv3d_reference`, `pointwise_reference`, `transpose2x_reference`,
    flax's GroupNorm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nas_3d_unet_tpu.metrics import dice as jd
from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu.train import loop as jloop
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.infer import sliding
from nas_3d_unet_tpu_torch.metrics import losses
from nas_3d_unet_tpu_torch.models.genotype import default_genotype
from nas_3d_unet_tpu_torch.models.unet import DerivedNet
from nas_3d_unet_tpu_torch.ops import (_cuda, conv3d, groupnorm, pgemm,
                                       primitives)
from nas_3d_unet_tpu_torch.ops.primitives import (ConvNormAct, SepConv,
                                                  UpTranspose)
from nas_3d_unet_tpu_torch.train import loop, optim
from tests.test_torch_train import AUGMENT, LR, WD, _batch, _jax_draws
from tests.torch_helpers import one_torch_thread  # noqa: F401

SMALL = dict(in_channels=4, num_classes=3, depth=2, n_nodes=2, gn_groups=4)


def _params(net, seed):
    """The port's tree with random GroupNorm affines, as a flax tree."""
    flat = bridge.params_from_flax(bridge.random_flax_params(net, seed))
    rng = np.random.default_rng(seed + 100)
    for key, t in flat.items():
        if key.endswith("norm.scale") or key.endswith("norm.bias"):
            t.copy_(torch.from_numpy((rng.standard_normal(t.shape) * 0.3
                                      + key.endswith("scale"))
                                     .astype(np.float32)))
    return bridge.params_to_flax(flat)


def _nets(seed, base=4):
    """(port use_pallas net, flax params) with the same weights."""
    net = DerivedNet(default_genotype(2), base_channels=base,
                     use_pallas=True, **SMALL)
    params = _params(net, seed)
    bridge.load_flax_params(net, params)
    return net, params


def _jax_net(use_pallas, base=4):
    return JaxDerivedNet(genotype=jax_geno(2), remat=False, packed=False,
                         use_pallas=use_pallas, base_channels=base,
                         dtype_name="float32", **SMALL)


@pytest.fixture(scope="module")
def forward_pair():
    """(x, port net, JAX use_pallas logits): the JAX net applied once in
    interpret mode; its parameters come from the port, since they do not
    depend on the flag."""
    x, _ = _batch()
    net, params = _nets(seed=1, base=8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(_jax_net(True, base=8).apply)(
            params, jnp.asarray(x)))
    return x, net, want


def test_use_pallas_forward_matches_jax_interpret(forward_pair):
    x, net, want = forward_pair
    _cuda.LAUNCHES.clear()
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert not _cuda.LAUNCHES                       # CPU: twins only
    assert got.shape == want.shape == (2, 16, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _count(monkeypatch, table):
    """Count calls of each (module, name) while keeping what they do."""
    calls = {name: 0 for _, name in table}
    for mod, name in table:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


_ROUTES = [(conv3d, "conv3d"), (conv3d, "pointwise_conv"),
           (conv3d, "conv_transpose2x"), (groupnorm, "pallas_group_norm"),
           (pgemm, "conv3x3x3_stats"), (pgemm, "gemm_stats"),
           (primitives, "group_norm"),
           (primitives, "group_norm_from_moments")]


def _expected(net, use_pallas):
    """Calls one forward makes, counted from the modules."""
    mods = list(net.modules())
    cna = [m for m in mods if isinstance(m, ConvNormAct)]
    norms = [m for m in mods if isinstance(m, (ConvNormAct, SepConv,
                                               UpTranspose))]
    k1 = sum(m.kernel == 3 and m.stride == 1 and not m.k6 for m in cna)
    k2 = sum(m.kernel == 1 and m.stride == 1 for m in cna)
    from_moments = k1 + k2
    return {"conv3d": sum(m.k6 for m in cna),
            "pointwise_conv": sum(isinstance(m, SepConv) for m in mods)
            * use_pallas,
            "conv_transpose2x": sum(isinstance(m, UpTranspose)
                                    for m in mods) * use_pallas,
            "pallas_group_norm": len(norms) * use_pallas,
            "conv3x3x3_stats": k1, "gemm_stats": k2,
            "group_norm": (len(norms) - from_moments) * (not use_pallas),
            "group_norm_from_moments": from_moments * (not use_pallas)}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_flagship_routes_each_op_to_its_kernel(use_pallas, monkeypatch):
    """The full-width flagship: under use_pallas every 3³ edge conv goes to
    K6 (15 stride 1, 6 stride 2), every SepConv to K7 (9), every
    UpTranspose to K4 (3), every GroupNorm to K3 (46), the stem to K1 and
    the 1³ projections to K2; without it none of the four."""
    net = DerivedNet(default_genotype(3), use_pallas=use_pallas)
    calls = _count(monkeypatch, _ROUTES)
    with torch.inference_mode():
        net(torch.zeros(1, 16, 16, 16, 4))
    want = _expected(net, use_pallas)
    assert calls == want
    if use_pallas:
        assert (want["conv3d"], want["pointwise_conv"],
                want["conv_transpose2x"], want["pallas_group_norm"],
                want["conv3x3x3_stats"], want["gemm_stats"]) \
            == (21, 9, 3, 46, 1, 10)


@pytest.mark.parametrize("microbatch", [0, 1])
def test_use_pallas_fp32_train_step_matches_jax(microbatch, monkeypatch):
    x, y = _batch(seed=2)
    net, params = _nets(seed=3)
    tx = jloop.make_optimizer(LR, WD)
    jstep = jloop.make_train_step(_jax_net(False).apply, tx, augment=AUGMENT,
                                  microbatch=microbatch)
    state = jloop.TrainState(params=params, opt_state=tx.init(params),
                             step=jnp.asarray(0, jnp.int32),
                             rng=jax.random.PRNGKey(1))
    state, metrics = jstep(state, jnp.asarray(x), jnp.asarray(y))
    want = bridge.params_from_flax(state.params)

    draws = _jax_draws(jax.random.PRNGKey(1), x.shape[0], x.shape[-1])
    monkeypatch.setattr(loop, "draw_augment", lambda *a, **k: draws)
    step = loop.make_train_step(net, optim.make_optimizer(net.parameters(),
                                                          LR, WD),
                                augment=AUGMENT, microbatch=microbatch)
    _cuda.LAUNCHES.clear()
    got_loss = step(torch.from_numpy(x), torch.from_numpy(y)).item()
    assert not _cuda.LAUNCHES
    np.testing.assert_allclose(got_loss, float(metrics["loss"]), rtol=1e-5)
    got = dict(net.state_dict())
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_use_pallas_gradients_match_jax_grad():
    x, y = _batch(seed=4)
    net, params = _nets(seed=5)
    jnet = _jax_net(False)

    def jloss(p):
        return jd.dice_ce_loss(jnet.apply(p, jnp.asarray(x)), jnp.asarray(y))

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    want = bridge.params_from_flax(jgrads)
    loss, grads = loop.loss_and_grads(net, torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      losses.dice_ce_loss)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    names = [n for n, _ in net.named_parameters()]
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_predictor_takes_the_use_pallas_net(forward_pair):
    """The sliding window serves the use_pallas net as it serves the
    default one: with the same weights, probabilities within 1e-4."""
    _, net, _ = forward_pair
    plain = DerivedNet(default_genotype(2), base_channels=8, **SMALL)
    plain.load_state_dict(net.state_dict())
    vol = np.random.default_rng(6).standard_normal((20, 17, 16, 4)).astype(
        np.float32)
    probs = [sliding.SlidingWindowPredictor(
        m, (16, 16, 16), overlap=0.5, batch_size=2,
        num_classes=3).predict_volume(vol) for m in (net, plain)]
    assert probs[0].shape == (20, 17, 16, 3)
    np.testing.assert_allclose(probs[0], probs[1], rtol=1e-4, atol=1e-4)
