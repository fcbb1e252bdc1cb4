"""The port's training path (nas_3d_unet_tpu_torch/train, metrics/losses.py,
data/augment.py) against the JAX package's, on CPU.

A tiny derived net (`default_genotype(2)`, base 4, depth 2, 16³, batch 2)
with the same weights on both sides through the bridge, the same inputs
from a numpy seed, and the augmentation draws JAX makes from its key handed
to the port.  The fp32 cases run the JAX net unpacked (flax convs and
GroupNorm, autodiff), which compiles in a third of the packed net's time;
the bf16 case runs it lane-packed, the shipped layout whose bf16 rounding
points the port follows (on the CPU: the XLA conv + custom-VJP GroupNorm
path, which test_torch_stats.py pins separately).  Tolerances:
  * one fp32 step (loss, every parameter after AdamW) and every gradient
    leaf against `jax.grad`: rtol 1e-4 / atol 1e-5;
  * losses 1e-6, augmentation exact, AdamW 1e-6 (elementwise fp32 math in
    the same order);
  * one bf16 step: the loss within 1e-3, the gradient within 0.15 relative
    L2 over all leaves and a cosine >= 0.8 per leaf.  The JAX net on the
    CPU lowers each 3³ conv as one 2D conv per depth tap and rounds each
    to bf16 (`packed.py:211-216`); the port rounds once, as the reference's
    Pallas kernels do.  At this size that noise is as large as the
    distance between a bf16 and an fp32 step, so this case holds the
    step's plumbing in bf16; the rounding points are pinned op by op
    (test_torch_pgemm.py, test_torch_stats.py).
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nas_3d_unet_tpu.data.pipeline import augment_batch as jax_augment
from nas_3d_unet_tpu.metrics import dice as jd
from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu.train import loop as jloop
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.data.augment import augment_batch
from nas_3d_unet_tpu_torch.metrics import losses
from nas_3d_unet_tpu_torch.models.genotype import default_genotype
from nas_3d_unet_tpu_torch.models.unet import DerivedNet
from nas_3d_unet_tpu_torch.ops import _cuda
from nas_3d_unet_tpu_torch.train import loop, optim

SMALL = dict(in_channels=4, num_classes=3, base_channels=4, depth=2,
             n_nodes=2, gn_groups=4)
AUGMENT = dict(flip_prob=0.5, intensity_shift=0.1, intensity_scale=0.1)
LR, WD = 3e-4, 1e-4


def _batch(seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, s, s, 4)).astype(np.float32)
    wt = (x[..., 1] > 0.5).astype(np.float32)          # as bench.py builds y
    return x, np.stack([wt, wt, wt], axis=-1)


def _nets(dtype="float32", seed=1, packed=False):
    """(port net, JAX net, flax params): the port's tree with random GN
    affines, so the affine's gradients are exercised."""
    net = DerivedNet(default_genotype(2), dtype=dtype, **SMALL)
    params = bridge.random_flax_params(net, seed)
    rng = np.random.default_rng(seed + 100)
    flat = bridge.params_from_flax(params)
    for key, t in flat.items():
        if key.endswith("norm.scale") or key.endswith("norm.bias"):
            t.copy_(torch.from_numpy((rng.standard_normal(t.shape) * 0.3
                                      + key.endswith("scale"))
                                     .astype(np.float32)))
    params = bridge.params_to_flax(flat)
    bridge.load_flax_params(net, params)
    jnet = JaxDerivedNet(genotype=jax_geno(2), remat=False, packed=packed,
                         dtype_name=dtype, **SMALL)
    return net, jnet, params


def _jax_draws(key, b, c):
    """The draws `augment_batch` makes inside JAX's step from the state key
    (`loop.py:147-149`, `pipeline.py:228-242`)."""
    _, k_aug = jax.random.split(key)
    kf, ks, kc = jax.random.split(k_aug, 3)
    flip = jax.random.uniform(kf, (b, 3)) < AUGMENT["flip_prob"]
    shp = (b, 1, 1, 1, c)
    s, m = AUGMENT["intensity_shift"], AUGMENT["intensity_scale"]
    sh = jax.random.uniform(ks, shp, minval=-s, maxval=s)
    sc = 1.0 + jax.random.uniform(kc, shp, minval=-m, maxval=m)
    return tuple(torch.from_numpy(np.array(a)) for a in (flip, sh, sc))


def _jax_step(jnet, params, x, y, microbatch):
    """(loss, parameters after the step, AdamW's first moment (1 − b1)·g
    after the step), the last two by flax path."""
    tx = jloop.make_optimizer(LR, WD)
    step = jloop.make_train_step(jnet.apply, tx, augment=AUGMENT,
                                 microbatch=microbatch)
    state = jloop.TrainState(params=params, opt_state=tx.init(params),
                             step=jnp.asarray(0, jnp.int32),
                             rng=jax.random.PRNGKey(1))
    state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
    mu = state.opt_state.inner_state[0].mu          # optax.flatten's vector
    mu = jax.flatten_util.ravel_pytree(params)[1](mu)
    return (float(metrics["loss"]), bridge.params_from_flax(state.params),
            bridge.params_from_flax(mu))


def _port_step(net, x, y, microbatch, monkeypatch):
    """(loss, the optimizer) after one step of the port."""
    draws = _jax_draws(jax.random.PRNGKey(1), x.shape[0], x.shape[-1])
    monkeypatch.setattr(loop, "draw_augment", lambda *a, **k: draws)
    opt = optim.make_optimizer(net.parameters(), LR, WD)
    step = loop.make_train_step(net, opt, augment=AUGMENT,
                                microbatch=microbatch)
    return step(torch.from_numpy(x), torch.from_numpy(y)).item(), opt


@pytest.mark.parametrize("microbatch", [0, 1])
def test_fp32_train_step_matches_jax(microbatch, monkeypatch):
    x, y = _batch()
    net, jnet, params = _nets()
    want_loss, want, _ = _jax_step(jnet, params, x, y, microbatch)
    _cuda.LAUNCHES.clear()
    got_loss, _ = _port_step(net, x, y, microbatch, monkeypatch)
    assert not _cuda.LAUNCHES
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    got = dict(net.state_dict())
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_gradients_match_jax_grad():
    x, y = _batch(seed=2)
    net, jnet, params = _nets(seed=3)

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


def test_bf16_train_step_loss_matches_jax(monkeypatch):
    """One bf16 step: the loss within 1e-3, the gradient (AdamW's first
    moment) within 0.15 in relative L2 over all leaves and a cosine of at
    least 0.8 on every leaf; fp32 parameters and optimizer state."""
    x, y = _batch(seed=4)
    net, jnet, params = _nets("bfloat16", seed=5, packed=True)
    want_loss, _, want_mu = _jax_step(jnet, params, x, y, microbatch=1)
    got_loss, opt = _port_step(net, x, y, 1, monkeypatch)
    assert abs(got_loss - want_loss) <= 1e-3
    assert all(t.dtype == torch.float32
               for t in (*net.parameters(), *opt.mu, *opt.nu))
    names = [n for n, _ in net.named_parameters()]
    assert set(names) == set(want_mu)
    got = [m.double().flatten() for m in opt.mu]
    want = [torch.from_numpy(np.asarray(want_mu[n], np.float64)).flatten()
            for n in names]
    for name, g, w in zip(names, got, want):
        assert g @ w >= 0.8 * g.norm() * w.norm(), name
    g, w = torch.cat(got), torch.cat(want)
    assert (g - w).norm() <= 0.15 * w.norm()


@pytest.mark.parametrize("label_mode", ["regions", "classes"])
def test_losses_match_jax(label_mode):
    rng = np.random.default_rng(6)
    k = 3 if label_mode == "regions" else 4
    logits = (rng.standard_normal((2, 5, 4, 3, k)) * 3).astype(np.float32)
    if label_mode == "regions":
        y = (rng.random((2, 5, 4, 3, k)) > 0.6).astype(np.float32)
        np.testing.assert_allclose(
            losses.soft_dice_loss(torch.sigmoid(torch.from_numpy(logits)),
                                  torch.from_numpy(y)).item(),
            float(jd.soft_dice_loss(jax.nn.sigmoid(logits), y)), rtol=1e-6)
        np.testing.assert_allclose(
            losses.sigmoid_binary_cross_entropy(
                torch.from_numpy(logits), torch.from_numpy(y)).numpy(),
            np.asarray(optax.sigmoid_binary_cross_entropy(logits, y)),
            rtol=1e-6, atol=1e-6)
    else:
        y = rng.integers(0, k, (2, 5, 4, 3))
    got = losses.get_loss_fn(label_mode)(torch.from_numpy(logits),
                                         torch.from_numpy(y))
    want = jd.get_loss_fn(label_mode)(jnp.asarray(logits), jnp.asarray(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # bf16 logits are upcast first on both sides
    lb = torch.from_numpy(logits).bfloat16()
    np.testing.assert_allclose(
        losses.get_loss_fn(label_mode)(lb, torch.from_numpy(y)).item(),
        float(jd.get_loss_fn(label_mode)(jnp.asarray(logits, jnp.bfloat16),
                                         jnp.asarray(y))), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.get_loss_fn("voxels")


def test_augment_batch_exact_given_jax_draws():
    x, y = _batch(seed=7, s=6)
    key = jax.random.PRNGKey(9)
    k_aug = jax.random.split(key)[1]
    want_x, want_y = jax_augment(k_aug, jnp.asarray(x), jnp.asarray(y),
                                 **AUGMENT)
    flip, sh, sc = _jax_draws(key, 2, 4)
    got_x, got_y = augment_batch(torch.from_numpy(x), torch.from_numpy(y),
                                 flip, sh, sc)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_adamw_matches_optax_with_an_lr_change():
    rng = np.random.default_rng(8)
    shapes = [(3, 3, 3, 2, 4), (4,), (5, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** -e).astype(np.float32)
              for s, e in zip(shapes, (1, 3, 5))] for _ in range(3)]
    tx = jloop.make_optimizer(LR, WD)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(p0)}
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = optim.make_optimizer(params, LR, WD)
    for step, g in enumerate(grads):
        if step == 2:                              # the plateau LR cut
            state = jloop.set_learning_rate(state, LR * 0.1)
            optim.set_learning_rate(opt, LR * 0.1)
        assert optim.get_learning_rate(opt) == pytest.approx(
            jloop.get_learning_rate(state))
        upd, state = tx.update({str(i): jnp.asarray(a)
                                for i, a in enumerate(g)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(a) for a in g])
        for i, p in enumerate(params):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[str(i)]), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("label_mode", ["regions", "classes"])
def test_eval_step_and_plateau_match_jax(label_mode):
    """The eval step on given logits (an identity model), and the plateau
    controller over one metric sequence."""
    rng = np.random.default_rng(10)
    k = 3 if label_mode == "regions" else 4
    logits = rng.standard_normal((2, 4, 4, 4, k)).astype(np.float32)
    y = ((rng.random((2, 4, 4, 4, 3)) > 0.5).astype(np.float32)
         if label_mode == "regions" else rng.integers(0, 4, (2, 4, 4, 4)))
    want = jloop.make_eval_step(lambda p, v: v, label_mode=label_mode)(
        None, jnp.asarray(logits), jnp.asarray(y))
    got = loop.make_eval_step(torch.nn.Identity(), label_mode=label_mode)(
        torch.from_numpy(logits), torch.from_numpy(y))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=1e-6, err_msg=name)
    ours = loop.PlateauController(patience=1, factor=0.5, min_lr=1e-5)
    ref = jloop.PlateauController(patience=1, factor=0.5, min_lr=1e-5)
    lr_o = lr_r = 1e-3
    for m in (0.1, 0.2, 0.2, 0.1, 0.1, 0.3, 0.3, 0.3, 0.3, 0.3):
        (lr_o, best_o), (lr_r, best_r) = ours.update(m, lr_o), \
            ref.update(m, lr_r)
        assert (lr_o, best_o) == (lr_r, best_r)
    assert ours.state_dict() == ref.state_dict()


def test_train_step_draws_from_the_callers_generator(monkeypatch):
    """`make_train_step(gen=...)` draws its augmentation from the caller's
    generator: a generator seeded like `seed` gives the same draws, and one
    restored from a saved state continues them (what a checkpoint's
    `rng/augment` carries)."""
    draws = []

    def noted(*args, **kwargs):
        out = loop_draw(*args, **kwargs)
        draws.append(out)
        return out

    loop_draw = loop.draw_augment
    monkeypatch.setattr(loop, "draw_augment", noted)
    x, y = (torch.from_numpy(a) for a in _batch(b=2, s=8))

    def run(**kw):
        net, _, _ = _nets()
        step = loop.make_train_step(net, optim.make_optimizer(
            net.parameters(), LR, WD), augment=AUGMENT, **kw)
        start = len(draws)
        for _ in range(2):
            step(x, y)
        return draws[start:]

    gen = torch.Generator()
    gen.manual_seed(5)
    want = run(seed=5)
    got = run(gen=gen)
    saved = torch.Generator()
    saved.manual_seed(5)
    torch.rand((2, 3), generator=saved)                  # step 1's draws
    torch.rand((2, 1, 1, 1, 4), generator=saved)
    torch.rand((2, 1, 1, 1, 4), generator=saved)
    resumed = torch.Generator()
    resumed.set_state(saved.get_state())
    net, _, _ = _nets()
    loop.make_train_step(net, optim.make_optimizer(net.parameters(), LR, WD),
                         augment=AUGMENT, gen=resumed)(x, y)
    for a, b in zip(want + want[1:], got + draws[-1:]):
        for ta, tb in zip(a, b):
            assert torch.equal(ta, tb)
