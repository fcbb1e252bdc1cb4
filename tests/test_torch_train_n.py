"""`train.steps_per_call` in the port (nas_3d_unet_tpu_torch/train/loop.py
`make_train_step_n`, the Trainer's n-step calls) on the CPU, where the
body that the card records as one CUDA graph runs eagerly:

  * against the JAX package's `make_train_step_n` (its `lax.scan`): the
    same weights through the bridge, no augmentation, microbatch 0 and 1,
    two calls of 3 steps with an LR change between them; losses within
    rtol 1e-5, every parameter within rtol 1e-4 / atol 1e-5, as one step
    is held in test_torch_train.py;
  * against n of the port's own single steps, bit for bit: with device
    augmentation, across two calls and an LR change (the losses, every
    parameter, AdamW's moments and count, the generator's state), also
    with `model.remat`;
  * AdamW's update from 0-d tensors (what a replay re-reads) against its
    update from floats, bit for bit, the tensors holding what the device
    divides by a host float with;
  * the Trainer with `steps_per_call: 3`: the epoch's steps must be a
    multiple of 3; 6 steps bit-equal to `steps_per_call: 1`; resume after
    one epoch trajectory-exact; refused on a mesh of more than one
    process; the `train` command with it, resumed.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.models.genotype import default_genotype as jax_geno
from nas_3d_unet_tpu.models.unet import DerivedNet as JaxDerivedNet
from nas_3d_unet_tpu.train import loop as jloop
from nas_3d_unet_tpu_torch import bridge, cli
from nas_3d_unet_tpu_torch.models.genotype import default_genotype
from nas_3d_unet_tpu_torch.models.unet import DerivedNet, make_derived
from nas_3d_unet_tpu_torch.parallel.mesh import Mesh
from nas_3d_unet_tpu_torch.train import loop, optim
from nas_3d_unet_tpu_torch.train.loop import Trainer
from nas_3d_unet_tpu_torch.utils.config import load_config
from tests.torch_helpers import write_stores
from tests.torch_helpers import one_torch_thread  # noqa: F401

NET = dict(in_channels=4, num_classes=3, base_channels=4, depth=2,
           n_nodes=2, gn_groups=4)
AUGMENT = dict(flip_prob=0.5, intensity_shift=0.1, intensity_scale=0.1)
LR, WD = 3e-4, 1e-4
N = 3


def _batches(count, seed=0, b=2, s=16):
    """`count` batches (x, y) as numpy: x ~ N(0, 1), y the WT mask of
    x[..., 1] in all three region channels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((count, b, s, s, s, 4)).astype(np.float32)
    wt = (x[..., 1] > 0.5).astype(np.float32)
    return x, np.stack([wt, wt, wt], axis=-1)


def _params(seed=1):
    """A flax tree for the small net with random GroupNorm affines."""
    flat = bridge.params_from_flax(bridge.random_flax_params(
        DerivedNet(default_genotype(2), dtype="float32", **NET), seed))
    rng = np.random.default_rng(seed + 100)
    for key, t in flat.items():
        if key.endswith("norm.scale") or key.endswith("norm.bias"):
            t.copy_(torch.from_numpy((rng.standard_normal(t.shape) * 0.3
                                      + key.endswith("scale"))
                                     .astype(np.float32)))
    return bridge.params_to_flax(flat)


def _net(params, remat=False):
    net = DerivedNet(default_genotype(2), dtype="float32", remat=remat, **NET)
    bridge.load_flax_params(net, params)
    return net


def _state(net, opt, gen):
    """Every tensor of the training state, and the count."""
    return ([p.detach().clone() for p in net.parameters()]
            + [m.clone() for m in opt.mu + opt.nu]
            + [gen.get_state()], opt.count)


def _assert_bitwise(a, b):
    (ta, ca), (tb, cb) = a, b
    assert ca == cb
    assert len(ta) == len(tb)
    for i, (u, v) in enumerate(zip(ta, tb)):
        assert u.dtype == v.dtype and torch.equal(u, v), i


@pytest.mark.parametrize("microbatch", [0, 1])
def test_n_steps_match_jax_make_train_step_n(microbatch):
    """Two calls of 3 steps, the LR cut to a tenth between them, against
    the JAX package's `lax.scan` step with its LR set through
    `inject_hyperparams` (as test_adamw_matches_optax_with_an_lr_change
    does)."""
    params = _params()
    xs, ys = _batches(2 * N)
    jnet = JaxDerivedNet(genotype=jax_geno(2), remat=False, packed=False,
                         dtype_name="float32", **NET)
    tx = jloop.make_optimizer(LR, WD)
    jstep = jloop.make_train_step_n(jnet.apply, tx, microbatch=microbatch)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = jloop.TrainState(params=jp, opt_state=tx.init(jp),
                             step=jnp.asarray(0, jnp.int32),
                             rng=jax.random.PRNGKey(1))
    want = []
    for call in range(2):
        if call:
            state = state.replace(opt_state=jloop.set_learning_rate(
                state.opt_state, LR * 0.1))
        sl = slice(call * N, (call + 1) * N)
        state, metrics = jstep(state, jnp.asarray(xs[sl]),
                               jnp.asarray(ys[sl]))
        want += np.asarray(metrics["loss"]).tolist()

    net = _net(params)
    opt = optim.make_optimizer(net.parameters(), LR, WD)
    step_n = loop.make_train_step_n(net, opt, microbatch=microbatch, n=N)
    got = []
    for call in range(2):
        if call:
            optim.set_learning_rate(opt, LR * 0.1)
        sl = slice(call * N, (call + 1) * N)
        losses = step_n(torch.from_numpy(xs[sl]), torch.from_numpy(ys[sl]))
        assert losses.shape == (N,) and losses.dtype == torch.float32
        got += losses.tolist()
    assert opt.count == 2 * N
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = bridge.params_from_flax(state.params)
    mine = dict(net.state_dict())
    assert set(mine) == set(ref)
    for key in ref:
        np.testing.assert_allclose(mine[key].numpy(), ref[key].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def _singles_against_n(microbatch, remat=False, s=8):
    """The training state after two calls of N steps with device
    augmentation and an LR change between them: (n sequential
    `make_train_step` calls, one `make_train_step_n` call per N), each
    with its losses."""
    params = _params(seed=2)
    xs, ys = (torch.from_numpy(a) for a in _batches(2 * N, seed=3, s=s))
    out = []
    for n_call in (1, N):
        net = _net(params, remat)
        opt = optim.make_optimizer(net.parameters(), LR, WD)
        gen = torch.Generator()
        gen.manual_seed(7)
        kw = dict(augment=AUGMENT, microbatch=microbatch, gen=gen)
        if n_call == 1:
            step = loop.make_train_step(net, opt, **kw)
        else:
            step_n = loop.make_train_step_n(net, opt, n=N, **kw)
        losses = []
        for call in range(2):
            if call:
                optim.set_learning_rate(opt, LR * 0.5)
            sl = slice(call * N, (call + 1) * N)
            if n_call == 1:
                losses += [step(x, y) for x, y in zip(xs[sl], ys[sl])]
            else:
                losses += list(step_n(xs[sl], ys[sl]).unbind())
        out.append((torch.stack(losses), _state(net, opt, gen)))
    return out


@pytest.mark.parametrize("microbatch", [0, 1])
def test_n_steps_equal_single_steps_bitwise(microbatch):
    (l1, s1), (ln, sn) = _singles_against_n(microbatch)
    assert torch.equal(l1, ln)
    _assert_bitwise(s1, sn)
    assert sn[1] == 2 * N


def test_n_steps_with_remat_equal_single_steps_bitwise():
    """`model.remat`: every cell under `torch.utils.checkpoint` without its
    RNG state (`models/cell.py`), as the card records it."""
    (l1, s1), (ln, sn) = _singles_against_n(1, remat=True)
    assert torch.equal(l1, ln)
    _assert_bitwise(s1, sn)


def test_adamw_update_from_tensors_equals_step_bitwise():
    """What a replay re-reads: −lr and the bias corrections as 0-d fp32
    tensors filled from the host formula give `step`'s bits, over counts
    where b2^t has not yet rounded away and an LR change."""
    rng = np.random.default_rng(4)
    shapes = [(3, 3, 3, 2, 4), (4,), (5, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    a = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    b = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    oa, ob = optim.make_optimizer(a, LR, WD), optim.make_optimizer(b, LR, WD)
    for t in range(1, 40):
        if t == 20:
            oa.lr = ob.lr = LR * 0.37
        grads = [torch.from_numpy((rng.standard_normal(s)
                                   * 10.0 ** -(t % 6)).astype(np.float32))
                 for s in shapes]
        oa.step(grads)
        bc1, bc2 = (optim.host_divisor(b, torch.device("cpu"))
                    for b in optim.bias_corrections(t))
        scalars = torch.from_numpy(np.array([-ob.lr, bc1, bc2], np.float32))
        ob.update(grads, scalars[0], scalars[1], scalars[2])
        for u, v in zip(a + oa.mu + oa.nu, b + ob.mu + ob.nu):
            assert torch.equal(u, v), t
    assert oa.count == 39 and ob.count == 0


def test_host_divisor_is_the_devices_own():
    """On the CPU ATen divides by a host float; on the card it multiplies
    by the float's fp32 reciprocal, so a CUDA graph is handed that."""
    for t in (1, 2, 17, 4000):
        for b in optim.bias_corrections(t):
            assert optim.host_divisor(b, torch.device("cpu")) == b
            inv = optim.host_divisor(b, torch.device("cuda", 0))
            assert inv.dtype == np.float32
            assert inv == np.float32(1) / np.float32(b)


def test_make_train_step_n_refuses_what_it_cannot_stage():
    net = _net(_params())
    opt = optim.make_optimizer(net.parameters(), LR, WD)
    with pytest.raises(ValueError, match="one process only"):
        loop.make_train_step_n(net, opt, n=2, mesh=Mesh(rank=0, world=2))
    with pytest.raises(ValueError, match="at least 1"):
        loop.make_train_step_n(net, opt, n=0)
    step_n = loop.make_train_step_n(net, opt, n=2)
    xs, ys = (torch.from_numpy(a) for a in _batches(3, s=8))
    with pytest.raises(ValueError, match="takes 2 batches"):
        step_n(xs, ys)
    step_n(xs[:2], ys[:2])
    x16, y16 = (torch.from_numpy(a) for a in _batches(2, s=16))
    with pytest.raises(ValueError, match="staged for"):
        step_n(x16, y16)
    assert opt.count == 2


# the Trainer, at 8³ patches (test_torch_trainer.py's sizes)
SMALL = {"data.patch_size": (8, 8, 8), "data.batch_size": 2,
         "data.val_fraction": 0.34, "model.base_channels": 4,
         "model.depth": 2, "model.n_nodes": 2, "model.gn_groups": 4,
         "model.dtype": "float32", "model.packed": False,
         "train.microbatch": 1, "train.seed": 0}
RECORD = ("epoch", "train_loss", "val_loss", "dice_wt", "dice_tc", "dice_et",
          "mean_dice", "lr")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return write_stores(str(tmp_path_factory.mktemp("stores")))


def _trainer(npzs, ckpt_dir, n_call, log=None, mesh=None):
    cfg = load_config(None, {**SMALL, "train.checkpoint_dir": str(ckpt_dir),
                             "train.steps_per_call": n_call})
    net = make_derived(cfg.model, cfg.data.num_classes, default_genotype(2))
    return Trainer(net, cfg, npzs, log_path=log, device="cpu", mesh=mesh)


def _epochs(log):
    return [{k: e[k] for k in RECORD} for e in map(json.loads, open(log))
            if e["event"] == "epoch"]


@pytest.fixture(scope="module")
def two_epochs(stores, tmp_path_factory):
    """2 epochs of 3 steps (val_steps 2) at steps_per_call 1 and 3: each
    final state and epoch record."""
    _, npzs = stores
    out = {}
    for n_call in (1, N):
        d = tmp_path_factory.mktemp(f"n{n_call}")
        tr = _trainer(npzs, d / "ck", n_call, str(d / "log.jsonl"))
        out[n_call] = (tr.train(epochs=2, steps_per_epoch=N, val_steps=2),
                       _epochs(d / "log.jsonl"), tr)
    return out


def test_trainer_refuses_an_epoch_that_n_does_not_divide(stores, tmp_path):
    tr = _trainer(stores[1], tmp_path, N)
    with pytest.raises(ValueError, match=r"train\.steps_per_call=3 must "
                                         r"divide steps_per_epoch=4"):
        tr.train(epochs=1, steps_per_epoch=4, val_steps=1)


def test_trainer_n_steps_equal_single_steps(two_epochs):
    (s1, e1, _), (sn, en, tr) = two_epochs[1], two_epochs[N]
    assert tr.steps_per_call == N and tr.opt.count == 2 * N
    assert int(sn["step"]) == 2 * N
    assert set(s1) == set(sn)
    for k in s1:
        assert s1[k].tobytes() == sn[k].tobytes(), k
    assert e1 == en and len(en) == 2


def test_trainer_n_steps_resume_is_trajectory_exact(stores, two_epochs,
                                                    tmp_path):
    _, npzs = stores
    _trainer(npzs, tmp_path / "ck", N).train(epochs=1, steps_per_epoch=N,
                                             val_steps=2)
    log = str(tmp_path / "resumed.jsonl")
    resumed = _trainer(npzs, tmp_path / "ck", N, log)
    state = resumed.train(epochs=2, steps_per_epoch=N, val_steps=2)
    full, records, _ = two_epochs[N]
    for k in full:
        assert full[k].tobytes() == state[k].tobytes(), k
    events = [json.loads(l) for l in open(log)]
    assert [e["step"] for e in events if e["event"] == "resume"] == [N]
    assert _epochs(log) == records[1:]


def test_trainer_refuses_n_steps_across_processes(stores, tmp_path):
    with pytest.raises(ValueError, match="one process only.*every rank of "
                                         "the port is a process"):
        _trainer(stores[1], tmp_path, N, mesh=Mesh(rank=0, world=2))
    # steps_per_call 1 on the same mesh builds
    _trainer(stores[1], tmp_path, 1, mesh=Mesh(rank=0, world=2))


def test_train_command_with_steps_per_call(stores, tmp_path):
    """`train --device cpu -o train.steps_per_call=3`: one epoch, then
    resumed to two: finite losses, the resume at step 3, the
    checkpoints."""
    args = ["train", "--device", "cpu", "-o", "train.steps_per_call=3",
            "-o", "train.steps_per_epoch=3",
            "-o", f"data.processed_dir={os.path.dirname(stores[1][0])}",
            "-o", f"train.checkpoint_dir={tmp_path / 'ck'}",
            "-o", f"train.genotype_path={tmp_path / 'absent.json'}"]
    for k, v in SMALL.items():
        args += ["-o", f"{k}={v}"]
    for epochs in (1, 2):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            assert cli.main([*args, "-o", f"train.epochs={epochs}"]) == 0
        assert json.loads(out.getvalue().splitlines()[-1])["event"] == \
            "train_done"
    events = [json.loads(l) for l in open(tmp_path / "ck" / "metrics.jsonl")]
    epochs = [e for e in events if e["event"] == "epoch"]
    assert [e["epoch"] for e in epochs] == [0, 1]
    assert all(np.isfinite(e["train_loss"]) for e in epochs)
    assert [e["step"] for e in events if e["event"] == "resume"] == [N]
    assert (tmp_path / "ck" / f"ckpt_{2 * N}.npz").exists()
