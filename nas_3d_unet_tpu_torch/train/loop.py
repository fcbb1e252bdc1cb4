"""Derived-model training: the step, eval step, plateau LR and the Trainer.

Counterpart of `nas_3d_unet_tpu/train/loop.py`: `make_train_step`
(:81-181), `make_eval_step` (:213-236), `PlateauController` (:239-266),
`warn_stream_geometry_mismatch` (:269) and `Trainer` (:294).
A step: augment the full batch (draws from the step's generator), take the
gradient over the full batch or as the mean over strided microbatch slices
(sample j goes to slice j % k), then one AdamW update, in place.

The model runs eagerly, so the step is a Python function over the model's
own parameters; there is no jit or donation.  Entry points run where the
model's parameters are: on the card unless the caller put the model on
the CPU.

`train.steps_per_call` n > 1 (`make_train_step_n`, the reference's
`lax.scan` at `loop.py:184-210`): n steps in one call, bit for bit the n
sequential steps.  On the card the n steps are one CUDA graph, captured at
the first call and replayed once per call; on the CPU the body that the
card records runs eagerly.  What a call changes reaches the body only
through tensors that a replay re-reads: the staged batches, −lr and the n
steps' bias corrections (in the form the device divides by a host float
with, `optim.host_divisor`).  The capture:
  * comes after one eager warm-up step on a side stream (cuDNN's plans,
    the kernels' library and shared-memory limits), and the parameters,
    AdamW's moments and count and the augmentation generator are restored
    after warm-up and capture, so the first replay starts where the call
    found them;
  * registers the augmentation generator with the graph, so a replay
    draws what n eager steps would and advances it as far;
  * records one stream: the graph is a chain, so no two K5 launches
    overlap and K5's shared completion tickets (`csrc/stats.cu`) stay
    safe;
  * is "thread_local": the Prefetcher's thread goes on pinning and copying
    on its own stream meanwhile;
  * counts each kernel's launches once in `_cuda.LAUNCHES` (a replay
    never enters Python); `launches_at_capture` keeps that count.
A capture or a replay that fails raises: the card never runs n > 1 as the
eager loop.  Like the reference (`loop.py:365-369`), n > 1 runs on one
process only.

Data parallelism (`parallel/mesh.py`, the reference's `loop.py:316-365`):
each data index of a `Mesh` runs its own rows of the global batch, and the
step averages the gradients (and the loss) over the data axis before
AdamW.  Both losses are means of per-sample terms (`metrics/losses.py`),
so the mean of the row sets' gradients is the global batch's.  A
microbatch of m slices each rank's local rows, m / data of them a slice,
so a slice is the global batch's strided slice; where the data axis does
not divide m the step warns and takes the full local batch
(`loop.py:316-333`).  The Trainer feeds each data index batch / data rows
from host streams offset by 100003·(data index), starts every rank from
rank 0's state, and averages the eval metrics over the data axis, so the
plateau controller takes the same branch everywhere.

Spatial sharding (`parallel/spatial.py`): the ranks of a spatial group
get the same full-D rows, augment them alike (a D flip moves planes
across slabs, so it comes first), and each cuts its D-slab
(`cut_slab`, which holds the patch to the slab rule); the forward and
backward run in the slab's sharded-D context, and the gradients are
summed over the group before the data axis's mean.
"""

from __future__ import annotations

import collections
import json
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import bridge
from ..data.augment import augment_batch, draw_augment, rank_rows
from ..data.pipeline import (PatchGenerator, PatientCache, Prefetcher,
                             split_patients)
from ..metrics.dice import (class_indices_to_labels, class_logits_to_regions,
                            labels_to_regions, region_dice)
from ..metrics.losses import get_loss_fn
from ..models.unet import unet_depth
from ..ops import _cuda
from ..parallel import spatial
from ..parallel.mesh import Mesh, local_batch_size, make_mesh
from ..parallel.spatial import Slab
from ..utils.device import resolve_device
from ..utils.logging import MetricsLogger
from ..utils.params import count_params
from ..utils.profiling import annotate
from .checkpoint import (latest_checkpoint, load_checkpoint,
                         restore_train_state, save_checkpoint, train_state)
from .optim import (AdamW, bias_corrections, get_learning_rate,
                    host_divisor, make_optimizer, set_learning_rate)


def loss_and_grads(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor,
                   loss_fn: Callable, microbatch: int = 0
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, one gradient per parameter) of `loss_fn(model(x), y)`.

    `microbatch` > 0 and < B: the mean over k = B / microbatch slices, slice
    i holding samples i, i + k, … (the reference's strided grouping,
    `loop.py:111-144`); each slice runs its own forward and backward, so
    only one slice's activations are live at a time.  Each slice's
    forward (with the loss) and backward are the spans `step.forward` and
    `step.backward`."""
    params = list(model.parameters())
    for p in params:
        p.grad = None
    b = x.shape[0]
    if microbatch and microbatch < b:
        if b % microbatch:
            raise ValueError(f"microbatch={microbatch} must divide batch "
                             f"size {b}")
        k = b // microbatch
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(k):
            with annotate("step.forward"):
                loss_i = loss_fn(model(x[i::k]), y[i::k])
            with annotate("step.backward"):
                loss_i.backward()      # .grad sums the slices' gradients
            loss = loss + loss_i.detach()
        inv = float(np.float32(1.0 / k))
        grads = [p.grad.mul_(inv) for p in params]
        return loss * inv, grads
    with annotate("step.forward"):
        loss = loss_fn(model(x), y)
    with annotate("step.backward"):
        loss.backward()
    return loss.detach(), [p.grad for p in params]


def local_microbatch(microbatch: int, world: int) -> int:
    """Each rank's share of a global `microbatch`: microbatch / world, or
    0 (the full local batch, with a warning) where world does not divide
    it (`loop.py:316-333`)."""
    if world == 1 or not microbatch:
        return microbatch
    if microbatch % world:
        warnings.warn(
            f"train.microbatch={microbatch} is not a multiple of the data-"
            f"axis size {world}; taking the full-batch gradient (the same "
            "update, fp reduction order aside)")
        return 0
    return microbatch // world


def augmenter(augment: Optional[dict], gen: Optional[torch.Generator],
              mesh: Optional[Mesh] = None) -> Callable:
    """(x, y) → (x, y) flipped and jittered with draws from `gen`, which
    `augment` needs; identity when `augment` is None.  With a `mesh`, x is
    this data index's rows of the global batch: the draws are the global
    batch's, and the rank applies its own rows (`rank_rows`)."""
    if augment is None:
        return lambda x, y: (x, y)
    if gen is None:
        raise ValueError("augment needs a generator (gen=)")
    rank, world = (0, 1) if mesh is None else (mesh.data_rank,
                                                mesh.data_world)

    def apply(x, y):
        draws = draw_augment(gen, x.shape[0] * world, x.shape[-1], **augment)
        return augment_batch(x, y, *rank_rows(draws, rank, x.shape[0]))

    return apply


def cut_slab(slab: Optional[Slab], model: torch.nn.Module,
             *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This rank's D-slab of each full-D batch tensor (B, D, ...), after
    holding the patch to the slab rule at `model`'s depth; the tensors as
    they are without a slab."""
    if slab is None:
        return tensors
    spatial.check_slab(tensors[0].shape[1], slab.size, unet_depth(model))
    return tuple(slab.cut(t) for t in tensors)


def make_train_step(model: torch.nn.Module, opt: AdamW,
                    augment: Optional[dict] = None,
                    label_mode: str = "regions", microbatch: int = 0,
                    seed: int = 0, gen: Optional[torch.Generator] = None,
                    mesh: Optional[Mesh] = None):
    """(x, y) → fp32 loss; updates `model`'s parameters in place.

    `augment`: None, or dict(flip_prob=…, intensity_shift=…,
    intensity_scale=…).  `label_mode`: "regions" (y (B, D, H, W, 3)
    one-hots) or "classes" (y (B, D, H, W) class indices).  `microbatch`:
    0 = full-batch gradient, > 0 = the mean over microbatch slices.  The
    augmentation draws come from `gen`, a generator on the model's device
    that the caller keeps (a checkpoint saves its state), or, without one,
    from a new generator seeded with `seed`.  `mesh`: x and y are this
    data index's rows of the global batch (full D: under spatial sharding
    the step cuts this rank's slab), `microbatch` is the global one, and
    the gradients and the loss are averaged over the data axis (see the
    module docstring)."""
    return _step_body(model, opt, augment, label_mode, microbatch, seed, gen,
                      mesh)[0]


def _step_body(model, opt, augment, label_mode, microbatch, seed, gen, mesh):
    """(one, gen): `one(x, y)` is one train step (AdamW's `step`: the
    count advances, the scalars come from the host); `one(x, y, scalars)`
    takes (−lr, 1 − b1^t, 1 − b2^t) as 0-d tensors (AdamW's `update`).
    Spans: `train.step` ⊃ `train.augment`, the slices' `step.forward` and
    `step.backward`, `train.optim` (the all-reduce and AdamW)."""
    loss_fn = get_loss_fn(label_mode)
    if gen is None:
        gen = torch.Generator(device=next(model.parameters()).device)
        gen.manual_seed(seed)
    aug = augmenter(augment, gen, mesh)
    slab = None if mesh is None else mesh.slab
    if mesh is not None:
        microbatch = local_microbatch(microbatch, mesh.data_world)
    model.train()

    def one(x: torch.Tensor, y: torch.Tensor, scalars=None) -> torch.Tensor:
        with annotate("train.step"):
            with annotate("train.augment"):
                x, y = cut_slab(slab, model, *aug(x, y))
            with spatial.sharded_d(slab):
                loss, grads = loss_and_grads(model, x, y, loss_fn,
                                             microbatch)
            with annotate("train.optim"):
                if mesh is not None:
                    mesh.all_reduce_mean_([*grads, loss],
                                          slab_parts=len(grads))
                if scalars is None:
                    opt.step(grads)
                else:
                    opt.update(grads, *scalars)
            return loss

    return one, gen


def make_train_step_n(model: torch.nn.Module, opt: AdamW,
                      augment: Optional[dict] = None,
                      label_mode: str = "regions", microbatch: int = 0,
                      seed: int = 0, gen: Optional[torch.Generator] = None,
                      mesh: Optional[Mesh] = None, n: int = 2):
    """(xs, ys) → fp32 losses (n,): n train steps in one call, bit for bit
    n sequential `make_train_step` calls (the losses, every parameter,
    AdamW's moments and count, the generator's state).

    xs and ys hold n batches each: a tensor with a leading step axis or a
    sequence of n tensors, every call of one shape.  The arguments are
    `make_train_step`'s; `mesh` may only be a one-process one.  On the
    card the n steps are one CUDA graph (see the module docstring);
    `step_n.launches_at_capture` holds the kernel launches it recorded.
    The graph bakes in `opt.weight_decay` and reads `opt.lr` at every
    call.  Spans: `train.step_n` ⊃ `train.stage` (the batches and scalars
    copied in) and, on the card, `train.replay` (the capture at the first
    call, then the graph's launch); on the CPU the n `train.step`s."""
    if n < 1:
        raise ValueError(f"steps_per_call={n} must be at least 1")
    if mesh is not None and mesh.world > 1:
        raise ValueError(
            f"train.steps_per_call={n} runs on one process only, and every "
            f"rank of the port is a process (this mesh has {mesh.world}): "
            "the JAX package refuses n-step calls across processes too "
            "(its train/loop.py:365-369)")
    dev = next(model.parameters()).device
    one, gen = _step_body(model, opt, augment, label_mode, microbatch, seed,
                          gen, mesh)
    # −lr, then 1 − b1^t and 1 − b2^t (as `host_divisor` gives them) for
    # the call's n steps
    scalars = torch.zeros(1 + 2 * n, dtype=torch.float32, device=dev)
    staged: List[torch.Tensor] = []          # xs, ys: (n, *batch shape)

    def body(steps: int) -> torch.Tensor:
        return torch.stack([
            one(staged[0][i], staged[1][i],
                (scalars[0], scalars[1 + i], scalars[1 + n + i]))
            for i in range(steps)])

    def stage(xs, ys) -> None:
        if len(xs) != n or len(ys) != n:
            raise ValueError(f"steps_per_call={n} takes {n} batches, got "
                             f"{len(xs)} and {len(ys)}")
        if not staged:
            staged.extend(torch.empty((n, *b[0].shape), dtype=b[0].dtype,
                                      device=dev) for b in (xs, ys))
        for buf, batches in zip(staged, (xs, ys)):
            for i, b in enumerate(batches):
                if b.shape != buf.shape[1:] or b.dtype != buf.dtype:
                    raise ValueError(f"batch {tuple(b.shape)} {b.dtype}: "
                                     "the graph was staged for "
                                     f"{tuple(buf.shape[1:])} {buf.dtype}")
                buf[i].copy_(b)
        bc = [[host_divisor(c, dev) for c in bias_corrections(opt.count + i)]
              for i in range(1, n + 1)]
        host = np.array([-opt.lr, *(c[0] for c in bc), *(c[1] for c in bc)],
                        dtype=np.float32)
        scalars.copy_(torch.from_numpy(host))

    graphed: list = []                       # (graph, its output losses)

    def step_n(xs, ys) -> torch.Tensor:
        with annotate("train.step_n"):
            with annotate("train.stage"):
                stage(xs, ys)
            if dev.type == "cuda":
                with annotate("train.replay"):
                    if not graphed:
                        graphed.append(_capture(body, n, opt, gen,
                                                step_n.launches_at_capture))
                    graph, out = graphed[0]
                    graph.replay()
                losses = out.clone()
            else:
                losses = body(n)
            opt.count += n
            return losses

    step_n.launches_at_capture = collections.Counter()
    return step_n


def _capture(body: Callable[[int], torch.Tensor], n: int, opt: AdamW,
             gen: torch.Generator, launches: collections.Counter):
    """(graph, its output) of `body(n)` recorded on the card, after one
    warm-up step on a side stream; the parameters, moments, count and
    generator are then put back as they were.  `launches` receives the
    recorded kernel launches."""
    state = [*opt.params, *opt.mu, *opt.nu]
    saved = [t.detach().clone() for t in state]
    count, rng = opt.count, gen.get_state()
    dev = saved[0].device
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        body(1)
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    before = collections.Counter(_cuda.LAUNCHES)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = body(n)
    launches.update(collections.Counter(_cuda.LAUNCHES) - before)
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)
    opt.count = count
    gen.set_state(rng)
    return graph, out


def make_eval_step(model: torch.nn.Module, threshold: float = 0.5,
                   label_mode: str = "regions", mesh: Optional[Mesh] = None):
    """(x, y) → {"loss", "dice_wt", "dice_tc", "dice_et"} (0-d tensors).
    Dice is per BraTS region; in class mode the argmax decode is turned
    into regions first.  Under a `mesh` with spatial sharding, x and y are
    full-D rows: the step cuts this rank's slab, and the loss and Dice sum
    over the whole volume."""
    loss_fn = get_loss_fn(label_mode)
    slab = None if mesh is None else mesh.slab

    @torch.no_grad()
    def eval_step(x: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        x, y = cut_slab(slab, model, x, y)
        with spatial.sharded_d(slab):
            return metrics(x, y)

    def metrics(x, y):
        logits = model(x)
        loss = loss_fn(logits, y)
        if label_mode == "regions":
            pred = (torch.sigmoid(logits.float()) > threshold).float()
            true = y
        else:
            pred = class_logits_to_regions(logits)
            true = labels_to_regions(class_indices_to_labels(y))
        dice = region_dice(pred, true)
        return {"loss": loss, "dice_wt": dice[0], "dice_tc": dice[1],
                "dice_et": dice[2]}

    return eval_step


class PlateauController:
    """Host-side ReduceLROnPlateau on mean val dice (higher is better)."""

    def __init__(self, patience: int, factor: float, min_lr: float):
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.best = -np.inf
        self.bad_epochs = 0

    def update(self, metric: float, lr: float) -> Tuple[float, bool]:
        """Returns (new_lr, is_best)."""
        if metric > self.best:
            self.best = metric
            self.bad_epochs = 0
            return lr, True
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(lr * self.factor, self.min_lr), False
        return lr, False

    def state_dict(self) -> dict:
        return {"best": float(self.best), "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.bad_epochs = d["bad_epochs"]


def warn_stream_geometry_mismatch(meta: dict, logger: MetricsLogger,
                                  **current) -> None:
    """Warn when a resume's stream geometry (steps_per_epoch, val_steps)
    differs from the run that wrote the checkpoint: the counter-based data
    streams are positioned from the restored step, so such a resume is no
    longer trajectory-exact.  A warning, not an error: changing the
    geometry is a legitimate choice."""
    for key, now in current.items():
        was = meta.get(key)
        if was is not None and int(was) != int(now):
            msg = (f"resume with {key}={now} but the checkpoint was written "
                   f"with {key}={was}: the counter-based data streams are "
                   "positioned by the restored step, so this resume is NOT "
                   "trajectory-exact vs an uninterrupted run")
            warnings.warn(msg)
            logger.log(event="warn", msg=msg)


class Trainer:
    """Derived-model training loop: epochs of train steps from the patch
    pipeline, an eval per epoch driving the plateau LR, the best and the
    periodic checkpoints, and step-exact resume from the latest one.

    `net`: a `DerivedNet`, moved to `device` (None: the card); `cfg`: a
    `Config`; `data_paths`: the patients' `.npz` files (this rank's share,
    `dataset_paths`).  `device_augment`: flips and jitter inside the step,
    drawn from the Trainer's generator (saved in every checkpoint); False:
    the host augmentation of `PatchGenerator`.  `mesh`: the data axis
    (None: `make_mesh` from `cfg.parallel`); `data.batch_size` is the
    global batch, and `data_paths` the data index's share.
    `train.steps_per_call` n > 1: the epoch's steps go n at a time through
    `make_train_step_n` (one CUDA graph replay on the card); n must divide
    the epoch's steps, and the mesh must be one process."""

    def __init__(self, net: torch.nn.Module, cfg, data_paths: Sequence[str],
                 log_path: Optional[str] = None, device_augment: bool = True,
                 device: torch.device | str | None = None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.cfg = cfg
        tc, dc = cfg.train, cfg.data
        self.mesh = mesh or make_mesh(cfg.parallel.data_parallel,
                                      cfg.parallel.spatial_parallel)
        self.local_batch = local_batch_size(dc.batch_size,
                                            world=self.mesh.data_world)
        self.opt = make_optimizer(self.net.parameters(), tc.lr,
                                  tc.weight_decay)
        self.gen = torch.Generator(device=self.device)
        aug = (dict(flip_prob=dc.flip_prob,
                    intensity_shift=dc.intensity_shift,
                    intensity_scale=dc.intensity_scale)
               if device_augment else None)
        step_args = dict(augment=aug, label_mode=dc.label_mode,
                         microbatch=tc.microbatch, gen=self.gen,
                         mesh=self.mesh)
        self.steps_per_call = max(1, int(tc.steps_per_call))
        if self.steps_per_call > 1:
            self.train_step_n = make_train_step_n(
                self.net, self.opt, n=self.steps_per_call, **step_args)
        else:
            self.train_step = make_train_step(self.net, self.opt,
                                              **step_args)
        self.eval_step = make_eval_step(self.net, label_mode=dc.label_mode,
                                        mesh=self.mesh)
        self.plateau = PlateauController(tc.lr_patience, tc.lr_factor,
                                         tc.min_lr)
        self.logger = MetricsLogger(
            log_path, tb_dir=(os.path.join(tc.checkpoint_dir, "tb")
                              if tc.tensorboard else None))
        self.host_augment = not device_augment
        train_paths, val_paths = split_patients(data_paths, dc.val_fraction,
                                                dc.seed)
        self.train_cache = PatientCache(train_paths, dc.label_mode)
        self.val_cache = PatientCache(val_paths or train_paths,
                                      dc.label_mode)
        self.step = 0
        self._resume_meta: dict = {}
        # per-epoch (lr, mean_dice, is_best)
        self.history: list = []

    def init_state(self, seed: int) -> None:
        """Parameters at flax's initialiser scales from `seed`, a fresh
        AdamW state, the augmentation generator seeded with `seed`."""
        bridge.load_flax_params(self.net,
                                bridge.random_flax_params(self.net, seed))
        tc = self.cfg.train
        for m in self.opt.mu + self.opt.nu:
            m.zero_()
        self.opt.count, self.opt.lr = 0, tc.lr
        self.gen.manual_seed(seed)
        self.step = 0

    def state(self) -> Dict[str, np.ndarray]:
        """The training state as a checkpoint's arrays."""
        return train_state(self.net, self.opt, self.step, self.gen)

    def resume_or_init(self, seed: int) -> None:
        self.init_state(seed)
        self._resume_meta = {}
        tc = self.cfg.train
        ckpt = latest_checkpoint(tc.checkpoint_dir)
        if ckpt is None:
            return
        step, path = ckpt
        self.step = restore_train_state(load_checkpoint(path), self.net,
                                        self.opt, self.gen)
        # the plateau controller too, or the first epoch after a resume
        # always looks like a new best and can overwrite the true best
        meta_path = os.path.join(tc.checkpoint_dir, "metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self._resume_meta = json.load(f)
            if "plateau" in self._resume_meta:
                self.plateau.load_state_dict(self._resume_meta["plateau"])
        self.logger.log(event="resume", step=step, path=path)

    def sync_state(self) -> None:
        """Every rank takes rank 0's parameters and AdamW moments."""
        self.mesh.broadcast_([*self.net.parameters(), *self.opt.mu,
                              *self.opt.nu])

    def _generators(self, seed: int) -> Tuple[PatchGenerator,
                                              PatchGenerator]:
        """This rank's train and val streams, `local_batch` rows a batch.
        A data index's seeds are offset by 100003·(data index)
        (`loop.py:355-365`), so no two row sets' streams meet, the ranks of
        a spatial group read the same patches, and rank 0 keeps the
        one-process ones."""
        dc = self.cfg.data
        seed = seed + 100003 * self.mesh.data_rank
        gtrain = PatchGenerator(self.train_cache, dc.patch_size,
                                self.local_batch, seed=seed,
                                augment=self.host_augment,
                                flip_prob=dc.flip_prob,
                                intensity_shift=dc.intensity_shift,
                                intensity_scale=dc.intensity_scale)
        gval = PatchGenerator(self.val_cache, dc.patch_size,
                              self.local_batch, seed=seed + 1,
                              augment=False)
        return gtrain, gval

    def train(self, epochs: Optional[int] = None,
              steps_per_epoch: Optional[int] = None,
              val_steps: int = 8) -> Dict[str, np.ndarray]:
        """Train to `epochs` (default `train.epochs`), resuming from the
        latest checkpoint; returns the final state (`state()`)."""
        tc, dc = self.cfg.train, self.cfg.data
        epochs = tc.epochs if epochs is None else epochs
        steps_per_epoch = tc.steps_per_epoch if steps_per_epoch is None \
            else steps_per_epoch
        n_call = self.steps_per_call
        if steps_per_epoch % n_call:
            raise ValueError(
                f"train.steps_per_call={n_call} must divide steps_per_epoch="
                f"{steps_per_epoch}: an epoch is a whole number of n-step "
                "calls (a remainder would need a second graph)")
        self.resume_or_init(tc.seed)
        self.sync_state()
        warn_stream_geometry_mismatch(self._resume_meta, self.logger,
                                      steps_per_epoch=steps_per_epoch,
                                      val_steps=val_steps)
        self.logger.log(event="model", params=count_params(self.net))
        start_epoch = self.step // steps_per_epoch
        # counter-based streams positioned by the restored step: a resumed
        # run consumes the batches an uninterrupted one would
        gtrain, gval = self._generators(tc.seed)
        gtrain.set_step(self.step)
        gval.set_step(start_epoch * val_steps)
        prefetch = Prefetcher(gtrain, self.device, depth=2)
        try:
            for epoch in range(start_epoch, epochs):
                t0 = time.perf_counter()
                losses = []
                for _ in range(steps_per_epoch // n_call):
                    if n_call == 1:
                        x, y = prefetch.next()
                        losses.append(self.train_step(x, y))
                    else:
                        # n prefetched batches, staged into the graph's
                        # static buffers by the call
                        xs, ys = zip(*(prefetch.next()
                                       for _ in range(n_call)))
                        losses.extend(self.train_step_n(xs, ys).unbind())
                    self.step += n_call
                losses[-1].item()           # waits for the epoch's steps
                pps = steps_per_epoch * dc.batch_size \
                    / (time.perf_counter() - t0)

                val = self.evaluate(gval, val_steps)
                mean_dice = float(np.mean([val["dice_wt"], val["dice_tc"],
                                           val["dice_et"]]))
                lr = get_learning_rate(self.opt)
                new_lr, is_best = self.plateau.update(mean_dice, lr)
                if new_lr != lr:
                    set_learning_rate(self.opt, new_lr)
                self.history.append({"epoch": epoch, "mean_dice": mean_dice,
                                     "lr": new_lr, "is_best": is_best})
                self.logger.log(
                    event="epoch", epoch=epoch,
                    train_loss=float(np.mean([l.item() for l in losses])),
                    val_loss=val["loss"], dice_wt=val["dice_wt"],
                    dice_tc=val["dice_tc"], dice_et=val["dice_et"],
                    mean_dice=mean_dice, lr=new_lr, patches_per_sec=pps)
                if (epoch + 1) % tc.checkpoint_every == 0 or is_best:
                    save_checkpoint(
                        tc.checkpoint_dir, self.step, self.state(),
                        metadata={"epoch": epoch, "mean_dice": mean_dice,
                                  "plateau": self.plateau.state_dict(),
                                  "steps_per_epoch": steps_per_epoch,
                                  "val_steps": val_steps,
                                  "config": self.cfg.to_dict()},
                        best=is_best)
        finally:
            prefetch.close()
        return self.state()

    def evaluate(self, gval: PatchGenerator,
                 val_steps: int) -> Dict[str, float]:
        """Mean loss and per-region Dice over `val_steps` batches."""
        return evaluate(self.eval_step, gval, val_steps, self.device,
                        self.mesh)


def evaluate(eval_step: Callable, gen: PatchGenerator, val_steps: int,
             device: torch.device, mesh: Mesh) -> Dict[str, float]:
    """The mean of each of `eval_step`'s metrics over `val_steps` batches
    of `gen`, then over the data axis (each row set's mean weighs the
    same: every rank evaluates `val_steps` batches of the same size)."""
    accum: Dict[str, list] = {}
    for _ in range(val_steps):
        x, y = gen.next()
        m = eval_step(torch.from_numpy(x).to(device),
                      torch.from_numpy(y).to(device))
        for k, v in m.items():
            accum.setdefault(k, []).append(float(v))
    out = {k: float(np.mean(v)) for k, v in accum.items()}
    if mesh.world > 1:
        vals = torch.tensor(list(out.values()), dtype=torch.float64,
                            device=device)
        out = dict(zip(out, mesh.all_reduce_mean_([vals])[0].tolist()))
    return out
