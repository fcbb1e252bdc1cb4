"""Derived-model training: the step, eval step, plateau LR and the Trainer.

Counterpart of `nas_3d_unet_tpu/train/loop.py`: `make_train_step`
(:81-181), `make_eval_step` (:213-236), `PlateauController` (:239-266),
`warn_stream_geometry_mismatch` (:269) and `Trainer` (:294).
A step: augment the full batch (draws from the step's generator), take the
gradient over the full batch or as the mean over strided microbatch slices
(sample j goes to slice j % k), then one AdamW update, in place.

The model runs eagerly, so the step is a Python function over the model's
own parameters; there is no jit, donation or scan.  Entry points run where
the model's parameters are: on the card unless the caller put the model on
the CPU.  The Trainer runs on one device (no mesh, no multi-host, no
`steps_per_call` scan).
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import bridge
from ..data.augment import augment_batch, draw_augment
from ..data.pipeline import (PatchGenerator, PatientCache, Prefetcher,
                             split_patients)
from ..metrics.dice import (class_indices_to_labels, class_logits_to_regions,
                            labels_to_regions, region_dice)
from ..metrics.losses import get_loss_fn
from ..utils.device import resolve_device
from ..utils.logging import MetricsLogger
from ..utils.params import count_params
from .checkpoint import (latest_checkpoint, load_checkpoint,
                         restore_train_state, save_checkpoint, train_state)
from .optim import (AdamW, get_learning_rate, make_optimizer,
                    set_learning_rate)


def loss_and_grads(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor,
                   loss_fn: Callable, microbatch: int = 0
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, one gradient per parameter) of `loss_fn(model(x), y)`.

    `microbatch` > 0 and < B: the mean over k = B / microbatch slices, slice
    i holding samples i, i + k, … (the reference's strided grouping,
    `loop.py:111-144`); each slice runs its own forward and backward, so
    only one slice's activations are live at a time."""
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
            loss_i = loss_fn(model(x[i::k]), y[i::k])
            loss_i.backward()          # .grad sums the slices' gradients
            loss = loss + loss_i.detach()
        inv = float(np.float32(1.0 / k))
        grads = [p.grad.mul_(inv) for p in params]
        return loss * inv, grads
    loss = loss_fn(model(x), y)
    loss.backward()
    return loss.detach(), [p.grad for p in params]


def make_train_step(model: torch.nn.Module, opt: AdamW,
                    augment: Optional[dict] = None,
                    label_mode: str = "regions", microbatch: int = 0,
                    seed: int = 0, gen: Optional[torch.Generator] = None):
    """(x, y) → fp32 loss; updates `model`'s parameters in place.

    `augment`: None, or dict(flip_prob=…, intensity_shift=…,
    intensity_scale=…).  `label_mode`: "regions" (y (B, D, H, W, 3)
    one-hots) or "classes" (y (B, D, H, W) class indices).  `microbatch`:
    0 = full-batch gradient, > 0 = the mean over microbatch slices.  The
    augmentation draws come from `gen`, a generator on the model's device
    that the caller keeps (a checkpoint saves its state), or, without one,
    from a new generator seeded with `seed`."""
    loss_fn = get_loss_fn(label_mode)
    if gen is None:
        gen = torch.Generator(device=next(model.parameters()).device)
        gen.manual_seed(seed)
    model.train()

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if augment is not None:
            draws = draw_augment(gen, x.shape[0], x.shape[-1], **augment)
            x, y = augment_batch(x, y, *draws)
        loss, grads = loss_and_grads(model, x, y, loss_fn, microbatch)
        opt.step(grads)
        return loss

    return step


def make_eval_step(model: torch.nn.Module, threshold: float = 0.5,
                   label_mode: str = "regions"):
    """(x, y) → {"loss", "dice_wt", "dice_tc", "dice_et"} (0-d tensors).
    Dice is per BraTS region; in class mode the argmax decode is turned
    into regions first."""
    loss_fn = get_loss_fn(label_mode)

    @torch.no_grad()
    def eval_step(x: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
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
    `Config`; `data_paths`: the patients' `.npz` files.
    `device_augment`: flips and jitter inside the step, drawn from the
    Trainer's generator (saved in every checkpoint); False: the host
    augmentation of `PatchGenerator`."""

    def __init__(self, net: torch.nn.Module, cfg, data_paths: Sequence[str],
                 log_path: Optional[str] = None, device_augment: bool = True,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.cfg = cfg
        tc, dc = cfg.train, cfg.data
        self.opt = make_optimizer(self.net.parameters(), tc.lr,
                                  tc.weight_decay)
        self.gen = torch.Generator(device=self.device)
        aug = (dict(flip_prob=dc.flip_prob,
                    intensity_shift=dc.intensity_shift,
                    intensity_scale=dc.intensity_scale)
               if device_augment else None)
        self.train_step = make_train_step(self.net, self.opt, augment=aug,
                                          label_mode=dc.label_mode,
                                          microbatch=tc.microbatch,
                                          gen=self.gen)
        self.eval_step = make_eval_step(self.net, label_mode=dc.label_mode)
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

    def _generators(self, seed: int) -> Tuple[PatchGenerator,
                                              PatchGenerator]:
        dc = self.cfg.data
        gtrain = PatchGenerator(self.train_cache, dc.patch_size,
                                dc.batch_size, seed=seed,
                                augment=self.host_augment,
                                flip_prob=dc.flip_prob,
                                intensity_shift=dc.intensity_shift,
                                intensity_scale=dc.intensity_scale)
        gval = PatchGenerator(self.val_cache, dc.patch_size, dc.batch_size,
                              seed=seed + 1, augment=False)
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
        self.resume_or_init(tc.seed)
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
                for _ in range(steps_per_epoch):
                    x, y = prefetch.next()
                    losses.append(self.train_step(x, y))
                    self.step += 1
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
        accum: Dict[str, list] = {}
        for _ in range(val_steps):
            x, y = gval.next()
            m = self.eval_step(torch.from_numpy(x).to(self.device),
                               torch.from_numpy(y).to(self.device))
            for k, v in m.items():
                accum.setdefault(k, []).append(float(v))
        return {k: float(np.mean(v)) for k, v in accum.items()}
