"""Derived-model training step, eval step and plateau LR, in PyTorch.

Counterpart of `nas_3d_unet_tpu/train/loop.py`: `make_train_step`
(:81-181), `make_eval_step` (:213-236) and `PlateauController` (:239-266).
A step: augment the full batch (draws from the step's generator), take the
gradient over the full batch or as the mean over strided microbatch slices
(sample j goes to slice j % k), then one AdamW update, in place.

The model runs eagerly, so the step is a Python function over the model's
own parameters; there is no jit, donation or scan.  Entry points run where
the model's parameters are: on the card unless the caller put the model on
the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.augment import augment_batch, draw_augment
from ..metrics.dice import (class_indices_to_labels, class_logits_to_regions,
                            labels_to_regions, region_dice)
from ..metrics.losses import get_loss_fn
from .optim import AdamW


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
                    seed: int = 0):
    """(x, y) → fp32 loss; updates `model`'s parameters in place.

    `augment`: None, or dict(flip_prob=…, intensity_shift=…,
    intensity_scale=…).  `label_mode`: "regions" (y (B, D, H, W, 3)
    one-hots) or "classes" (y (B, D, H, W) class indices).  `microbatch`:
    0 = full-batch gradient, > 0 = the mean over microbatch slices.  The
    augmentation draws come from a generator on the model's device seeded
    with `seed`."""
    loss_fn = get_loss_fn(label_mode)
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
