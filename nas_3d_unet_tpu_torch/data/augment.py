"""Device-side augmentation of a training batch, in PyTorch.

Counterpart of `nas_3d_unet_tpu/data/pipeline.py:219-243` `augment_batch`:
per-sample flips along each spatial axis, and per-sample, per-modality
intensity jitter `x·scale + shift`.  The random draws are inputs here, so a
test can hand in the very draws JAX made; `draw_augment` makes them from a
`torch.Generator` in the reference's order and ranges (flip mask, shift,
then scale).  JAX's random streams are not reproduced.

Under data parallelism every rank draws the global batch's augmentation
from the same generator state and applies its own rows (`rank_rows`): the
augmented global batch is the one-process one, and the ranks' generators
stay in lockstep, so one checkpointed state serves them all.
"""

from __future__ import annotations

from typing import Tuple

import torch


def draw_augment(gen: torch.Generator, batch: int, channels: int,
                 flip_prob: float = 0.5, intensity_shift: float = 0.1,
                 intensity_scale: float = 0.1
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flip (B, 3) bool, shift (B, 1, 1, 1, C), scale (B, 1, 1, 1, C)) on
    the generator's device: shift ~ U(−s, s), scale ~ 1 + U(−c, c)."""
    dev = gen.device
    flip = torch.rand((batch, 3), generator=gen, device=dev) < flip_prob
    shape = (batch, 1, 1, 1, channels)
    shift = (torch.rand(shape, generator=gen, device=dev) * 2 - 1) \
        * intensity_shift
    scale = 1.0 + (torch.rand(shape, generator=gen, device=dev) * 2 - 1) \
        * intensity_scale
    return flip, shift, scale


def augment_batch(x: torch.Tensor, y: torch.Tensor, flip: torch.Tensor,
                  shift: torch.Tensor, scale: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, D, H, W, C), y (B, D, H, W, ...) → flipped x·scale + shift and
    flipped y.  Branch-free, so the mask never leaves the device."""
    xs, ys = [], []
    for i in range(x.shape[0]):
        img, lab = x[i], y[i]
        for axis in range(3):
            f = flip[i, axis]
            img = torch.where(f, img.flip(axis), img)
            lab = torch.where(f, lab.flip(axis), lab)
        xs.append(img)
        ys.append(lab)
    return torch.stack(xs) * scale.to(x.dtype) + shift.to(x.dtype), \
        torch.stack(ys)


def rank_rows(draws: Tuple[torch.Tensor, ...], rank: int,
              rows: int) -> Tuple[torch.Tensor, ...]:
    """Rank `rank`'s `rows` consecutive rows of global-batch draws: the
    rows of the global batch that rank holds."""
    return tuple(t[rank * rows:(rank + 1) * rows] for t in draws)
