"""Training losses, in PyTorch.

Counterpart of `nas_3d_unet_tpu/metrics/dice.py:86-177` in the unpacked
form (the JAX package's `_dice_ce_loss_packed` is a TPU lane device with the
same math).  Everything is computed in fp32 whatever the logits' dtype.

On a D-slab (`parallel/spatial.py`) the Dice sums Σpy, Σp, Σy and the
cross-entropy's sum are summed over the spatial group (`spatial_sum`)
and the mean divides by the global voxel count: every rank of the group
holds the same loss, and its gradient holds its own slab's terms.  The
sum's backward is the identity, or, on a slab under the exact convention
(the second-order search step, which seeds each rank's loss with
1/size), the sum of the cotangents over the group: that module's
docstring says why the second-order graph needs it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import spatial

SMOOTH = 1.0


def _flatten_spatial(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) → (B, V, C) in fp32."""
    return x.float().reshape(x.shape[0], -1, x.shape[-1])


def soft_dice_loss(probs: torch.Tensor, targets: torch.Tensor,
                   smooth: float = SMOOTH) -> torch.Tensor:
    """Smoothed soft Dice loss, mean over batch and channels:
    1 − (2·Σpy + s) / (Σp + Σy + s), sums over voxels per (b, c)."""
    p = _flatten_spatial(probs)
    y = _flatten_spatial(targets)
    slab = spatial.current()
    if slab is None:
        inter = (p * y).sum(1)
        denom = p.sum(1) + y.sum(1)
    else:
        inter, sp, sy = spatial.spatial_sum(
            torch.stack([(p * y).sum(1), p.sum(1), y.sum(1)]), slab)
        denom = sp + sy
    dice = (2.0 * inter + smooth) / (denom + smooth)
    return (1.0 - dice).mean()


def _mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of t's elements; on a slab over the whole volume's."""
    slab = spatial.current()
    if slab is None:
        return t.mean()
    return spatial.spatial_sum(t.sum(), slab) / (t.numel() * slab.size)


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, written as optax writes it:
    −y·log σ(z) − (1 − y)·log σ(−z)."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


def dice_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                 smooth: float = SMOOTH) -> torch.Tensor:
    """Dice + BCE on sigmoid region logits (B, D, H, W, 3) against region
    one-hots of the same shape."""
    logits32 = logits.float()
    dice = soft_dice_loss(torch.sigmoid(logits32), targets, smooth)
    bce = _mean(sigmoid_binary_cross_entropy(logits32, targets.float()))
    return dice + bce


def softmax_dice_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                         smooth: float = SMOOTH) -> torch.Tensor:
    """Dice + CE for class indices: logits (B, D, H, W, K), labels
    (B, D, H, W) int in {0..K-1}."""
    k = logits.shape[-1]
    logits32 = logits.float()
    onehot = F.one_hot(labels.long(), k).float()
    dice = soft_dice_loss(torch.softmax(logits32, dim=-1), onehot, smooth)
    ce = _mean(-(onehot * torch.log_softmax(logits32, dim=-1)).sum(-1))
    return dice + ce


def get_loss_fn(label_mode: str):
    """"regions" → `dice_ce_loss`; "classes" → `softmax_dice_ce_loss`."""
    if label_mode == "regions":
        return dice_ce_loss
    if label_mode == "classes":
        return softmax_dice_ce_loss
    raise ValueError(f"unknown label_mode {label_mode!r}")
