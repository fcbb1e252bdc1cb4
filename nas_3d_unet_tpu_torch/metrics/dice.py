"""BraTS label ↔ region mapping and hard region Dice, in PyTorch.

Counterpart of `nas_3d_unet_tpu/metrics/dice.py` (:31-77, :187-206), with
the numpy label helpers of the patch pipeline (:42, :56).

BraTS labels: 0 background, 1 necrotic/non-enhancing core, 2 edema,
4 enhancing tumor.  Nested regions, in channel order: WT = {1, 2, 4},
TC = {1, 4}, ET = {4}.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import spatial

REGIONS = ("WT", "TC", "ET")


def labels_to_regions(labels: torch.Tensor) -> torch.Tensor:
    """BraTS label volume (...) → region one-hot (..., 3) float32."""
    wt = labels > 0
    tc = (labels == 1) | (labels == 4)
    et = labels == 4
    return torch.stack([wt, tc, et], dim=-1).float()


def labels_to_regions_np(labels: np.ndarray) -> np.ndarray:
    """numpy twin of `labels_to_regions` for the host collate path: raw
    uint8 labels → fp32 0/1 region one-hots (..., 3), exact."""
    wt = (labels > 0).astype(np.float32)
    tc = ((labels == 1) | (labels == 4)).astype(np.float32)
    et = (labels == 4).astype(np.float32)
    return np.stack([wt, tc, et], axis=-1)


def labels_to_class_indices_np(labels: np.ndarray) -> np.ndarray:
    """BraTS labels {0,1,2,4} → int32 class indices {0,1,2,3}."""
    return np.where(labels == 4, 3, labels).astype(np.int32)


def region_masks_to_labels(wt: torch.Tensor, tc: torch.Tensor,
                           et: torch.Tensor) -> torch.Tensor:
    """Nested decode of boolean WT/TC/ET masks → BraTS labels (uint8): ET
    fires → 4; else TC (within WT) → 1; else WT → 2; else 0."""
    out = torch.where(et, 4, torch.where(tc & wt, 1, torch.where(wt, 2, 0)))
    return out.to(torch.uint8)


def regions_to_labels(region_probs: torch.Tensor,
                      threshold: float = 0.5) -> torch.Tensor:
    """Region probabilities (..., 3) → BraTS labels (uint8)."""
    fire = region_probs > threshold
    return region_masks_to_labels(fire[..., 0], fire[..., 1], fire[..., 2])


def class_indices_to_labels(idx: torch.Tensor) -> torch.Tensor:
    """Class indices {0..3} → BraTS labels (index 3 is label 4), uint8."""
    return torch.where(idx == 3, 4, idx).to(torch.uint8)


def class_logits_to_regions(logits: torch.Tensor) -> torch.Tensor:
    """Class logits (..., 4) → hard region one-hots (..., 3) by argmax."""
    return labels_to_regions(class_indices_to_labels(logits.argmax(dim=-1)))


def region_dice(pred_regions: torch.Tensor, true_regions: torch.Tensor,
                eps: float = 1e-7) -> torch.Tensor:
    """Hard Dice per region channel, (3,) float32; 1.0 where both masks are
    empty (the BraTS convention for an absent ET).  On a D-slab
    (`parallel/spatial.py`) the sums are the whole volume's."""
    c = pred_regions.shape[-1]
    p = pred_regions.float().reshape(-1, c)
    y = true_regions.float().reshape(-1, c)
    slab = spatial.current()
    if slab is None:
        inter = (p * y).sum(0)
        denom = p.sum(0) + y.sum(0)
    else:
        inter, sp, sy = spatial.all_reduce_sums(
            [(p * y).sum(0), p.sum(0), y.sum(0)], slab)
        denom = sp + sy
    return torch.where(denom > 0, 2.0 * inter / (denom + eps),
                       torch.ones_like(denom))
