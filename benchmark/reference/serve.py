"""The plain reference of whole-volume serving: sliding windows, the
stitch and the label decode, fp32 on the device, float64 sums.

The volume is end-padded with zeros to at least one window on each axis;
windows start every round(p·(1 − overlap)) voxels, with one more window
flush with the end where the stride does not reach it.  Each voxel's
region probability is the mean of the sigmoid outputs of the windows that
cover it; a region fires where that mean exceeds the threshold, and the
BraTS label is 4 where ET fires, else 1 where TC and WT fire, else 2
where WT fires, else 0.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from .net import Net, Params


def starts(n: int, patch: int, stride: int) -> list:
    out = list(range(0, n - patch + 1, stride))
    if out[-1] != n - patch:
        out.append(n - patch)
    return out


def windows(shape, patch: int, overlap: float) -> list:
    """The window origins of a (D, H, W) volume once padded to `patch`."""
    stride = max(1, int(round(patch * (1.0 - overlap))))
    return list(itertools.product(
        *(starts(max(n, patch), patch, stride) for n in shape)))


@torch.no_grad()
def labels(net: Net, params: Params, volume: torch.Tensor, patch: int,
           overlap: float, threshold: float, batch: int = 2,
           skip=None) -> np.ndarray:
    """(D, H, W) uint8 labels of a (D, H, W, C) fp32 volume on the
    device.  `skip(j)` True leaves the j-th window of each batch out of
    the stitch (a planted fault; a voxel no window covers is 0)."""
    d, h, w = volume.shape[:3]
    pad = [max(0, patch - n) for n in (d, h, w)]
    vol = F.pad(volume, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    shape = vol.shape[:3]
    sums = torch.zeros((*shape, 3), dtype=torch.float64, device=vol.device)
    cnts = torch.zeros((*shape, 1), dtype=torch.float64, device=vol.device)
    origins = windows((d, h, w), patch, overlap)
    for i in range(0, len(origins), batch):
        group = origins[i:i + batch]
        x = torch.stack([vol[a:a + patch, b:b + patch, c:c + patch]
                         for a, b, c in group])
        probs = torch.sigmoid(net.forward(params, x)).double()
        for j, ((a, b, c), pr) in enumerate(zip(group, probs)):
            if skip is not None and skip(j):
                continue
            sums[a:a + patch, b:b + patch, c:c + patch] += pr
            cnts[a:a + patch, b:b + patch, c:c + patch] += 1
    fire = (sums / cnts)[:d, :h, :w] > threshold
    wt, tc, et = fire[..., 0], fire[..., 1], fire[..., 2]
    out = torch.where(et, 4, torch.where(tc & wt, 1, torch.where(wt, 2, 0)))
    return out.to(torch.uint8).cpu().numpy()
