"""Sliding-window whole-volume inference with overlap stitching, in PyTorch.

Counterpart of `nas_3d_unet_tpu/infer/sliding.py`.  The volume is covered by
a grid of overlapping patches; batches of patches run through the model and
their probabilities are accumulated into per-voxel sums and visit counts on
the model's device, then divided once.

The fp32 contract is the reference's: accumulation in fixed grid order, one
in-place `sums += w·probs[i]` / `cnts += w` per patch, in a Python loop (no
atomics, no reordering), and a single divide at the end.  Padded grid entries
(filling the last batch) carry weight 0.0, whose products add exactly zero.
The stitched probabilities therefore equal, bit for bit, a sequential numpy
loop fed the same per-patch probabilities.

Under spatial sharding (`parallel/mesh.py`, the reference's
`volume_sharding`, `infer/sliding.py:68-83`) every rank of a spatial group
runs the same patch batches in the same order, keeps only its D-slab of
the sum and count buffers, decodes that slab, and the label slabs are
gathered in D order: the per-voxel arithmetic is the one-process one, so
the labels are bit-identical.  At BraTS sizes both windows along D overlap
every slab, so this shards the buffers' memory, not the work.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..metrics.dice import class_indices_to_labels, region_masks_to_labels
from ..parallel.mesh import Mesh
from ..parallel.spatial import Slab
from ..utils.device import resolve_device
from ..utils.precision import strict_fp32


def grid_starts(dim: int, patch: int, stride: int) -> List[int]:
    """1-D window start positions: stride steps, final window end-aligned."""
    if dim < patch:
        raise ValueError(f"dim {dim} < patch {patch}; pad the volume first")
    starts = list(range(0, dim - patch + 1, max(1, stride)))
    if starts[-1] != dim - patch:
        starts.append(dim - patch)
    return starts


def grid_coords(shape: Sequence[int], patch: Sequence[int],
                stride: Sequence[int]) -> np.ndarray:
    """(N, 3) int32 patch start coordinates in scan order (D, H, W)."""
    ds = grid_starts(shape[0], patch[0], stride[0])
    hs = grid_starts(shape[1], patch[1], stride[1])
    ws = grid_starts(shape[2], patch[2], stride[2])
    coords = [(d, h, w) for d in ds for h in hs for w in ws]
    return np.asarray(coords, dtype=np.int32)


def _stitch_sums(forward_fn: Callable[[torch.Tensor], torch.Tensor], volume,
                 patch_size: Sequence[int], overlap: float, batch_size: int,
                 num_classes: int, device: torch.device,
                 slab: Optional[Slab] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int, int],
                            int]:
    """Pad, grid, batch, accumulate: (sums, cnts) on `device`, the
    unpadded volume shape and the first plane the buffers hold: 0, or with
    a `slab` the start of its share (⌈D/size⌉ planes a slab, of the padded
    D) of every patch's planes."""
    vol = torch.as_tensor(volume, dtype=torch.float32, device=device)
    orig_shape = tuple(vol.shape[:3])
    patch = tuple(int(p) for p in patch_size)
    stride = tuple(max(1, int(round(p * (1.0 - overlap)))) for p in patch)

    # pad (end-only) so every dim fits at least one patch
    pad = [max(0, p - s) for p, s in zip(patch, orig_shape)]
    if any(pad):
        vol = F.pad(vol, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    shape = tuple(vol.shape[:3])

    coords = grid_coords(shape, patch, stride).tolist()
    n = len(coords)
    n_pad = math.ceil(n / batch_size) * batch_size - n
    weights = [1.0] * n + [0.0] * n_pad
    coords += [coords[-1]] * n_pad

    d0, d1 = 0, shape[0]
    if slab is not None:
        n_slab = -(-shape[0] // slab.size)
        d0 = min(shape[0], slab.index * n_slab)
        d1 = min(shape[0], d0 + n_slab)
    sums = torch.zeros((d1 - d0, *shape[1:], num_classes),
                       dtype=torch.float32, device=device)
    cnts = torch.zeros((d1 - d0, *shape[1:], 1), dtype=torch.float32,
                       device=device)
    pd, ph, pw = patch
    for j in range(0, len(coords), batch_size):
        cs = coords[j:j + batch_size]
        patches = torch.stack([vol[d:d + pd, h:h + ph, w:w + pw]
                               for d, h, w in cs])
        probs = forward_fn(patches).float()
        for i, (d, h, w) in enumerate(cs):
            a, b = max(d, d0), min(d + pd, d1)     # the patch's planes here
            if a >= b:
                continue
            wgt = weights[j + i]
            sl = (slice(a - d0, b - d0), slice(h, h + ph), slice(w, w + pw))
            sums[sl] += wgt * probs[i, a - d:b - d]
            cnts[sl] += wgt
    return sums, cnts, orig_shape, d0


def sliding_window_probs(forward_fn, volume, patch_size: Sequence[int],
                         overlap: float = 0.5, batch_size: int = 4,
                         num_classes: int = 3,
                         device: torch.device | str | None = None
                         ) -> np.ndarray:
    """Whole-volume averaged probabilities, (D, H, W, K) fp32 numpy.

    `forward_fn` maps a patch batch (B, p, p, p, C) to probabilities
    (B, p, p, p, K).  `volume` is the (D, H, W, C) image, numpy or tensor.
    The divide runs once, on the host, as in the reference.  `device`
    None means the card (`resolve_device`)."""
    sums, cnts, (d, h, w), _ = _stitch_sums(forward_fn, volume, patch_size,
                                            overlap, batch_size, num_classes,
                                            resolve_device(device))
    probs = sums.cpu().numpy() / cnts.cpu().numpy()
    return probs[:d, :h, :w]


def decode_labels(sums: torch.Tensor, cnts: torch.Tensor, threshold: float,
                  label_mode: str, crop: Tuple[int, int, int]) -> torch.Tensor:
    """Label decode on the stitch's device, (D, H, W) uint8.

    regions: a region fires where `sums > threshold·cnts` — for 0.5 the
    product is exact in fp32, so this is the exact predicate mean > t.
    classes: argmax of the sums (the count is class-independent), then
    index 3 → label 4."""
    d, h, w = crop
    sums = sums[:d, :h, :w]
    cnts = cnts[:d, :h, :w]
    if label_mode == "classes":
        return class_indices_to_labels(sums.argmax(dim=-1))
    fire = sums > threshold * cnts
    return region_masks_to_labels(fire[..., 0], fire[..., 1], fire[..., 2])


def sliding_window_labels(forward_fn, volume, patch_size: Sequence[int],
                          overlap: float = 0.5, batch_size: int = 4,
                          num_classes: int = 3,
                          device: torch.device | str | None = None,
                          threshold: float = 0.5,
                          label_mode: str = "regions",
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Whole-volume BraTS labels decoded on `device`, (D, H, W) uint8: only
    the 1-byte label volume needs to leave the device.  Under a `mesh`
    with spatial sharding this rank stitches and decodes its D-slab, and
    the group's label slabs are gathered in D order."""
    device = resolve_device(device)
    slab = None if mesh is None else mesh.slab
    sums, cnts, (d, h, w), d0 = _stitch_sums(
        forward_fn, volume, patch_size, overlap, batch_size, num_classes,
        device, slab)
    if slab is None:
        return decode_labels(sums, cnts, threshold, label_mode, (d, h, w))
    mine = decode_labels(sums, cnts, threshold, label_mode,
                         (max(0, min(d - d0, sums.shape[0])), h, w))
    parts = mesh.spatial_gather(mine.cpu().numpy())
    return torch.from_numpy(np.concatenate(parts)).to(device)


class SlidingWindowPredictor:
    """Binds a model to the sliding-window settings.

    `label_mode`: "regions" → sigmoid region probabilities (K = 3);
    "classes" → softmax class probabilities (K = 4).  The model runs on its
    own device under `torch.inference_mode()` and `strict_fp32()`."""

    def __init__(self, model: torch.nn.Module, patch_size, overlap=0.5,
                 batch_size=2, num_classes=3, label_mode="regions"):
        if label_mode not in ("regions", "classes"):
            raise ValueError(f"unknown label_mode {label_mode!r}")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.patch_size = tuple(patch_size)
        self.overlap = overlap
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.label_mode = label_mode

    def forward_probs(self, patches: torch.Tensor) -> torch.Tensor:
        logits = self.model(patches).float()
        if self.label_mode == "classes":
            return torch.softmax(logits, dim=-1)
        return torch.sigmoid(logits)

    def predict_volume(self, volume) -> np.ndarray:
        """(D, H, W, K) fp32 probabilities on the host."""
        with torch.inference_mode(), strict_fp32():
            return sliding_window_probs(
                self.forward_probs, volume, self.patch_size, self.overlap,
                self.batch_size, self.num_classes, self.device)

    def predict_labels(self, volume, threshold: float = 0.5,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
        """(D, H, W) uint8 BraTS labels, on the model's device; `mesh`:
        the stitch sharded over its spatial groups
        (`sliding_window_labels`)."""
        with torch.inference_mode(), strict_fp32():
            return sliding_window_labels(
                self.forward_probs, volume, self.patch_size, self.overlap,
                self.batch_size, self.num_classes, self.device,
                threshold=threshold, label_mode=self.label_mode, mesh=mesh)
