"""Online patch pipeline: random 3D crops (+ host augmentation) feeding the
card.

Counterpart of `nas_3d_unet_tpu/data/pipeline.py`: a deterministic
train/val split of the patient files, every patient resident in host RAM
(`PatientCache`, raw uint8 labels), a counter-based `PatchGenerator` whose
batch k of seed s is a pure function of (s, k) — bitwise the JAX
package's — and a `Prefetcher` whose thread (one per worker, `workers` >
1) assembles the next batches and stages them on the card while the
current step runs.

Host → device copies (`DeviceStager`): the batch is copied into pinned
memory and sent with a `non_blocking` copy on a side CUDA stream that does
nothing but these copies; the consumer's stream waits on the copy's event.
No kernel of the port runs on that stream, so K5's launches all stay on the
current stream (its completion tickets are shared by every K5 launch on a
device, `csrc/stats.cu`, and must not be raced from two streams).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..metrics.dice import labels_to_class_indices_np, labels_to_regions_np
from ..utils.profiling import annotate
from .native import crop_batch_native
from .preprocess import load_patient


def split_patients(paths: Sequence[str], val_fraction: float,
                   seed: int) -> Tuple[List[str], List[str]]:
    """Deterministic shuffled train/val split of patient file paths."""
    paths = sorted(paths)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(paths))
    n_val = max(1, int(round(len(paths) * val_fraction))) \
        if len(paths) > 1 else 0
    val_idx = set(perm[:n_val].tolist())
    train = [p for i, p in enumerate(paths) if i not in val_idx]
    val = [p for i, p in enumerate(paths) if i in val_idx]
    return train, val


class PatientCache:
    """All preprocessed patients resident in host RAM: the fp32 image and
    the raw uint8 BraTS label volume (1 B/voxel), which `PatchGenerator`
    turns into the training encoding per patch."""

    def __init__(self, paths: Sequence[str], label_mode: str = "regions"):
        if not paths:
            raise ValueError("empty patient list")
        self.label_mode = label_mode
        self.records: List[Dict[str, np.ndarray]] = []
        for p in paths:
            rec = load_patient(p)
            item = {"image": np.ascontiguousarray(rec["image"],
                                                  dtype=np.float32)}
            if "label" in rec:
                item["label_u8"] = np.ascontiguousarray(rec["label"],
                                                        dtype=np.uint8)
            self.records.append(item)

    def __len__(self) -> int:
        return len(self.records)


def _crop_at(image: np.ndarray, label: Optional[np.ndarray], start,
             patch: Tuple[int, int, int]):
    """Patch crop at a given origin; volumes smaller than the patch are
    end-padded (the origin is 0 on padded axes by construction)."""
    shape = image.shape[:3]
    pad = [max(0, p - s) for p, s in zip(patch, shape)]
    if any(pad):
        pw = [(0, pad[0]), (0, pad[1]), (0, pad[2])]
        image = np.pad(image, pw + [(0, 0)])
        if label is not None:
            label = np.pad(label, pw + [(0, 0)] * (label.ndim - 3))
    sl = tuple(slice(st, st + p) for st, p in zip(start, patch))
    return image[sl], (label[sl] if label is not None else None)


def _augment_np(rng: np.random.Generator, img: np.ndarray,
                lab: Optional[np.ndarray], flip_prob: float, shift: float,
                scale: float):
    """Random axis flips + per-modality intensity shift/scale (host path)."""
    for axis in range(3):
        if rng.random() < flip_prob:
            img = np.flip(img, axis=axis)
            if lab is not None:
                lab = np.flip(lab, axis=axis)
    if shift > 0 or scale > 0:
        c = img.shape[-1]
        sh = rng.uniform(-shift, shift, size=(1, 1, 1, c)).astype(np.float32)
        sc = 1.0 + rng.uniform(-scale, scale,
                               size=(1, 1, 1, c)).astype(np.float32)
        img = img * sc + sh
    return np.ascontiguousarray(img), \
        (np.ascontiguousarray(lab) if lab is not None else None)


class PatchGenerator:
    """Random-patch batch iterator over a PatientCache.

    Counter-based: batch k of seed s is drawn from a fresh
    `default_rng((s, k))`, so the stream is a pure function of (seed, batch
    index) and a resumed run, positioned with `set_step`, consumes the
    batches an uninterrupted one would.  Per sample the draws come in the
    reference's order: the patient index, the 3 starts, then the augment
    draws.  A batch that is not augmented, has labels and whose volumes
    all hold a patch is cropped in one call of the C++ library
    (`crop_batch_native`), as the JAX generator does, where the library
    is built; the numpy crop gives the same bytes."""

    def __init__(self, cache: PatientCache, patch_size, batch_size: int,
                 seed: int = 0, augment: bool = True, flip_prob: float = 0.5,
                 intensity_shift: float = 0.1, intensity_scale: float = 0.1,
                 start_step: int = 0):
        self.cache = cache
        self.patch = tuple(int(p) for p in patch_size)
        self.batch_size = batch_size
        self.augment = augment
        self.flip_prob = flip_prob
        self.shift = intensity_shift
        self.scale = intensity_scale
        self.seed = seed
        self._step = int(start_step)

    def set_step(self, step: int) -> None:
        """Position the stream at batch index `step` (resume alignment)."""
        self._step = int(step)

    def clone(self, seed_offset: int) -> "PatchGenerator":
        """Same sampling config, independent RNG stream."""
        return PatchGenerator(self.cache, self.patch, self.batch_size,
                              seed=self.seed + seed_offset,
                              augment=self.augment, flip_prob=self.flip_prob,
                              intensity_shift=self.shift,
                              intensity_scale=self.scale,
                              start_step=self._step)

    def _decode_labels(self, y_u8: np.ndarray) -> np.ndarray:
        """Raw uint8 labels → fp32 WT/TC/ET one-hots or int32 classes."""
        if self.cache.label_mode == "classes":
            return labels_to_class_indices_np(y_u8)
        return labels_to_regions_np(y_u8)

    def next(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        rng = np.random.default_rng((self.seed, self._step))
        self._step += 1
        recs, starts = [], []
        fits = True                 # every volume at least a patch
        for _ in range(self.batch_size):
            rec = self.cache.records[rng.integers(0, len(self.cache))]
            shape = rec["image"].shape[:3]
            fits = fits and all(s >= p for s, p in zip(shape, self.patch))
            starts.append([int(rng.integers(0, max(1, s - p + 1)))
                           for s, p in zip(shape, self.patch)])
            recs.append(rec)
        if fits and not self.augment and "label_u8" in recs[0]:
            st = np.asarray(starts, dtype=np.int64)
            x = crop_batch_native([r["image"] for r in recs], st, self.patch)
            y = crop_batch_native([r["label_u8"] for r in recs], st,
                                  self.patch)
            if x is not None and y is not None:
                return x, self._decode_labels(y)
        xs, ys = [], []
        for rec, st in zip(recs, starts):
            img, lab = _crop_at(rec["image"], rec.get("label_u8"), st,
                                self.patch)
            if self.augment:
                img, lab = _augment_np(rng, img, lab, self.flip_prob,
                                       self.shift, self.scale)
            xs.append(img)
            ys.append(lab)
        x = np.stack(xs)
        y = self._decode_labels(np.stack(ys)) if ys[0] is not None else None
        return x, y


class DeviceStager:
    """Host arrays → tensors on `device`, staged from a worker thread.

    `put` (worker thread) copies the arrays into pinned memory, sends them
    with `non_blocking` copies on a side stream and waits for the copies
    there, so no pinned buffer goes back to the allocator before its copy
    has completed.  `take` (the consumer's thread) makes the current stream
    wait on the copies' event and records the tensors on it, so the
    allocator keeps their memory until the consumer's work is done.  On the
    CPU both are plain `torch.from_numpy`."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def put(self, *arrays: Optional[np.ndarray]):
        tensors = [None if a is None else torch.from_numpy(a)
                   for a in arrays]
        if self.stream is None:
            return tensors, None
        pinned = [None if t is None else t.pin_memory() for t in tensors]
        with torch.cuda.stream(self.stream):
            staged = [None if t is None
                      else t.to(self.device, non_blocking=True)
                      for t in pinned]
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return staged, done

    def take(self, tensors, done) -> List[Optional[torch.Tensor]]:
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in tensors:
                if t is not None:
                    t.record_stream(cur)
        return tensors


_SENTINEL = object()


class Prefetcher:
    """Background threads assembling batches and staging them on `device`,
    `depth` batches ahead.  An error in a thread is raised by the next
    `next()`.

    `workers` 1 (default): one thread, batches in `generator`'s order.
    `workers` w > 1 (`pipeline.py:249-270`): one thread per
    `generator.clone(1000 * k)`, k < w (independent streams, the first
    `generator`'s own), a queue of max(depth, w), batches in whatever
    order the threads deliver them.  Each thread has a `DeviceStager` of
    its own: its own side stream and its own copies' events.

    Spans: `data.assemble` (`generator.next()`) and `data.stage` (the
    stager's `put`) on a worker thread, `data.fetch` (`next()`) on the
    consumer's."""

    def __init__(self, generator: PatchGenerator, device: torch.device,
                 depth: int = 2, workers: int = 1):
        self._error: Optional[Exception] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth, workers))
        self._stop = threading.Event()
        gens = [generator] if workers <= 1 else [
            generator.clone(1000 * k) for k in range(workers)]
        self._stagers = [DeviceStager(device) for _ in gens]
        self._threads = [
            threading.Thread(target=self._worker, args=(g, st), daemon=True)
            for g, st in zip(gens, self._stagers)]
        for t in self._threads:
            t.start()

    def _worker(self, gen: PatchGenerator, stager: DeviceStager):
        try:
            while not self._stop.is_set():
                with annotate("data.assemble"):
                    arrays = gen.next()
                with annotate("data.stage"):
                    item = stager.put(*arrays)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # handed to next() instead of hanging it
            self._error = e
            try:
                self._q.put(_SENTINEL, timeout=1.0)
            except queue.Full:
                pass

    def next(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        with annotate("data.fetch"):
            item = self._q.get()
            if item is _SENTINEL:
                raise RuntimeError("Prefetcher worker failed") \
                    from self._error
            x, y = self._stagers[0].take(*item)
            return x, y

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=2.0)


def dataset_paths(processed_dir: str, rank: int = 0,
                  world: int = 1) -> List[str]:
    """Patient `.npz` paths, sorted, then rank `rank`'s share
    `[rank::world]` of `world` ranks (the JAX package's per-host split,
    `pipeline.py:322-331`), taken before `split_patients`."""
    paths = sorted(glob.glob(os.path.join(processed_dir, "*.npz")))
    return paths[rank::world]
