"""Whole-volume prediction over patient records, in PyTorch.

Counterpart of `nas_3d_unet_tpu/infer/predict.py`: per patient, sliding-
window region probabilities → threshold → BraTS labels {0,1,2,4} decoded on
the device → un-crop to the scan geometry → optional `.nii.gz` → per-region
Dice (WT/TC/ET) when a ground-truth label is present.

A record is a dict: "patient" (name), "image" ((D, H, W, C) fp32, numpy or
tensor; "image_dev" may hold a copy already on the device), "crop_start",
"orig_shape", and optionally "label" ("label_dev"), "affine".
`predict_dataset` runs the loop over a directory of preprocessed patients,
with a loader thread reading and staging the next patient.  Under data
parallelism each data index serves its own patients, `[i::data]` of them
in name order, and the results are gathered.  This departs from the JAX
package on purpose, which splits one patient's patch batches over the
devices (`infer/sliding.py:93-97`): split by patient, the stitch needs no
collective, so its fp32 order, and with it every patient's labels and
probabilities, are bit for bit the one-process ones.  Under spatial
sharding the ranks of a spatial group serve the same patients, each
stitching its D-slab (`infer/sliding.py`); the first rank of the group
writes the NIfTI files.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.pipeline import DeviceStager, dataset_paths
from ..data.preprocess import load_patient
from ..io.nifti import write_nifti
from ..metrics.dice import labels_to_regions, region_dice
from ..parallel.mesh import Mesh
from .sliding import SlidingWindowPredictor


def uncrop_labels(labels: np.ndarray, crop_start, orig_shape) -> np.ndarray:
    """Place a cropped label map back into the original volume geometry."""
    out = np.zeros(tuple(int(s) for s in orig_shape), dtype=labels.dtype)
    s = [int(v) for v in crop_start]
    out[s[0]:s[0] + labels.shape[0],
        s[1]:s[1] + labels.shape[1],
        s[2]:s[2] + labels.shape[2]] = labels
    return out


def _dispatch_patient(predictor: SlidingWindowPredictor, rec: Dict,
                      threshold: float, mesh: Optional[Mesh] = None):
    """Queue one patient's device work: labels and (with a label) Dice, both
    left on the device; `mesh`: the stitch sharded over its spatial
    groups."""
    labels_dev = predictor.predict_labels(rec.get("image_dev", rec["image"]),
                                          threshold=threshold, mesh=mesh)
    dice_dev = None
    if "label" in rec:
        true = rec.get("label_dev")
        if true is None:
            true = torch.as_tensor(rec["label"], device=labels_dev.device)
        dice_dev = region_dice(labels_to_regions(labels_dev),
                               labels_to_regions(true))
    return labels_dev, dice_dev


def _finalize_patient(labels_dev: torch.Tensor, dice_dev, rec: Dict,
                      out_dir: Optional[str]) -> Dict:
    """Host side of one patient: label readback (waits for the device) →
    uncrop → NIfTI write → Dice scalars."""
    labels = labels_dev.cpu().numpy()
    full = uncrop_labels(labels, rec["crop_start"], rec["orig_shape"])
    result: Dict = {"patient": rec["patient"]}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, rec["patient"] + ".nii.gz")
        write_nifti(out_path, full, rec.get("affine"))
        result["output"] = out_path
    if dice_dev is not None:
        dice = dice_dev.cpu().numpy()
        result["dice"] = {"WT": float(dice[0]), "TC": float(dice[1]),
                          "ET": float(dice[2])}
    return result


def predict_patient(predictor: SlidingWindowPredictor, rec: Dict,
                    out_dir: Optional[str] = None,
                    threshold: float = 0.5,
                    mesh: Optional[Mesh] = None) -> Dict:
    """One patient end to end; `seconds` spans predict, decode, readback and
    uncrop (the NIfTI write and Dice scalars are not timed)."""
    t0 = time.perf_counter()
    labels_dev, dice_dev = _dispatch_patient(predictor, rec, threshold, mesh)
    labels_dev.cpu()                                  # wait for the device
    elapsed = time.perf_counter() - t0
    result = _finalize_patient(labels_dev, dice_dev, rec, out_dir)
    result["seconds"] = elapsed
    return result


def predict_records(predictor: SlidingWindowPredictor, records,
                    out_dir: Optional[str] = None, threshold: float = 0.5,
                    verbose: bool = True,
                    mesh: Optional[Mesh] = None) -> List[Dict]:
    """Pipelined loop over `(path, record)` pairs.

    The main thread queues each patient's device work; a writer thread does
    the label readback (the point that waits for the device), uncrop, NIfTI
    write and Dice scalars, so patient i's host work overlaps patient i+1's
    device work.  Results come back in patient order.  Each result's
    `seconds` is that patient's dispatch → finalize wall time, which includes
    time queued behind the previous patient."""
    results: List[Dict] = []
    # at most two dispatched patients wait: enough to keep the device busy
    # through one finalize, few enough that label volumes don't pile up
    q: "queue.Queue" = queue.Queue(maxsize=2)
    end = object()
    err: List[BaseException] = []

    def writer():
        while True:
            item = q.get()
            if item is end:
                return
            if err:
                continue                                  # unblock producers
            rec, labels_dev, dice_dev, t_disp = item
            try:
                res = _finalize_patient(labels_dev, dice_dev, rec, out_dir)
                res["seconds"] = time.perf_counter() - t_disp
                if verbose:
                    print(json.dumps(res))
                results.append(res)   # FIFO queue → patient order
            except BaseException as e:  # re-raised by the main thread
                err.append(e)

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    try:
        for _path, rec in records:
            labels_dev, dice_dev = _dispatch_patient(predictor, rec,
                                                     threshold, mesh)
            q.put((rec, labels_dev, dice_dev, time.perf_counter()))
    finally:
        q.put(end)
        wt.join()
    if err:
        raise RuntimeError("patient finalize failed") from err[0]
    return results


def _iter_patients_prefetched(paths: Sequence[str], device: torch.device
                              ) -> Iterator[Tuple[str, Dict]]:
    """Yield (path, record) with the next patient's file read and
    host → device copy (`image_dev` fp32, `label_dev` uint8; pinned, on a
    side stream) running in a loader thread while the current one
    computes.  An error in the thread is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=1)
    end = object()
    err: List[Exception] = []
    stager = DeviceStager(device)

    def loader():
        try:
            for path in paths:
                rec = load_patient(path)
                image = np.ascontiguousarray(rec["image"], dtype=np.float32)
                label = (np.ascontiguousarray(rec["label"], dtype=np.uint8)
                         if "label" in rec else None)
                q.put((path, rec, stager.put(image, label)))
        except Exception as e:  # re-raised by the consumer
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=loader, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise RuntimeError("patient prefetch failed") from err[0]
            return
        path, rec, staged = item
        rec["image_dev"], label_dev = stager.take(*staged)
        if label_dev is not None:
            rec["label_dev"] = label_dev
        yield path, rec


def predict_dataset(predictor: SlidingWindowPredictor, processed_dir: str,
                    out_dir: Optional[str] = None, threshold: float = 0.5,
                    overlap_output: bool = True,
                    mesh: Optional[Mesh] = None) -> List[Dict]:
    """Every patient `.npz` under processed_dir, in name order; prints one
    JSON line per patient it serves.  A loader thread feeds
    `predict_records`' dispatch/finalize overlap; `overlap_output=False`
    runs the patients one after the other (`predict_patient`).  `mesh`:
    data index i serves patients `[i::data]` (each rank of its spatial
    group stitching its D-slab, the first one writing the files and
    printing), and every rank returns all patients' results, in name
    order."""
    if mesh is None or mesh.world == 1:
        mesh = None
    rank, world = (0, 1) if mesh is None else (mesh.data_rank,
                                                mesh.data_world)
    first = mesh is None or mesh.slab is None or mesh.slab.first
    paths = dataset_paths(processed_dir, rank, world)
    records = _iter_patients_prefetched(paths, predictor.device)
    out_dir = out_dir if first else None
    if overlap_output:
        results = predict_records(predictor, records, out_dir, threshold,
                                  verbose=first, mesh=mesh)
    else:
        results = []
        for _path, rec in records:
            res = predict_patient(predictor, rec, out_dir, threshold, mesh)
            if first:
                print(json.dumps(res))
            results.append(res)
    if mesh is None:
        return results
    # data index i served patients i, i + data, ...: interleave the first
    # ranks' results of each spatial group back
    per_rank = mesh.gather(results)[::mesh.spatial]
    return [per_rank[i % world][i // world]
            for i in range(sum(map(len, per_rank)))]
