"""Offline BraTS preprocessing: NIfTI → one `.npz` per patient.

Counterpart of `nas_3d_unet_tpu/data/preprocess.py`: walk the `HGG/` and
`LGG/` patient dirs, read the four modalities and the segmentation,
z-score each modality within its nonzero mask (mean and std in float64),
crop everything to the union foreground bounding box, stack the
modalities channels-last and write one file per patient.  As there, the
z-score and the bounding box run in the C++ library (`data/native/`)
where it builds and `NAS3D_NO_NATIVE` is unset, else in numpy; on either
path the arrays are bitwise those the JAX package writes to HDF5 on the
same path (the two paths' z-scores differ in the last bits).

A patient file holds `image` ((D, H, W, C) fp32), `label` ((D, H, W) uint8,
when a segmentation exists), `crop_start`, `orig_shape` (int64), `affine`
(4×4), `patient` and `modalities` (strings).
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.nifti import read_nifti
from .native import available as _native_available
from .native import union_bbox_native, zscore_native

MODALITIES = ("t1", "t1ce", "t2", "flair")
SEG_SUFFIX = "seg"


def _use_native() -> bool:
    """The JAX package's rule: the library where it builds, unless
    `NAS3D_NO_NATIVE` is set."""
    return _native_available() and not os.environ.get("NAS3D_NO_NATIVE")


def zscore_in_mask(vol: np.ndarray,
                   mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Z-score normalize within the mask (default: the nonzero voxels);
    the background stays 0."""
    vol = vol.astype(np.float32)
    if mask is None:
        if _use_native():
            return zscore_native(vol)
        mask = vol != 0
    vals = vol[mask]
    if vals.size == 0:
        return np.zeros_like(vol)
    mean = vals.mean(dtype=np.float64)
    std = vals.std(dtype=np.float64)
    if std == 0:
        std = 1.0
    out = np.zeros_like(vol)
    out[mask] = ((vals - mean) / std).astype(np.float32)
    return out


def foreground_bbox(mask: np.ndarray) -> Tuple[slice, ...]:
    """Tight bounding box of True voxels (full volume if empty)."""
    if not mask.any():
        return tuple(slice(0, s) for s in mask.shape)
    slices = []
    for axis in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != axis)
        idx = np.where(mask.any(axis=other))[0]
        slices.append(slice(int(idx[0]), int(idx[-1]) + 1))
    return tuple(slices)


def preprocess_arrays(modality_vols: Sequence[np.ndarray],
                      seg: Optional[np.ndarray] = None
                      ) -> Dict[str, np.ndarray]:
    """The transform on raw arrays: image, crop metadata and label."""
    orig_shape = np.array(modality_vols[0].shape, dtype=np.int64)
    vols32 = [np.ascontiguousarray(v, dtype=np.float32)
              for v in modality_vols]
    if _use_native():
        bbox = union_bbox_native(vols32)
    else:
        union = np.zeros(vols32[0].shape, dtype=bool)
        for v in vols32:
            union |= v != 0
        bbox = foreground_bbox(union)
    image = np.stack([zscore_in_mask(v)[bbox] for v in vols32],
                     axis=-1).astype(np.float32)          # (D, H, W, C)
    out = {
        "image": image,
        "crop_start": np.array([s.start for s in bbox], dtype=np.int64),
        "orig_shape": orig_shape,
    }
    if seg is not None:
        out["label"] = np.asarray(seg)[bbox].astype(np.uint8)
    return out


def _find_modality_file(patient_dir: str, name: str,
                        suffix: str) -> Optional[str]:
    for ext in (".nii.gz", ".nii"):
        p = os.path.join(patient_dir, f"{name}_{suffix}{ext}")
        if os.path.exists(p):
            return p
    return None


def preprocess_patient(patient_dir: str, out_path: str,
                       modalities: Sequence[str] = MODALITIES,
                       seg_suffix: str = SEG_SUFFIX) -> str:
    """One patient: read the NIfTIs, transform, write `out_path`
    atomically (a temporary file, then `os.replace`)."""
    name = os.path.basename(os.path.normpath(patient_dir))
    vols, affine = [], None
    for m in modalities:
        path = _find_modality_file(patient_dir, name, m)
        if path is None:
            raise FileNotFoundError(f"{patient_dir}: missing modality {m!r}")
        img = read_nifti(path)
        vols.append(np.asarray(img.data, dtype=np.float32))
        affine = img.affine if affine is None else affine

    seg = None
    seg_path = _find_modality_file(patient_dir, name, seg_suffix)
    if seg_path is not None:
        seg = np.asarray(read_nifti(seg_path).data)

    rec = preprocess_arrays(vols, seg)
    rec["affine"] = np.asarray(affine)
    rec["patient"] = np.array(name)
    rec["modalities"] = np.array(",".join(modalities))
    tmp = out_path + ".tmp"
    # through a file handle: given a name without ".npz", np.savez would
    # append the suffix and os.replace would publish the wrong file
    with open(tmp, "wb") as f:
        np.savez(f, **rec)
    os.replace(tmp, out_path)
    return out_path


def list_patient_dirs(raw_dir: str) -> List[str]:
    """HGG/ + LGG/ grade dirs if present, else every subdir of raw_dir."""
    dirs: List[str] = []
    grade_dirs = [os.path.join(raw_dir, g) for g in ("HGG", "LGG")]
    roots = [g for g in grade_dirs if os.path.isdir(g)] or [raw_dir]
    for root in roots:
        for entry in sorted(os.listdir(root)):
            full = os.path.join(root, entry)
            if os.path.isdir(full):
                dirs.append(full)
    return dirs


def preprocess_dataset(raw_dir: str, out_dir: str,
                       modalities: Sequence[str] = MODALITIES,
                       seg_suffix: str = SEG_SUFFIX,
                       workers: int = 0) -> List[str]:
    """Preprocess every patient under raw_dir into out_dir/<patient>.npz;
    `workers` > 1 runs that many processes."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(p, os.path.join(out_dir,
                             os.path.basename(os.path.normpath(p)) + ".npz"))
            for p in list_patient_dirs(raw_dir)]
    if workers and workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=workers,
                                    mp_context=ctx) as ex:
            futs = [ex.submit(preprocess_patient, p, o, modalities,
                              seg_suffix) for p, o in jobs]
            return [f.result() for f in futs]
    return [preprocess_patient(p, o, modalities, seg_suffix)
            for p, o in jobs]


def load_patient(path: str) -> Dict:
    """Read a preprocessed patient back: numpy arrays, and `patient` as a
    string."""
    with np.load(path, allow_pickle=False) as f:
        rec = {k: f[k] for k in f.files if k != "modalities"}
    rec["patient"] = str(rec["patient"])
    return rec
