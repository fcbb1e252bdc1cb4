"""ctypes loader for the C++ preprocessing functions (`preproc.cpp`).

Counterpart of `nas_3d_unet_tpu/data/native/_native.py`: `preproc.cpp` is
the JAX package's source byte for byte, built at first use with the same
`g++` flags, so on one machine the two packages' native paths compute the
same bits.  The library lands in the package's `_build/` (listed in
.gitignore), named by a hash of the source and the flags, as `_build.py`
names the CUDA library.  Without a compiler, or where the build fails,
`available()` is False and every function returns None: `preprocess.py`
and `pipeline.py` then take their numpy path, which the native one equals
within 1e-5 (the z-score) or exactly (the bounding box, the crop).

`CALLS` counts the calls that ran in the library, by function, since the
last `CALLS.clear()`: how a caller tells that the native path ran.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "preproc.cpp"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

CALLS: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libnas3d_preproc_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> Optional[str]:
    """Build `so`; None on success, else what went wrong."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)}:\n{proc.stdout}{proc.stderr}"
    os.replace(tmp, so)     # atomic: a concurrent loader sees all or nothing
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists():
            _error = _compile(so)
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _error = str(e)
            return None
        lib.zscore_in_mask.restype = ctypes.c_int64
        lib.zscore_in_mask.argtypes = [_F32P, _I64]
        lib.union_foreground_bbox.restype = ctypes.c_int32
        lib.union_foreground_bbox.argtypes = [
            ctypes.POINTER(_F32P), _I64, _I64, _I64, _I64, _I64P]
        lib.crop_batch_bytes.restype = None
        lib.crop_batch_bytes.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), _I64P, _I64P, ctypes.c_void_p,
            _I64, _I64, _I64, _I64, _I64]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it at first
    call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None: it is, or was not tried)."""
    _load()
    return _error


def zscore_native(vol: np.ndarray) -> Optional[np.ndarray]:
    """A float32 copy of `vol` z-scored within its nonzero mask (mean and
    std in double); None without the library."""
    lib = _load()
    if lib is None:
        return None
    out = np.ascontiguousarray(vol, dtype=np.float32).copy()
    lib.zscore_in_mask(out.ctypes.data_as(_F32P), out.size)
    CALLS["zscore_in_mask"] += 1
    return out


def union_bbox_native(vols: List[np.ndarray]
                      ) -> Optional[Tuple[slice, slice, slice]]:
    """The bounding box of the voxels nonzero in any of the volumes (all
    of one shape; the whole volume if none is); None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    contig = [np.ascontiguousarray(v, dtype=np.float32) for v in vols]
    if any(v.shape != contig[0].shape for v in contig):
        raise ValueError(f"volumes of several shapes: "
                         f"{[v.shape for v in contig]}")
    d, h, w = contig[0].shape
    ptrs = (_F32P * len(contig))(*[v.ctypes.data_as(_F32P)
                                   for v in contig])
    bbox = (ctypes.c_int64 * 6)()
    lib.union_foreground_bbox(ptrs, len(contig), d, h, w, bbox)
    CALLS["union_foreground_bbox"] += 1
    return (slice(bbox[0], bbox[1]), slice(bbox[2], bbox[3]),
            slice(bbox[4], bbox[5]))


def crop_batch_native(vols: List[np.ndarray], starts: np.ndarray,
                      patch: Tuple[int, int, int]) -> Optional[np.ndarray]:
    """The (n, pd, ph, pw[, C]) batch of patches of `patch` cropped at
    `starts` ((n, 3) origins) from n C-contiguous (D, H, W[, C]) volumes
    of one dtype and one trailing shape, each patch inside its volume, in
    one multithreaded call.  None without the library, for no volumes, or
    where the volumes differ in dtype, trailing shape or contiguity."""
    lib = _load()
    if lib is None or not vols:
        return None
    v0 = vols[0]
    trail = v0.shape[3:]
    if any((not v.flags.c_contiguous) or v.dtype != v0.dtype
           or v.shape[3:] != trail for v in vols):
        return None
    n = len(vols)
    pd, ph, pw = (int(p) for p in patch)
    dims = np.asarray([v.shape[:3] for v in vols], dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if starts.shape != (n, 3) or (starts < 0).any() \
            or (starts + (pd, ph, pw) > dims).any():
        raise ValueError(f"crops {starts.tolist()} of {patch} outside "
                         f"volumes {dims.tolist()}")
    vox_bytes = int(np.prod(trail, dtype=np.int64)) * v0.itemsize
    out = np.empty((n, pd, ph, pw) + trail, dtype=v0.dtype)
    ptrs = (ctypes.c_void_p * n)(*[v.ctypes.data for v in vols])
    lib.crop_batch_bytes(ptrs, dims.ctypes.data_as(_I64P),
                         starts.ctypes.data_as(_I64P),
                         out.ctypes.data_as(ctypes.c_void_p), n, pd, ph, pw,
                         vox_bytes)
    CALLS["crop_batch_bytes"] += 1
    return out
