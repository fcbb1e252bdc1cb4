"""Minimal numpy NIfTI-1 reader/writer.

The port's own copy of `nas_3d_unet_tpu/io/nifti.py` (the port imports
nothing of the JAX package).  BraTS files are single-file NIfTI-1: a 348-byte
header and raw column-major data, usually gzipped.  Only the fields the
pipeline needs are handled: dims, datatype, pixdim, scl_slope/scl_inter, the
sform affine rows and vox_offset.  `data[i, j, k]` indexes (x, y, z) voxels,
as nibabel's `get_fdata` does.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

HDR_SIZE = 348
MAGIC_N1 = b"n+1\x00"  # single-file nifti

# NIfTI datatype code → numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """A loaded NIfTI volume: data, its affine and its voxel sizes."""

    data: np.ndarray
    affine: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    pixdim: Optional[np.ndarray] = None  # zooms for each spatial dim

    @property
    def shape(self):
        return self.data.shape


def _open(path: str, mode: str):
    if mode == "rb":
        with open(path, "rb") as f:
            magic = f.read(2)
        return gzip.open(path, "rb") if magic == b"\x1f\x8b" \
            else open(path, "rb")
    if str(path).endswith(".gz"):
        return gzip.open(path, mode, compresslevel=1)
    return open(path, mode)


def read_nifti(path: str) -> NiftiImage:
    """Read a (possibly gzipped) single-file NIfTI-1 image."""
    with _open(path, "rb") as f:
        raw = f.read()

    hdr = raw[:HDR_SIZE]
    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    bo = "<"
    if sizeof_hdr != HDR_SIZE:
        if struct.unpack_from(">i", hdr, 0)[0] != HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file "
                             f"(sizeof_hdr={sizeof_hdr})")
        bo = ">"

    dim = struct.unpack_from(bo + "8h", hdr, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    (datatype,) = struct.unpack_from(bo + "h", hdr, 70)
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code "
                         f"{datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)

    pixdim = np.array(struct.unpack_from(bo + "8f", hdr, 76), np.float32)
    (vox_offset,) = struct.unpack_from(bo + "f", hdr, 108)
    scl_slope, scl_inter = struct.unpack_from(bo + "2f", hdr, 112)
    (sform_code,) = struct.unpack_from(bo + "h", hdr, 254)

    affine = np.eye(4, dtype=np.float32)
    if sform_code > 0:
        srow = struct.unpack_from(bo + "12f", hdr, 280)
        affine[:3, :] = np.asarray(srow, np.float32).reshape(3, 4)
    else:
        # pixdim scaling only (BraTS needs no qform decoding)
        for i in range(3):
            affine[i, i] = pixdim[i + 1] if pixdim[i + 1] != 0 else 1.0

    offset = int(vox_offset) if vox_offset >= HDR_SIZE else HDR_SIZE
    data = np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape)),
                         offset=offset).reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    return NiftiImage(data=np.asarray(data), affine=affine,
                      pixdim=pixdim[1:1 + ndim])


def write_nifti(path: str, data: np.ndarray,
                affine: Optional[np.ndarray] = None) -> None:
    """Write a single-file NIfTI-1 image (gzipped iff path ends with .gz)."""
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    affine = np.eye(4, dtype=np.float32) if affine is None \
        else np.asarray(affine, np.float32)

    hdr = bytearray(HDR_SIZE)
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)      # bitpix
    # pixdim from the affine's column norms
    zooms = [1.0] + [float(np.linalg.norm(affine[:3, i])) or 1.0
                     for i in range(3)]
    struct.pack_into("<8f", hdr, 76, *(zooms + [1.0] * 4))
    struct.pack_into("<f", hdr, 108, float(HDR_SIZE + 4))  # + ext flag
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)    # scl_slope, scl_inter
    struct.pack_into("<h", hdr, 252, 1)            # qform_code (unused)
    struct.pack_into("<h", hdr, 254, 1)            # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].reshape(-1))
    hdr[344:348] = MAGIC_N1

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00\x00\x00\x00")               # no header extensions
        f.write(np.asfortranarray(data).tobytes(order="F"))
