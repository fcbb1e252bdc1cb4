"""Shared fixtures of the port's tests: small BraTS-layout raw patients
and the same preprocessed patients in both packages' stores."""

import os
import pathlib

import numpy as np

from nas_3d_unet_tpu_torch.io.nifti import write_nifti

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODS = ("t1", "t1ce", "t2", "flair")


def write_raw_patients(raw_dir, n=3, shape=(24, 20, 16), seed=0,
                       ext=".nii.gz"):
    """`n` patients under raw_dir/HGG and raw_dir/LGG (alternating): four
    modalities with a zero background outside an inner box and a brighter
    t1ce blob, and a {0,1,2,4} segmentation over the blob."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    dirs = []
    for i in range(n):
        name = f"BraTS_t_{i}"
        pdir = os.path.join(raw_dir, "HGG" if i % 2 == 0 else "LGG", name)
        os.makedirs(pdir)
        c = [s // 2 + int(rng.integers(-2, 3)) for s in shape]
        blob = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < 12
        lo = [2 + int(rng.integers(0, 2)) for _ in shape]
        box = tuple(slice(l, s - l) for l, s in zip(lo, shape))
        for m in MODS:
            v = np.zeros(shape, np.float32)
            v[box] = rng.random(v[box].shape).astype(np.float32) * 100 + 10
            if m == "t1ce":
                v[blob] += 80
            write_nifti(os.path.join(pdir, f"{name}_{m}{ext}"), v)
        seg = np.zeros(shape, np.uint8)
        seg[blob] = rng.choice(np.array([1, 2, 4], np.uint8), int(blob.sum()))
        write_nifti(os.path.join(pdir, f"{name}_seg{ext}"), seg)
        dirs.append(pdir)
    return dirs


def write_stores(root, shapes=((20, 18, 16), (12, 14, 10), (24, 20, 18)),
                 seed=0):
    """The same random patients as the JAX package's HDF5 store and the
    port's npz store: (h5 paths, npz paths).  A volume may be smaller than
    a patch (its crop is end-padded)."""
    import h5py

    rng = np.random.default_rng(seed)
    h5s, npzs = [], []
    os.makedirs(os.path.join(root, "h5"))
    os.makedirs(os.path.join(root, "npz"))
    for i, shape in enumerate(shapes):
        image = rng.standard_normal((*shape, 4)).astype(np.float32)
        label = rng.choice(np.array([0, 0, 1, 2, 4], np.uint8), shape)
        meta = {"crop_start": np.zeros(3, np.int64),
                "orig_shape": np.asarray(shape, np.int64),
                "affine": np.eye(4, dtype=np.float32)}
        name = f"P{i}"
        h5 = os.path.join(root, "h5", name + ".h5")
        with h5py.File(h5, "w") as f:
            f.create_dataset("image", data=image)
            f.create_dataset("label", data=label)
            for k, v in meta.items():
                f.attrs[k] = v
            f.attrs["patient"] = name
        npz = os.path.join(root, "npz", name + ".npz")
        np.savez(npz, image=image, label=label, patient=np.array(name),
                 **meta)
        h5s.append(h5)
        npzs.append(npz)
    return h5s, npzs
