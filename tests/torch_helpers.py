"""Shared fixtures of the port's tests: small BraTS-layout raw patients,
the same preprocessed patients in both packages' stores, the quality
tasks of tests/helpers.py as the port's `.npz` patients, and one torch
thread per test module."""

import os
import pathlib

import numpy as np
import pytest
import torch

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


def _write_patient_npz(path, vols, seg, name):
    """One patient's `.npz` from raw arrays, as `preprocess` writes it
    (the port's `preprocess_arrays`, an identity affine)."""
    from nas_3d_unet_tpu_torch.data.preprocess import preprocess_arrays

    rec = preprocess_arrays(vols, seg)
    np.savez(path, image=rec["image"], label=rec["label"],
             crop_start=rec["crop_start"], orig_shape=rec["orig_shape"],
             affine=np.eye(4, dtype=np.float32), patient=np.array(name))
    return path


def write_learnable_npz(out_dir, n_patients=4, shape=(28, 28, 28), seed=0):
    """The arrays of tests/helpers.py `write_learnable_h5` as the port's
    `.npz` patients (the same draws in the same order): a blob in t1ce
    (with a brighter core) and flair over low noise, labelled edema (2)
    with an enhancing core (4); a net learns it only if the stack
    learns."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    paths = []
    for i in range(n_patients):
        c = [int(rng.integers(2 * s // 5, 3 * s // 5)) for s in shape]
        r = min(shape) // 3
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        blob = (d2 < r * r).astype(np.float32)
        core = (d2 < (r - 3) ** 2).astype(np.float32)
        vols = []
        for m in range(4):
            v = rng.random(shape).astype(np.float32) * 0.2 + 0.1
            if m == 1:
                v = v + 1.0 * blob + 0.5 * core
            elif m == 3:
                v = v + 0.8 * blob
            v += rng.random(shape).astype(np.float32) * 0.05
            vols.append(v)
        seg = np.zeros(shape, np.uint8)
        seg[blob > 0] = 2
        seg[core > 0] = 4
        paths.append(_write_patient_npz(
            os.path.join(out_dir, f"LEARN_{i}.npz"), vols, seg,
            f"LEARN_{i}"))
    return paths


def write_shifted_npz(out_dir, n_patients=4, shape=(20, 20, 20), shift=3,
                      seed=0, noise=False):
    """The arrays of tests/helpers.py `write_shifted_h5` as the port's
    `.npz` patients: the label blob is the t1ce blob shifted by +`shift`
    on every axis, which only conv candidates can express; with `noise`
    it is placed independently of the image (the unlearnable control)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    paths = []
    for i in range(n_patients):
        c = [int(rng.integers(s // 3, s // 2)) for s in shape]
        r = min(shape) // 4
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        blob = d2 < r * r
        if noise:
            cn = [int(rng.integers(r + 1, s - r - 1)) for s in shape]
            d2s = ((zz - cn[0]) ** 2 + (yy - cn[1]) ** 2
                   + (xx - cn[2]) ** 2)
        else:
            d2s = ((zz - c[0] - shift) ** 2 + (yy - c[1] - shift) ** 2
                   + (xx - c[2] - shift) ** 2)
        sblob = d2s < r * r
        score = d2s < max(1, (r - 2)) ** 2
        vols = []
        for m in range(4):
            v = rng.random(shape).astype(np.float32) * 0.2 + 0.1
            if m == 1:
                v = v + 1.0 * blob.astype(np.float32)
            vols.append(v)
        seg = np.zeros(shape, np.uint8)
        seg[sblob] = 2
        seg[score] = 4
        paths.append(_write_patient_npz(
            os.path.join(out_dir, f"SHIFT_{i}.npz"), vols, seg,
            f"SHIFT_{i}"))
    return paths


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread while the module runs (a module
    imports this fixture to take it).  The tests' tensors are a few kB:
    more threads cost more CPU time than they save, and under pytest-xdist
    every worker's threads would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
