"""The port's C++ host path (nas_3d_unet_tpu_torch/data/native/) against
the JAX package's (nas_3d_unet_tpu/data/native/) and against numpy:

  * `preproc.cpp` is the JAX package's source byte for byte;
  * the cases of tests/test_native.py: the native z-score, bounding box,
    `preprocess_arrays` and batched crop, each bit-equal to the JAX
    package's native function and within 1e-5 (the z-score) or exactly
    (the box, the crop) of the numpy path;
  * the port's default `preprocess_arrays` and patient file bit-equal to
    the JAX package's default (native) path, and under NAS3D_NO_NATIVE to
    its numpy path;
  * the port's `PatchGenerator` crops natively where the JAX one does
    (not augmenting, every volume a patch or more) and gives the numpy
    crop's bytes, equal to the JAX generator's;
  * without a compiler the library is unavailable, every function returns
    None and preprocessing takes the numpy path.
Both libraries are built here by g++ at first use; the tests skip where
the JAX package's does not build.
"""

import os
import subprocess

import numpy as np
import pytest

from nas_3d_unet_tpu.data import native as jnative
from nas_3d_unet_tpu.data import pipeline as jpipe
from nas_3d_unet_tpu.data import preprocess as jpre
from nas_3d_unet_tpu.data.native import _native as jnative_mod
from nas_3d_unet_tpu_torch.data import pipeline as tpipe
from nas_3d_unet_tpu_torch.data import preprocess as tpre
from nas_3d_unet_tpu_torch.data.native import _native as tnative
from tests.torch_helpers import ROOT, write_raw_patients, write_stores
from tests.torch_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def built(monkeypatch):
    """Both libraries built; the native path on (NAS3D_NO_NATIVE unset)."""
    monkeypatch.delenv("NAS3D_NO_NATIVE", raising=False)
    if not jnative.available():
        pytest.skip("the JAX package's native library does not build here")
    assert tnative.available(), tnative.build_error()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _zscore_numpy(vol):
    mask = vol != 0
    out = np.zeros_like(vol)
    vals = vol[mask]
    out[mask] = ((vals - vals.mean(dtype=np.float64))
                 / vals.std(dtype=np.float64)).astype(np.float32)
    return out


def test_source_is_the_jax_packages():
    assert tnative.SRC.read_bytes() == (
        ROOT / "nas_3d_unet_tpu/data/native/preproc.cpp").read_bytes()
    assert tnative.library_path().parent == ROOT / "nas_3d_unet_tpu_torch" \
        / "_build"


def test_zscore_matches_jax_native_and_numpy():
    rng = np.random.default_rng(0)
    vol = np.zeros((30, 28, 26), np.float32)
    vol[5:25, 4:24, 3:23] = (rng.random((20, 20, 20)) * 50 + 7).astype(
        np.float32)
    tnative.CALLS.clear()
    got = tnative.zscore_native(vol)
    assert tnative.CALLS == {"zscore_in_mask": 1}
    _same(got, jnative.zscore_native(vol))
    np.testing.assert_allclose(got, _zscore_numpy(vol), atol=1e-5)
    assert (got[vol == 0] == 0).all()
    assert vol[5, 4, 3] != got[5, 4, 3]            # the input is not touched


def test_zscore_empty_and_constant():
    empty = np.zeros((4, 4, 4), np.float32)
    _same(tnative.zscore_native(empty), empty)
    const = np.zeros((4, 4, 4), np.float32)
    const[1:3] = 5.0
    got = tnative.zscore_native(const)
    _same(got, jnative.zscore_native(const))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1:3], 0.0, atol=1e-6)


def test_union_bbox_matches_jax_native_and_numpy():
    a = np.zeros((20, 18, 16), np.float32)
    b = np.zeros((20, 18, 16), np.float32)
    a[3:9, 2:8, 4:10] = 1.0
    b[7:15, 5:12, 1:6] = 2.0
    got = tnative.union_bbox_native([a, b])
    assert got == jnative.union_bbox_native([a, b])
    assert got == tpre.foreground_bbox((a != 0) | (b != 0))
    empty = [np.zeros((5, 6, 7), np.float32)]
    assert tnative.union_bbox_native(empty) == (slice(0, 5), slice(0, 6),
                                                slice(0, 7))
    with pytest.raises(ValueError, match="shapes"):
        tnative.union_bbox_native([a, b[:-1]])


def _volumes(seed, shape=(24, 22, 20)):
    rng = np.random.default_rng(seed)
    vols = []
    for _ in range(4):
        v = np.zeros(shape, np.float32)
        v[4:20, 3:19, 2:18] = (rng.random((16, 16, 16)) * 30 + 1).astype(
            np.float32)
        vols.append(v)
    seg = np.zeros(shape, np.uint8)
    seg[8:12, 7:11, 6:10] = 2
    return vols, seg


@pytest.mark.parametrize("seed", [2, 5])
def test_default_preprocess_arrays_is_the_jax_default_path(seed,
                                                           monkeypatch):
    """Native by default: bit-equal to the JAX package's default path;
    under NAS3D_NO_NATIVE bit-equal to its numpy path; the two paths
    within 1e-5 of each other, with the same crop."""
    vols, seg = _volumes(seed)
    tnative.CALLS.clear()
    native = tpre.preprocess_arrays(vols, seg)
    assert tnative.CALLS == {"zscore_in_mask": 4, "union_foreground_bbox": 1}
    ref = jpre.preprocess_arrays(vols, seg)
    assert set(native) == set(ref)
    for k in ref:
        _same(native[k], ref[k])
    monkeypatch.setenv("NAS3D_NO_NATIVE", "1")
    tnative.CALLS.clear()
    numpy_path = tpre.preprocess_arrays(vols, seg)
    assert not tnative.CALLS
    for k, v in jpre.preprocess_arrays(vols, seg).items():
        _same(numpy_path[k], v)
    _same(native["crop_start"], numpy_path["crop_start"])
    _same(native["label"], numpy_path["label"])
    np.testing.assert_allclose(native["image"], numpy_path["image"],
                               atol=1e-5)


def test_default_patient_file_equals_the_default_h5(tmp_path):
    (pdir,) = write_raw_patients(str(tmp_path / "raw"), n=1, ext=".nii")
    h5 = jpre.preprocess_patient(pdir, str(tmp_path / "p.h5"))
    out = tpre.preprocess_patient(pdir, str(tmp_path / "p.npz"))
    port, ref = tpre.load_patient(out), jpre.load_patient_h5(h5)
    for k in ("image", "label", "crop_start", "orig_shape", "affine"):
        _same(port[k], ref[k])


def test_crop_batch_matches_numpy_and_jax_native():
    rng = np.random.default_rng(3)
    vols = [np.ascontiguousarray(rng.standard_normal(
        (12 + i, 11, 10, 4)).astype(np.float32)) for i in range(4)]
    starts = np.asarray([[2, 1, 0], [0, 3, 2], [4, 0, 1], [1, 1, 1]],
                        np.int64)
    out = tnative.crop_batch_native(vols, starts, (8, 8, 8))
    _same(out, jnative_mod.crop_batch_native(vols, starts, (8, 8, 8)))
    for i, (v, st) in enumerate(zip(vols, starts)):
        _same(out[i], v[st[0]:st[0] + 8, st[1]:st[1] + 8, st[2]:st[2] + 8])
    labels = [np.ascontiguousarray(v[..., 0] > 0).astype(np.uint8)
              for v in vols]
    lab = tnative.crop_batch_native(labels, starts, (8, 8, 8))
    _same(lab, np.stack([u[s[0]:s[0] + 8, s[1]:s[1] + 8, s[2]:s[2] + 8]
                         for u, s in zip(labels, starts)]))
    # volumes the kernel cannot take together: the caller's numpy path
    assert tnative.crop_batch_native([vols[0], labels[1]], starts[:2],
                                     (8, 8, 8)) is None
    assert tnative.crop_batch_native([], starts[:0], (8, 8, 8)) is None
    with pytest.raises(ValueError, match="outside"):
        tnative.crop_batch_native(vols[:1], np.asarray([[5, 0, 0]]),
                                  (8, 8, 8))


@pytest.mark.parametrize("mode", ["regions", "classes"])
def test_generator_native_crop_equals_numpy_crop_and_jax(tmp_path,
                                                         monkeypatch, mode):
    """Batches of volumes that hold a patch: one native call for the
    images and one for the labels, the numpy crop's bytes and the JAX
    generator's (whose native crop runs too)."""
    h5s, npzs = write_stores(str(tmp_path), shapes=((20, 18, 16),
                                                    (16, 14, 12),
                                                    (24, 20, 18)))
    cache = tpipe.PatientCache(npzs, mode)
    kw = dict(seed=7, augment=False)
    tnative.CALLS.clear()
    gen = tpipe.PatchGenerator(cache, (8, 8, 8), 3, **kw)
    native = [gen.next() for _ in range(2)]
    assert tnative.CALLS == {"crop_batch_bytes": 4}      # x and y, twice
    want = jpipe.PatchGenerator(jpipe.PatientCache(h5s, mode), (8, 8, 8), 3,
                                **kw)
    monkeypatch.setattr(tpipe, "crop_batch_native", lambda *a, **k: None)
    numpy_gen = tpipe.PatchGenerator(cache, (8, 8, 8), 3, **kw)
    for x, y in native:
        xn, yn = numpy_gen.next()
        xj, yj = want.next()
        for got, numpy_crop, jax_crop in ((x, xn, xj), (y, yn, yj)):
            _same(got, numpy_crop)
            _same(got, jax_crop)


def test_generator_keeps_numpy_where_the_jax_one_does(tmp_path):
    """Augmenting, or a volume smaller than the patch: no native call."""
    _, npzs = write_stores(str(tmp_path))      # P1 is 12×14×10
    tnative.CALLS.clear()
    for paths, aug, patch in ((npzs, True, (8, 8, 8)),
                              (npzs[1:2], False, (12, 12, 12))):
        g = tpipe.PatchGenerator(tpipe.PatientCache(paths), patch, 4, seed=1,
                                 augment=aug)
        for _ in range(3):
            g.next()
    assert not tnative.CALLS


def test_without_a_compiler_everything_falls_back(tmp_path, monkeypatch):
    """The JAX contract: no g++, no library, every function None, and
    preprocessing on the numpy path (the JAX numpy path's bits)."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_error", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "_build" / "lib.so")

    def no_gxx(cmd, **kw):
        raise FileNotFoundError(2, "No such file or directory", cmd[0])

    monkeypatch.setattr(subprocess, "run", no_gxx)
    assert not tnative.available()
    assert "g++" in tnative.build_error()
    vols, seg = _volumes(1)
    assert tnative.zscore_native(vols[0]) is None
    assert tnative.union_bbox_native(vols) is None
    assert tnative.crop_batch_native([vols[0]], np.zeros((1, 3), np.int64),
                                     (4, 4, 4)) is None
    got = tpre.preprocess_arrays(vols, seg)
    monkeypatch.setenv("NAS3D_NO_NATIVE", "1")
    for k, v in jpre.preprocess_arrays(vols, seg).items():
        _same(got[k], v)
    assert not os.path.exists(tmp_path / "_build" / "lib.so")
