"""The port's preprocessing (nas_3d_unet_tpu_torch/data/preprocess.py)
against the JAX package's numpy path (NAS3D_NO_NATIVE=1): every array of a
patient's `.npz` equals, bit for bit and dtype for dtype, the one the JAX
package writes to HDF5, for single patients and for the HGG/LGG walk."""

import os

import numpy as np
import pytest

from nas_3d_unet_tpu.data import preprocess as jpre
from nas_3d_unet_tpu_torch.data import preprocess as tpre
from tests.torch_helpers import write_raw_patients

KEYS = ("image", "label", "crop_start", "orig_shape", "affine")


@pytest.fixture(autouse=True)
def _numpy_reference(monkeypatch):
    monkeypatch.setenv("NAS3D_NO_NATIVE", "1")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert a.tobytes() == b.tobytes()


def _volumes(seed, shape=(14, 12, 10)):
    rng = np.random.default_rng(seed)
    vols = []
    for i in range(4):
        v = np.zeros(shape, np.float32)
        v[2 + i % 2:11, 1:10, 3:9 - i % 3] = (
            rng.standard_normal((9 - i % 2, 9, 6 - i % 3)) * 40 + 300)
        vols.append(v)
    seg = rng.choice(np.array([0, 1, 2, 4], np.uint8), shape)
    return vols, seg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preprocess_arrays_bitwise(seed):
    vols, seg = _volumes(seed)
    port, ref = tpre.preprocess_arrays(vols, seg), \
        jpre.preprocess_arrays(vols, seg)
    assert set(port) == set(ref)
    for k in ref:
        _same(port[k], ref[k])
    for v in vols:
        _same(tpre.zscore_in_mask(v), jpre.zscore_in_mask(v))
        mask = v > 300
        _same(tpre.zscore_in_mask(v, mask), jpre.zscore_in_mask(v, mask))
        assert tpre.foreground_bbox(v != 0) == jpre.foreground_bbox(v != 0)


def test_empty_and_constant_volumes():
    zero = np.zeros((5, 4, 3), np.float32)
    const = np.full((5, 4, 3), 7.0, np.float32)
    for v in (zero, const):
        _same(tpre.zscore_in_mask(v), jpre.zscore_in_mask(v))
        assert tpre.foreground_bbox(v != 0) == jpre.foreground_bbox(v != 0)


@pytest.mark.parametrize("ext", [".nii.gz", ".nii"])
def test_patient_file_equals_the_h5(tmp_path, ext):
    (pdir,) = write_raw_patients(str(tmp_path / "raw"), n=1, ext=ext)
    h5 = jpre.preprocess_patient(pdir, str(tmp_path / "p.h5"))
    out = str(tmp_path / "p.npz")
    assert tpre.preprocess_patient(pdir, out) == out
    port, ref = tpre.load_patient(out), jpre.load_patient_h5(h5)
    for k in KEYS:
        _same(port[k], ref[k])
    assert port["patient"] == ref["patient"] == os.path.basename(pdir)
    with np.load(out) as f:
        assert str(f["modalities"]) == "t1,t1ce,t2,flair"
    assert sorted(os.listdir(tmp_path)) == ["p.h5", "p.npz", "raw"]


def test_dataset_walk_equals_the_reference(tmp_path):
    raw = str(tmp_path / "raw")
    write_raw_patients(raw, n=4, seed=3)
    assert [os.path.relpath(p, raw) for p in tpre.list_patient_dirs(raw)] \
        == [os.path.relpath(p, raw) for p in jpre.list_patient_dirs(raw)]
    h5s = jpre.preprocess_dataset(raw, str(tmp_path / "h5"))
    npzs = tpre.preprocess_dataset(raw, str(tmp_path / "npz"), workers=2)
    assert [os.path.basename(p)[:-4] for p in npzs] \
        == [os.path.basename(p)[:-3] for p in h5s]
    for a, b in zip(npzs, h5s):
        port, ref = tpre.load_patient(a), jpre.load_patient_h5(b)
        for k in KEYS:
            _same(port[k], ref[k])
    assert not [n for n in os.listdir(tmp_path / "npz")
                if not n.endswith(".npz")]


def test_missing_modality_raises(tmp_path):
    (pdir,) = write_raw_patients(str(tmp_path / "raw"), n=1)
    os.remove(os.path.join(pdir, os.path.basename(pdir) + "_t2.nii.gz"))
    with pytest.raises(FileNotFoundError, match="t2"):
        tpre.preprocess_patient(pdir, str(tmp_path / "p.npz"))
    assert sorted(os.listdir(tmp_path)) == ["raw"]


def test_write_is_atomic_whatever_the_name(tmp_path):
    """np.savez given a path appends ".npz" where it is missing; the
    temporary file must still be the one published, under the exact name,
    with nothing left beside it."""
    (pdir,) = write_raw_patients(str(tmp_path / "raw"), n=1)
    for name in ("p.npz", "p.store", "plain"):
        out = str(tmp_path / name)
        tpre.preprocess_patient(pdir, out)
        assert os.path.isfile(out)
        assert tpre.load_patient(out)["image"].dtype == np.float32
    assert sorted(os.listdir(tmp_path)) == ["p.npz", "p.store", "plain",
                                           "raw"]
