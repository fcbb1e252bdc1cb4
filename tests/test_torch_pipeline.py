"""The port's patch pipeline (nas_3d_unet_tpu_torch/data/pipeline.py)
against the JAX package's: the patient split, and every PatchGenerator
batch bitwise (values and dtype) for several (seed, step), both label
modes, host augmentation on and off, after `set_step` and `clone`; then
the Prefetcher's order, error propagation and close, on the CPU."""

import os
import threading

import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.data import pipeline as jpipe
from nas_3d_unet_tpu_torch.data import pipeline as tpipe
from nas_3d_unet_tpu_torch.metrics import dice as tdice
from nas_3d_unet_tpu.metrics import dice as jdice
from tests.torch_helpers import write_stores
from tests.torch_helpers import one_torch_thread  # noqa: F401

PATCH = (8, 8, 8)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return write_stores(str(tmp_path_factory.mktemp("stores")))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,frac,seed", [(1, 0.2, 0), (2, 0.5, 0),
                                         (5, 0.2, 3), (9, 0.34, 7)])
def test_split_patients_equal(n, frac, seed):
    paths = [f"/d/p{i:02d}.npz" for i in range(n)][::-1]
    assert tpipe.split_patients(paths, frac, seed) \
        == jpipe.split_patients(paths, frac, seed)


def test_numpy_label_helpers_equal():
    lab = np.random.default_rng(0).choice(
        np.array([0, 1, 2, 4], np.uint8), (5, 6, 7))
    _same(tdice.labels_to_regions_np(lab), jdice.labels_to_regions_np(lab))
    _same(tdice.labels_to_class_indices_np(lab),
          jdice.labels_to_class_indices_np(lab))


def _generators(stores, mode, augment, seed, batch=2):
    h5s, npzs = stores
    kw = dict(seed=seed, augment=augment, flip_prob=0.5,
              intensity_shift=0.1, intensity_scale=0.1)
    return (tpipe.PatchGenerator(tpipe.PatientCache(npzs, mode), PATCH,
                                 batch, **kw),
            jpipe.PatchGenerator(jpipe.PatientCache(h5s, mode), PATCH,
                                 batch, **kw))


@pytest.mark.parametrize("mode", ["regions", "classes"])
@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("seed", [0, 5])
def test_patch_batches_bitwise(stores, mode, augment, seed):
    port, ref = _generators(stores, mode, augment, seed)
    for _ in range(3):                                   # steps 0, 1, 2
        for a, b in zip(port.next(), ref.next()):
            _same(a, b)
    port.set_step(11)
    ref.set_step(11)
    for a, b in zip(port.next(), ref.next()):
        _same(a, b)
    pc, rc = port.clone(1000), ref.clone(1000)           # at step 12
    for _ in range(2):
        for a, b in zip(pc.next(), rc.next()):
            _same(a, b)
    for a, b in zip(port.next(), ref.next()):            # untouched: step 12
        _same(a, b)


def test_batch_of_three_with_padding(stores):
    port, ref = _generators(stores, "regions", True, 2, batch=3)
    for step in (0, 4):
        port.set_step(step)
        ref.set_step(step)
        x, y = port.next()
        assert x.shape == (3, *PATCH, 4) and y.shape == (3, *PATCH, 3)
        for a, b in zip((x, y), ref.next()):
            _same(a, b)


def test_prefetcher_hands_over_the_generator_order(stores):
    gen, _ = _generators(stores, "regions", True, 1)
    want, _ = _generators(stores, "regions", True, 1)
    pf = tpipe.Prefetcher(gen, torch.device("cpu"), depth=2)
    try:
        for _ in range(5):
            x, y = pf.next()
            wx, wy = want.next()
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            _same(x.numpy(), wx)
            _same(y.numpy(), wy)
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_raises_the_worker_error():
    class Broken:
        calls = 0

        def next(self):
            Broken.calls += 1
            if Broken.calls == 3:
                raise ValueError("bad patient")
            return np.zeros((1, 2, 2, 2, 4), np.float32), None

    pf = tpipe.Prefetcher(Broken(), torch.device("cpu"), depth=1)
    try:
        assert pf.next()[1] is None
        pf.next()
        with pytest.raises(RuntimeError, match="worker failed") as info:
            pf.next()
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_unblocks_a_full_queue(stores):
    gen, _ = _generators(stores, "classes", False, 0)
    pf = tpipe.Prefetcher(gen, torch.device("cpu"), depth=1)
    pf.next()
    done = threading.Event()
    t = threading.Thread(target=lambda: (pf.close(), done.set()))
    t.start()
    t.join(timeout=10)
    assert done.is_set() and not pf._thread.is_alive()


def test_dataset_paths(tmp_path):
    for name in ("b.npz", "a.npz", "c.h5", "d.npz.tmp", "e.npz"):
        (tmp_path / name).write_bytes(b"")
    all_ = tpipe.dataset_paths(str(tmp_path))
    assert [os.path.basename(p) for p in all_] == ["a.npz", "b.npz",
                                                   "e.npz"]
