"""The port's whole-volume inference (nas_3d_unet_tpu_torch/infer, metrics)
against the JAX package: the stitch bit for bit, the label decode, Dice,
uncrop and the patient loop's order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nas_3d_unet_tpu.infer import sliding as jsl
from nas_3d_unet_tpu.infer.predict import uncrop_labels as jax_uncrop
from nas_3d_unet_tpu.metrics import dice as jd
from nas_3d_unet_tpu_torch import bridge
from nas_3d_unet_tpu_torch.infer import sliding as tsl
from nas_3d_unet_tpu_torch.infer.predict import (predict_patient,
                                                 predict_records,
                                                 uncrop_labels)
from nas_3d_unet_tpu_torch.metrics import dice as td
from nas_3d_unet_tpu_torch.models.genotype import default_genotype
from nas_3d_unet_tpu_torch.models.unet import DerivedNet
from tests.test_golden import _GOLDEN, _golden_setup
from tests.test_sliding import _numpy_stitch_oracle
from tests.torch_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dim,patch,stride", [(10, 4, 2), (11, 4, 2),
                                              (4, 4, 2), (37, 16, 8),
                                              (160, 128, 64), (152, 128, 64)])
def test_grid_matches_jax(dim, patch, stride):
    assert tsl.grid_starts(dim, patch, stride) == jsl.grid_starts(dim, patch,
                                                                  stride)
    shape = (dim, dim + 3, max(patch, dim - 2))
    np.testing.assert_array_equal(
        tsl.grid_coords(shape, (patch,) * 3, (stride,) * 3),
        jsl.grid_coords(shape, (patch,) * 3, (stride,) * 3))


def test_stitch_bitexact_vs_numpy_oracle():
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((13, 11, 9, 4)).astype(np.float32)
    patch, k = (8, 8, 8), 3

    # an affine elementwise "model": correctly rounded IEEE ops, so torch and
    # numpy give bitwise-identical patch outputs and only the stitch differs
    def forward_t(x):
        return x[..., :k] * 0.5 + 0.25

    def forward_np(x):
        return x[..., :k] * np.float32(0.5) + np.float32(0.25)

    got = tsl.sliding_window_probs(forward_t, vol, patch, 0.5, batch_size=3,
                                   num_classes=k, device="cpu")
    pad = [max(0, p - s) for p, s in zip(patch, vol.shape[:3])]
    vpad = np.pad(vol, [(0, pad[0]), (0, pad[1]), (0, pad[2]), (0, 0)])
    want = _numpy_stitch_oracle(forward_np, vpad, patch, (4, 4, 4),
                                k)[:13, :11, :9]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_stitch_reproduces_frozen_golden():
    """The golden fixture's net (JAX, CPU) supplies the patch
    probabilities; the port's stitch must reproduce the frozen output
    exactly."""
    if jax.default_backend() != "cpu":
        pytest.skip("golden fixture frozen on the CPU backend")
    predictor, vol = _golden_setup()
    fwd = jax.jit(predictor.forward_probs)

    def forward_t(x):
        return torch.from_numpy(np.array(fwd(jnp.asarray(x.numpy()))))

    got = tsl.sliding_window_probs(forward_t, vol, predictor.patch_size,
                                   predictor.overlap, predictor.batch_size,
                                   predictor.num_classes, device="cpu")
    np.testing.assert_array_equal(got, np.load(_GOLDEN)["probs"])


@pytest.mark.parametrize("label_mode,k", [("regions", 3), ("classes", 4)])
def test_decode_matches_jax(label_mode, k):
    rng = np.random.default_rng(1)
    cnts = rng.integers(1, 9, (7, 6, 5, 1)).astype(np.float32)
    sums = (rng.random((7, 6, 5, k)) * cnts).astype(np.float32)
    sums[0, 0, 0] = 0.5 * cnts[0, 0, 0]          # exactly on the threshold
    crop = (6, 5, 4)
    want = jsl._decode_labels(jnp.asarray(sums), jnp.asarray(cnts), 0.5,
                              label_mode, crop)
    got = tsl.decode_labels(torch.from_numpy(sums), torch.from_numpy(cnts),
                            0.5, label_mode, crop)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dice_and_label_maps_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.choice(np.array([0, 1, 2, 4], np.uint8), (9, 8, 7))
    true = rng.choice(np.array([0, 1, 2, 4], np.uint8), (9, 8, 7))
    true[true == 4] = 2                    # an absent ET region
    tr = lambda a: td.labels_to_regions(torch.from_numpy(a))
    jr = lambda a: jd.labels_to_regions(jnp.asarray(a))
    np.testing.assert_array_equal(tr(pred).numpy(), np.asarray(jr(pred)))
    np.testing.assert_array_equal(
        td.region_dice(tr(pred), tr(true)).numpy(),
        np.asarray(jd.region_dice(jr(pred), jr(true))))
    probs = rng.random((9, 8, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        td.regions_to_labels(torch.from_numpy(probs)).numpy(),
        np.asarray(jd.regions_to_labels(jnp.asarray(probs))))
    idx = rng.integers(0, 4, (9, 8, 7))
    np.testing.assert_array_equal(
        td.class_indices_to_labels(torch.from_numpy(idx)).numpy(),
        np.asarray(jd.class_indices_to_labels(jnp.asarray(idx))))
    np.testing.assert_array_equal(
        uncrop_labels(pred, np.array([1, 2, 3]), np.array([12, 11, 13])),
        jax_uncrop(pred, np.array([1, 2, 3]), np.array([12, 11, 13])))


def _predictor():
    net = DerivedNet(default_genotype(2), base_channels=4, depth=2,
                     n_nodes=2, gn_groups=4)
    bridge.load_flax_params(net, bridge.random_flax_params(net, seed=3))
    return tsl.SlidingWindowPredictor(net, (8, 8, 8), overlap=0.5,
                                      batch_size=2, num_classes=3)


def test_predict_records_keeps_patient_order(tmp_path):
    from nas_3d_unet_tpu_torch.io.nifti import read_nifti

    predictor = _predictor()
    rng = np.random.default_rng(4)
    recs = []
    for i, shape in enumerate([(12, 10, 9), (9, 8, 8), (11, 12, 10)]):
        recs.append({
            "patient": f"p{i}",
            "image": rng.standard_normal((*shape, 4)).astype(np.float32),
            "label": rng.choice(np.array([0, 2, 4], np.uint8), shape),
            "crop_start": np.array([1, 0, 2]),
            "orig_shape": np.array([shape[0] + 2, shape[1], shape[2] + 3]),
        })
    out = predict_records(predictor, [(r["patient"], r) for r in recs],
                          out_dir=str(tmp_path), verbose=False)
    assert [r["patient"] for r in out] == ["p0", "p1", "p2"]
    for rec, res in zip(recs, out):
        seq = predict_patient(predictor, rec)
        assert seq["dice"] == res["dice"]
        assert all(np.isfinite(v) for v in res["dice"].values())
        labels = read_nifti(res["output"]).data
        assert labels.shape == tuple(rec["orig_shape"])
        assert set(np.unique(labels)) <= {0, 1, 2, 4}
        # the device decode agrees with thresholding the stitched probs
        probs = predictor.predict_volume(rec["image"])
        want = td.regions_to_labels(torch.from_numpy(probs)).numpy()
        np.testing.assert_array_equal(
            labels, uncrop_labels(want, rec["crop_start"], rec["orig_shape"]))


def test_entry_points_default_to_the_card():
    """No device means the card: without one the stitch raises rather
    than run on the CPU."""
    vol = np.zeros((8, 8, 8, 4), np.float32)

    def fwd(x):
        return x[..., :3]

    if torch.cuda.is_available():
        assert tsl.resolve_device(None).type == "cuda"
        return
    for fn in (tsl.sliding_window_probs, tsl.sliding_window_labels):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(fwd, vol, (8, 8, 8), num_classes=3)
    assert tsl.resolve_device("cpu") == torch.device("cpu")


def test_predictor_scopes_the_fp32_policy():
    """TF32 is off while the predictor runs and the caller's settings are
    back afterwards; building a predictor changes nothing."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    seen = []
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        predictor = _predictor()
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        forward = predictor.forward_probs

        def noting(patches):
            seen.append((cudnn.allow_tf32, matmul.allow_tf32))
            return forward(patches)

        predictor.forward_probs = noting
        vol = np.random.default_rng(5).standard_normal((9, 8, 8, 4))
        predictor.predict_labels(vol.astype(np.float32))
        predictor.predict_volume(vol.astype(np.float32))
        assert seen and set(seen) == {(False, False)}
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
