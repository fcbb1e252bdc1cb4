"""The port (nas_3d_unet_tpu_torch/), the scripts that drive it on the
card (chip_smoke.py, profile_slice.py, grad_parity.py, ab_default_path.py)
and the ranks of its data-parallel and spatial-sharding tests
(tests/torch_dp_worker.py, tests/torch_spatial_worker.py) import no JAX
stack
and nothing of the JAX package: an AST scan of every import statement, top
level or inside a function.  `export_flax_params.py` is left out of the
scan on purpose: it reads a JAX checkpoint where flax is installed, and is
the one file beside the port that imports flax (held below)."""

import ast
import pathlib

import pytest
from tests.torch_helpers import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "nas_3d_unet_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "h5py", "yaml",
             "nas_3d_unet_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return sorted(PKG.rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "profile_slice.py",
                                 "grad_parity.py", "ab_default_path.py",
                                 "tests/torch_dp_worker.py",
                                 "tests/torch_spatial_worker.py")]


def test_scan_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"nas_3d_unet_tpu_torch/bridge.py",
            "nas_3d_unet_tpu_torch/ops/pgemm.py",
            "nas_3d_unet_tpu_torch/infer/predict.py",
            "nas_3d_unet_tpu_torch/io/nifti.py",
            "nas_3d_unet_tpu_torch/experiments/r3_dma_probe.py",
            "nas_3d_unet_tpu_torch/experiments/r3_pg_variants.py",
            "nas_3d_unet_tpu_torch/utils/config.py",
            "nas_3d_unet_tpu_torch/utils/logging.py",
            "nas_3d_unet_tpu_torch/utils/params.py",
            "nas_3d_unet_tpu_torch/utils/device.py",
            "nas_3d_unet_tpu_torch/data/preprocess.py",
            "nas_3d_unet_tpu_torch/data/pipeline.py",
            "nas_3d_unet_tpu_torch/data/native/_native.py",
            "nas_3d_unet_tpu_torch/utils/profiling.py",
            "nas_3d_unet_tpu_torch/train/checkpoint.py",
            "nas_3d_unet_tpu_torch/train/loop.py",
            "nas_3d_unet_tpu_torch/models/unet.py",
            "nas_3d_unet_tpu_torch/parallel/mesh.py",
            "nas_3d_unet_tpu_torch/parallel/spatial.py",
            "nas_3d_unet_tpu_torch/cli.py",
            "nas_3d_unet_tpu_torch/__main__.py",
            "chip_smoke.py", "profile_slice.py", "grad_parity.py",
            "tests/torch_dp_worker.py",
            "tests/torch_spatial_worker.py"} <= names
    assert "export_flax_params.py" not in names


def test_the_export_script_imports_flax_and_not_the_port():
    """It must run where flax is (reading a msgpack needs it) and stay out
    of the port, which never imports flax."""
    names = {n.split(".")[0] for n in _imports(ROOT / "export_flax_params.py")}
    assert "flax" in names
    assert not names & {"jax", "torch", "nas_3d_unet_tpu",
                        "nas_3d_unet_tpu_torch"}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_nifti_round_trips_through_the_jax_reader(tmp_path):
    """The port's writer, read back by the JAX package's reader: the same
    array, dtype and affine."""
    import numpy as np

    from nas_3d_unet_tpu.io.nifti import read_nifti as jax_read
    from nas_3d_unet_tpu_torch.io.nifti import read_nifti, write_nifti

    rng = np.random.default_rng(0)
    labels = rng.choice(np.array([0, 1, 2, 4], np.uint8), (7, 6, 5))
    affine = np.diag([1.5, 2.0, 0.5, 1.0]).astype(np.float32)
    affine[:3, 3] = [-10.0, 4.0, 2.5]
    for name, data in (("l.nii.gz", labels),
                       ("f.nii", rng.standard_normal((4, 3, 5))
                        .astype(np.float32))):
        path = str(tmp_path / name)
        write_nifti(path, data, affine)
        for img in (jax_read(path), read_nifti(path)):
            assert img.data.dtype == data.dtype
            np.testing.assert_array_equal(img.data, data)
            np.testing.assert_array_equal(img.affine, affine)
