"""The port (nas_3d_unet_tpu_torch/) imports no JAX stack and nothing of
the JAX package but its numpy-only NIfTI module: an AST scan of every
import statement, top level or inside a function."""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "nas_3d_unet_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "h5py", "yaml"}
ALLOWED_FROM_JAX_PACKAGE = {"nas_3d_unet_tpu.io.nifti"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return sorted(PKG.rglob("*.py"))


def test_scan_sees_the_package():
    names = {p.relative_to(PKG).as_posix() for p in _sources()}
    assert {"bridge.py", "ops/pgemm.py", "infer/predict.py"} <= names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path}: imports {name}"
        if root == "nas_3d_unet_tpu":
            assert name in ALLOWED_FROM_JAX_PACKAGE, f"{path}: imports {name}"
