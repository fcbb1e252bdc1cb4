"""Build the package's CUDA sources into one shared library, at first use.

`csrc/*.cu` are compiled by `nvcc` for Hopper (`sm_90a`) into a plain-C
shared library that `ctypes` loads: no PyTorch headers, so a cold build takes
seconds, not the minutes a `torch.utils.cpp_extension` build takes.  The
library lands in `_build/` beside this file (listed in .gitignore), named by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is compiled at import: the CPU path never
needs the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    # PyTorch's own toolkit discovery: CUDA_HOME/CUDA_PATH, nvcc on PATH,
    # then the toolkit's default install prefix
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnas3d_kernels_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The compiled kernels, building them first if the sources changed.

    The compiler's output (ptxas register and shared-memory report) is kept
    beside the library as `<name>.log`."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            _lib = ctypes.CDLL(str(so))
        return _lib


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cu = [str(p) for p in sorted(SRC_DIR.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(tmp), *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
