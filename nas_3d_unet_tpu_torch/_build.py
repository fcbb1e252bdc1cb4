"""Build the package's CUDA sources into one shared library, at first use.

`csrc/*.cu` are compiled by `nvcc` for Hopper (`sm_90a`), one `nvcc -c`
per source, all started together, then linked into a plain-C shared library
that `ctypes` loads: no PyTorch headers, so a cold build takes seconds, not
the minutes a `torch.utils.cpp_extension` build takes.  The
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

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
NVCC_FLAGS = ARCH_FLAGS + ("-Xptxas", "-v")      # per source, with `-c`

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
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    cu = sorted(SRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o", str(o),
             str(p)] for p, o in zip(cu, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]      # waits for every one
    tmp = so.with_name(f"{tag}.tmp.so")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        outs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed.append((link, proc.stdout + proc.stderr))
    so.with_suffix(".log").write_text("".join(
        " ".join(c) + "\n" + o for c, o in zip(cmds + [link], outs)))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            " ".join(c) + "\n" + o for c, o in failed))
    os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
