"""What every kernel wrapper shares: the launch count, the checks on the
tensors it hands a kernel, and the launch itself.

A wrapper takes its kernel's plain twin for a CPU tensor and launches the
kernel for a CUDA tensor, or raises: there is no fallback from one to the
other.  `LAUNCHES` counts kernel launches by name (`<kernel>_<f32|bf16>`),
only on the kernel path, never the twin's.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .. import _build

# launches per kernel since the last `LAUNCHES.clear()`
LAUNCHES: collections.Counter = collections.Counter()

SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

P = ctypes.c_void_p
I = ctypes.c_int
# C signatures: name -> (pointer args, int args), each returning cudaError_t;
# the stream comes last
_SIGNATURES = {}
for _t in SUFFIX.values():
    _SIGNATURES.update({
        f"conv3x3x3_stats_{_t}": (6, 7), f"conv3x3x3_{_t}": (6, 7),
        f"gemm_stats_{_t}": (6, 4),
        f"moments_{_t}": (2, 10), f"weighted_sums_{_t}": (3, 10),
        f"weighted_sums_masked_{_t}": (4, 10),
        f"conv3d_{_t}": (4, 12), f"pointwise_conv_{_t}": (4, 4),
        f"conv_transpose2x_{_t}": (3, 7),
        f"group_norm_apply_{_t}": (4, 5), f"group_norm_dx_{_t}": (7, 5)})
# the probes (csrc/probes.cu), bf16 only
_SIGNATURES["copy_rows_bf16"] = (2, 3)
for _v in ("full", "c6", "nodot", "mt4", "fold1536"):
    _SIGNATURES[f"pg_{_v}_bf16"] = (5, 4)
_declared: ctypes.CDLL | None = None
_fns: dict = {}          # name -> the library's ctypes function


def lib() -> ctypes.CDLL:
    """The compiled kernels, with every function's ctypes signature set."""
    global _declared
    lib_ = _build.load()
    if _declared is not lib_:
        for tile in ("conv_mma", "conv_fma"):
            getattr(lib_, f"{tile}_plan").argtypes = (
                [I] * 4 + [ctypes.POINTER(I)])
            getattr(lib_, f"{tile}_plan").restype = I
            getattr(lib_, f"{tile}_blocks").argtypes = [I] * 6
            getattr(lib_, f"{tile}_blocks").restype = I
        lib_.gemm_mma_plan.argtypes = [I] * 4 + [ctypes.POINTER(I)]
        lib_.gemm_mma_plan.restype = I
        lib_.gemm_fma_plan.argtypes = [I] * 4 + [ctypes.POINTER(I)]
        lib_.gemm_fma_plan.restype = I
        for fn, (n_ptr, n_int) in _SIGNATURES.items():
            getattr(lib_, fn).argtypes = [P] * n_ptr + [I] * n_int + [P]
            getattr(lib_, fn).restype = I
        _declared = lib_
        _fns.clear()
    return lib_


def dispatch(name: str, *ts: torch.Tensor) -> bool:
    """True for CPU tensors (take the twin), False for CUDA (launch the
    kernel); raises for any other device."""
    dev = ts[0].device
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    return False


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device address for ctypes; None (a null pointer) for an
    absent optional input."""
    return None if t is None else t.data_ptr()


def check(name: str, *ts: torch.Tensor) -> str:
    """The element-type suffix of tensors a kernel takes: one device, one
    dtype (fp32 or bf16), contiguous.  One pass where every test passes;
    the error is worked out only where one fails."""
    dev, dtype = ts[0].device, ts[0].dtype
    suffix = SUFFIX.get(dtype)
    for t in ts:
        if suffix is None or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            if t.device != dev:
                raise ValueError(f"{name}: tensors on {t.device} and {dev}")
            if t.dtype != dtype or suffix is None:
                raise TypeError(f"{name}: needs float32 or bfloat16 "
                                f"throughout, got {t.dtype} and {dtype}")
            raise ValueError(f"{name}: needs contiguous tensors")
    return suffix


def run(fn: str, dev: torch.device, *args) -> None:
    """Launch `fn(*args, stream)` on `dev`'s current stream; count it.  The
    ctypes function is looked up once per name; the device is made current
    only where it is not already."""
    f = _fns.get(fn)
    if f is None:
        f = _fns[fn] = getattr(lib(), fn)
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = f(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = f(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")
    LAUNCHES[fn] += 1
