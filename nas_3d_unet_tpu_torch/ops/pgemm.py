"""Conv / GEMM with GroupNorm raw moments: the counterpart of
`nas_3d_unet_tpu/ops/pallas/pgemm.py`.

Two kernels, each with its plain PyTorch twin and a launch count:

  K1 `conv3x3x3_stats(x, w, dilation)`: stride-1 3³ SAME conv on NDHWC with a
     DHWIO kernel (replaces `conv_pgemm` with its moments epilogue);
  K2 `gemm_stats(x3, w)`: `y = x3 @ w` over voxel rows, the 1³ conv
     (replaces `gemm_stats`).

Both return `(y, s1, s2)` with `s1 = Σy`, `s2 = Σy²` per (batch, channel)
over all voxels, fp32.  The JAX kernels work on the W-packed layout and
return packed moments `(B, r·C)`; these take logical tensors and return the
moments already folded to `(B, C)`.

Dispatch: a CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from .. import _build

# launches per kernel since the last `LAUNCHES.clear()`; only the kernel
# path counts, never the twin
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_declared: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _declared
    lib = _build.load()
    if _declared is not lib:
        lib.pgemm_row_block.argtypes = [_I]
        lib.pgemm_row_block.restype = _I
        lib.conv3x3x3_stats_f32.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        lib.conv3x3x3_stats_f32.restype = _I
        lib.gemm_stats_f32.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.gemm_stats_f32.restype = _I
        _declared = lib
    return lib


def moments(y: torch.Tensor):
    """(Σy, Σy²) over every axis but the first and last, in fp32."""
    dims = tuple(range(1, y.dim() - 1))
    return y.sum(dims), (y * y).sum(dims)


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name}: the kernel has no backward yet; run it "
                           "under torch.inference_mode()")
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: needs float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")


def _run(fn, name: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# K1: stride-1 3³ conv + moments
# ---------------------------------------------------------------------------


def conv3x3x3_stats_twin(x: torch.Tensor, w: torch.Tensor, dilation: int = 1):
    """Plain PyTorch K1: explicit SAME pad (= dilation per side at stride 1,
    `packed.py:123-128`), `F.conv3d`, then fp32 moments of y."""
    p = dilation
    xt = F.pad(x.permute(0, 4, 1, 2, 3), (p, p, p, p, p, p))
    y = F.conv3d(xt, w.permute(4, 3, 0, 1, 2), dilation=dilation)
    y = y.permute(0, 2, 3, 4, 1).contiguous()
    return (y, *moments(y))


def conv3x3x3_stats(x: torch.Tensor, w: torch.Tensor, dilation: int = 1):
    """(y, Σy, Σy²): x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout) →
    y (B, D, H, W, Cout) and moments (B, Cout), all fp32."""
    if x.dim() != 5 or w.shape[:3] != (3, 3, 3) or w.dim() != 5 \
            or w.shape[3] != x.shape[4]:
        raise ValueError(f"conv3x3x3_stats: x {tuple(x.shape)} "
                         f"w {tuple(w.shape)}")
    if dilation not in (1, 2):
        raise ValueError(f"conv3x3x3_stats: dilation {dilation}")
    if x.device.type == "cpu":
        return conv3x3x3_stats_twin(x, w, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3x3_stats: no kernel for {x.device}")
    _check_cuda("conv3x3x3_stats", x, w)
    b, d, h, wd, cin = x.shape
    cout = w.shape[4]
    if max(d, h, wd) >= 1024:   # the kernel packs (d, h, w) in 10-bit fields
        raise ValueError(f"conv3x3x3_stats: volume {(d, h, wd)} too large")
    lib = _lib()
    rows = d * h * wd
    nblk = -(-rows // lib.pgemm_row_block(cout))
    y = torch.empty((b, d, h, wd, cout), dtype=x.dtype, device=x.device)
    partial = torch.empty((b, nblk, 2, cout), dtype=x.dtype, device=x.device)
    s1 = torch.empty((b, cout), dtype=x.dtype, device=x.device)
    s2 = torch.empty_like(s1)
    _run(lib.conv3x3x3_stats_f32, "conv3x3x3_stats", x.device,
         x.data_ptr(), w.data_ptr(), y.data_ptr(), partial.data_ptr(),
         s1.data_ptr(), s2.data_ptr(), b, d, h, wd, cin, cout, dilation)
    return y, s1, s2


# ---------------------------------------------------------------------------
# K2: voxel-row GEMM + moments
# ---------------------------------------------------------------------------


def gemm_stats_twin(x3: torch.Tensor, w: torch.Tensor):
    """Plain PyTorch K2: `x3 @ w`, then fp32 moments of y."""
    y = x3 @ w
    return (y, *moments(y))


def gemm_stats(x3: torch.Tensor, w: torch.Tensor):
    """(y, Σy, Σy²): x3 (B, V, K), w (K, N) → y (B, V, N), moments (B, N)."""
    if x3.dim() != 3 or w.dim() != 2 or w.shape[0] != x3.shape[2]:
        raise ValueError(f"gemm_stats: x3 {tuple(x3.shape)} "
                         f"w {tuple(w.shape)}")
    if x3.device.type == "cpu":
        return gemm_stats_twin(x3, w)
    if x3.device.type != "cuda":
        raise ValueError(f"gemm_stats: no kernel for {x3.device}")
    _check_cuda("gemm_stats", x3, w)
    b, v, k = x3.shape
    n = w.shape[1]
    lib = _lib()
    nblk = -(-v // lib.pgemm_row_block(n))
    y = torch.empty((b, v, n), dtype=x3.dtype, device=x3.device)
    partial = torch.empty((b, nblk, 2, n), dtype=x3.dtype, device=x3.device)
    s1 = torch.empty((b, n), dtype=x3.dtype, device=x3.device)
    s2 = torch.empty_like(s1)
    _run(lib.gemm_stats_f32, "gemm_stats", x3.device,
         x3.data_ptr(), w.data_ptr(), y.data_ptr(), partial.data_ptr(),
         s1.data_ptr(), s2.data_ptr(), b, v, k, n)
    return y, s1, s2
