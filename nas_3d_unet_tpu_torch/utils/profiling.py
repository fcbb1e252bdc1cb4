"""Tracing, memory and numerics-debug hooks.

Counterpart of `nas_3d_unet_tpu/utils/profiling.py`:
  * `trace(log_dir)`: a `torch.profiler` session (CPU activity, and the
    card's kernels where there is a card) written into `log_dir` as a
    TensorBoard-loadable trace (`<host>_<pid>.<ts>.pt.trace.json`, the
    profiler plugin's format; chrome://tracing and Perfetto read it too);
  * `annotate(name)`: a named range inside such traces
    (`record_function`), and an NVTX range where there is a card;
  * `device_memory_stats(device)`: the caching allocator's counters
    (`torch.cuda.memory_stats`: live, peak and reserved bytes and more);
    `{}` on the CPU;
  * `debug_nans(enable)`: raise `FloatingPointError` at the first op whose
    output holds a NaN, naming the op, in the forward and in the backward.

The reference's `start_server` (a live profiler endpoint for XLA) and
`log_compiles` (a line per XLA compilation) have no counterpart: the port
compiles nothing while it runs (its kernels are built once, by `nvcc`, at
first use), and `torch.profiler` has no server to attach to.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; the trace is written into `log_dir` on exit."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range visible in `trace`'s traces (and to NVTX tools)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def device_memory_stats(device: Optional[torch.device | str] = None
                        ) -> dict:
    """The caching allocator's counters for `device` (None: the current
    card), e.g. "allocated_bytes.all.peak"; `{}` for the CPU or without a
    card."""
    if not torch.cuda.is_available():
        return {}
    if device is not None and torch.device(device).type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))


# ops whose outputs are uninitialised memory: a NaN there is no fault
_UNCHECKED = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class _NanCheck(TorchDispatchMode):
    """Every op's floating outputs checked for NaN as it returns (one
    device sync an op)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNCHECKED:
            for t in _tensors(out):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"NaN in the output of {func} "
                        f"({tuple(t.shape)}, {t.dtype})")
        return out


_mode: Optional[_NanCheck] = None


def debug_nans(enable: bool = True) -> None:
    """From now on (until `debug_nans(False)`), raise `FloatingPointError`
    at the first op that outputs a NaN, forward ops included, on this
    thread; and autograd's anomaly mode with its NaN check, which names
    the backward function that made one and the forward line that
    recorded it.  Every op then waits for the device: for debugging."""
    global _mode
    if enable and _mode is None:
        _mode = _NanCheck()
        _mode.__enter__()
    elif not enable and _mode is not None:
        _mode.__exit__(None, None, None)
        _mode = None
    torch.autograd.set_detect_anomaly(enable, check_nan=enable)
