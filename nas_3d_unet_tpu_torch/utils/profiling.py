"""Tracing, memory and numerics-debug hooks.

Counterpart of `nas_3d_unet_tpu/utils/profiling.py`:
  * `trace(log_dir)`: a `torch.profiler` session (CPU activity, and the
    card's kernels where there is a card) written into `log_dir` as a
    TensorBoard-loadable trace (`<host>_<pid>.<ts>.pt.trace.json`, the
    profiler plugin's format; chrome://tracing and Perfetto read it too);
  * `annotate(name)`: the port's span.  Every span is kept, as
    (name, thread id, start ns, end ns) on `time.perf_counter_ns`, in a
    bounded in-memory ring that `spans()` reads and `clear_spans()`
    empties; while a profiler runs, the span is also a named range in its
    trace (`record_function`).  Under `torch.autograd.profiler.emit_nvtx()`
    that range is an NVTX range, which is how Nsight tools see the spans.
    The ring holds what the trace cannot: a range opened on a thread that
    started before the profiler (the Prefetcher's workers, the patient
    writer) does not show in the trace;
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

import collections
import contextlib
import os
import threading
import time
from typing import Iterator, List, Optional, Tuple

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


# the newest spans, (name, thread id, start ns, end ns), in the order they
# closed: a 51-s serving window makes under 4,000
SPANS_MAXLEN = 65536
_SPANS: "collections.deque[Tuple[str, int, int, int]]" = collections.deque(
    maxlen=SPANS_MAXLEN)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A span: kept in the ring (`spans()`), and while a profiler runs a
    range in its trace."""
    t0 = time.perf_counter_ns()
    try:
        if torch.autograd.profiler._is_profiler_enabled:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        _SPANS.append((name, threading.get_ident(), t0,
                       time.perf_counter_ns()))


def spans() -> List[Tuple[str, int, int, int]]:
    """A copy of the ring, oldest span first (by the time it closed)."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


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
