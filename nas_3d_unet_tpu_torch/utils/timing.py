"""Timing of device work with CUDA events.

Counterpart of `nas_3d_unet_tpu/utils/timing.py`, whose host-readback
fence works around a remote-TPU runtime.  Here CUDA events recorded on the
stream bracket the work, and the host waits on the closing event, so the
number is device time, not enqueue time.  There is no CPU fallback: a
device metric comes from the device or not at all.
"""

from __future__ import annotations

from typing import Callable

import torch


def cuda_ms(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of device time per call of `fn(*args)`."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters

