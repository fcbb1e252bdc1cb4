"""The fp32 precision policy of the port.

The slice is fp32 end to end, like the reference's `infer.dtype`.  PyTorch
lets cuDNN convolutions (and, if enabled, cuBLAS matmuls) round their
inputs to TF32's 10 mantissa bits, which breaks parity with the reference
on the plain convs.  `strict_fp32()` turns both off for the work inside it
and restores the caller's settings on exit, so nothing else in the process
changes precision.  `same_policy()` captures the settings in force as a
context that reinstates them: activation checkpointing recomputes a
forward inside the backward under the forward's settings with it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def strict_fp32() -> Iterator[None]:
    """Within the block, fp32 convs and matmuls do not round through TF32."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _settings() -> tuple:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
            cudnn.benchmark)


def _set(settings: tuple) -> None:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
     cudnn.benchmark) = settings


class same_policy:
    """Captures the TF32 switches and cuDNN's algorithm choice
    (`deterministic`, `benchmark`) in force when it is made, and
    reinstates them for each block it is entered for (re-entrant: a
    recompute may run once per backward)."""

    def __init__(self):
        self._now = _settings()
        self._saved: list = []

    def __enter__(self) -> None:
        self._saved.append(_settings())
        _set(self._now)

    def __exit__(self, *exc) -> None:
        _set(self._saved.pop())
