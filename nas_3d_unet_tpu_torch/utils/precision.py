"""The fp32 precision policy of the port.

The slice is fp32 end to end, like the reference's `infer.dtype`.  PyTorch
lets cuDNN convolutions (and, if enabled, cuBLAS matmuls) round their
inputs to TF32's 10 mantissa bits, which breaks parity with the reference
on the plain convs.  `strict_fp32()` turns both off for the work inside it
and restores the caller's settings on exit, so nothing else in the process
changes precision.
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
