"""The least time the card could take for a piece of work.
Frozen copy of nas_3d_unet_tpu_torch/utils/bounds.py.

One H100 SXM at 700 W, from NVIDIA's data sheet (dense peaks): 3.35 TB/s
of HBM, 67 TFLOP/s fp32 on the FMA pipes, 989 TFLOP/s bf16 on the tensor
cores.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def bound_ms(nbytes: float, flops: float = 0.0,
             dtype: torch.dtype = torch.bfloat16) -> tuple[float, str]:
    """Bytes over HBM bandwidth or flops over the dtype's peak, whichever
    is larger, in ms, with what bounds it ("bytes" or "operations")."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
