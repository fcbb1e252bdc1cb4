"""Parameter counting (counterpart of `nas_3d_unet_tpu/utils/params.py`)."""

from __future__ import annotations

from torch import nn


def count_params(module: nn.Module) -> int:
    """Total scalar parameter count of `module`."""
    return sum(p.numel() for p in module.parameters())

