"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """`device` as a `torch.device`.  None or "cuda" means the card: an
    entry point runs on the CPU only when the caller asks, and without a
    card it raises instead of falling back."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to run on the CPU")
    if device is None or torch.device(device).index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
