"""The measuring probes, counterparts of the JAX era's `experiments/`.

    r3_dma_probe    E1: what bandwidth a hand-written copy reaches
                    (`experiments/r3_dma_probe.py`)
    r3_pg_variants  E2: five variants of K1's shifted-GEMM conv at the
                    level-0 geometry, on the tensor cores
                    (`experiments/r3_pg_variants.py`)

Each module holds its kernel wrappers (csrc/probes.cu) with their plain
twins, and a `main()` that runs on the card and prints JSON lines:
`python -m nas_3d_unet_tpu_torch.experiments.<name>`.  Importing runs
nothing.
"""

from __future__ import annotations

import torch


def require_card() -> torch.device:
    """The card a probe measures on; raises without one (a probe never
    measures the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure the card: no CUDA device")
    return torch.device("cuda", 0)
