"""E1: can a hand-written copy sustain the card's memory bandwidth?

    python -m nas_3d_unet_tpu_torch.experiments.r3_dma_probe [--seed N]

Counterpart of `experiments/r3_dma_probe.py` (the Pallas `copy_kernel`,
`pallas_call` at :28): `copy_rows` copies a 64 MiB (ROWS, LANES) bf16 array
with the kernel `copy_rows_bf16` (csrc/probes.cu), one block of
`rows_per_block` rows each, at every size in RPB: the TPU probe's 2048,
4096 and 8192 (0.5, 1 and 2 MiB blocks) and smaller ones, since 64 MiB in
2 MiB blocks is 32 blocks for the H100's 132 SMs.  One JSON line per size
with the TPU script's keys (`block_mb`, `ms`, `GB_s`, read + written bytes
over the time) and `bound_ms` (128 MiB at 3.35 TB/s) with the share of
3.35 TB/s reached; then two library lines: `dst.copy_(src)` and the
`x + 1` pass (the TPU script's XLA `y + 1` chain).  Every launch copies the
same pre-built x; the TPU script chained 16 copies to amortise its
dispatch, CUDA events time each launch on the device.  The TPU's
`dimension_semantics` (arbitrary or parallel) has no CUDA counterpart:
every CUDA grid runs its blocks in parallel, so each size runs once.
Raises without a card.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import _cuda
from ..utils.bounds import HBM_BYTES_PER_S, bound_ms
from . import require_card

ROWS, LANES = 128 * 2048, 128      # 64 MiB of bf16
RPB = (16, 64, 256, 2048, 4096, 8192)
ITERS = 16                          # launches per timing, as the TPU chain


def copy_rows_twin(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch E1: a copy."""
    return x.clone()


def copy_rows(x: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """E1: y = x for a (rows, lanes) tensor, lanes a multiple of 8, rows a
    multiple of rows_per_block; bf16 on the card, any dtype on the CPU."""
    if x.dim() != 2 or x.shape[1] % 8 or rows_per_block < 1 \
            or x.shape[0] % rows_per_block:
        raise ValueError(f"copy_rows: x {tuple(x.shape)}, rows_per_block "
                         f"{rows_per_block}")
    if _cuda.dispatch("copy_rows", x):
        return copy_rows_twin(x)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"copy_rows: needs contiguous bfloat16, got {x.dtype}")
    y = torch.empty_like(x)
    _cuda.run("copy_rows_bf16", x.device, x.data_ptr(), y.data_ptr(),
              x.shape[0], x.shape[1], rows_per_block)
    return y


def copy_bytes(x: torch.Tensor) -> int:
    """Bytes a copy of x moves: read once, written once."""
    return 2 * x.numel() * x.element_size()


def operand(seed: int, device) -> torch.Tensor:
    """The probe's array, N(0, 1) in bf16, from `seed` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((ROWS, LANES), generator=gen,
                       device=device).bfloat16()


def rate(x: torch.Tensor, ms: float) -> dict:
    """GB/s of one copy of x in `ms`, and its share of 3.35 TB/s."""
    gbs = copy_bytes(x) / (ms * 1e-3) / 1e9
    return {"GB_s": gbs, "share_of_3.35TB_s": gbs * 1e9 / HBM_BYTES_PER_S}


def sweep(x: torch.Tensor) -> list[dict]:
    """One record per rows-per-block: the kernel's time per copy of x."""
    from ..utils.timing import cuda_ms

    out = []
    for rpb in RPB:
        ms = cuda_ms(copy_rows, x, rpb, iters=ITERS, warmup=2)
        out.append({"block_mb": rpb * x.shape[1] * x.element_size() / 2 ** 20,
                    "rows_per_block": rpb, "blocks": x.shape[0] // rpb,
                    "ms": ms, **rate(x, ms),
                    "bound_ms": bound_ms(copy_bytes(x))[0]})
    return out


def library(x: torch.Tensor) -> list[dict]:
    """The same bytes moved by PyTorch: `dst.copy_(x)`, and `x + 1`."""
    from ..utils.timing import cuda_ms

    dst = torch.empty_like(x)
    ms_copy = cuda_ms(dst.copy_, x, iters=ITERS, warmup=2)
    ms_add = cuda_ms(torch.add, x, 1, iters=ITERS, warmup=2)
    return [{"library": "dst.copy_(x)", "ms": ms_copy, **rate(x, ms_copy)},
            {"add_one_ms": ms_add, **rate(x, ms_add)}]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    x = operand(args.seed, require_card())
    for rec in sweep(x) + library(x):
        print(json.dumps(rec), flush=True)
    print(json.dumps({"note": "dimension_semantics has no CUDA counterpart: "
                      "every grid runs its blocks in parallel"}), flush=True)


if __name__ == "__main__":
    main()
