"""E2: where does K1's time go at the level-0 geometry?

    python -m nas_3d_unet_tpu_torch.experiments.r3_pg_variants [--seed N]
        [--variants nodot,c6,full,mt4,fold1536]

Counterpart of `experiments/r3_pg_variants.py` (`pallas_call` at :129):
five variants of K1's shifted-GEMM conv on NB planes of (HP·WP, RC)
rows, each a kernel of csrc/probes.cu with its dots on the tensor cores
(`pg_<variant>_bf16`).  With P_k = clip(bd + k, 0, NB − 1) (a clip, not a
zero pad: the last planes re-read plane NB − 1) and y (NB, M, RC):

  full      y[bd] = Σ_{kh<3} Σ_{k<3} x[P_k, kh·WP : kh·WP+M] @ ac[k, kh]
                                    + xe[P_k, kh·WP : kh·WP+M] @ ae[k, kh]
            (18 dots: 9 centre with K = RC, 9 edge with K = KE)
  c6        kh < 2, centre terms only (6 dots, two thirds of the flops)
  nodot     y[bd] = x[P_1, WP : WP+M] (data movement only)
  mt4       full, with a quarter of the M-tile per block
  fold1536  y[bd] = xcat @ ac2, xcat = [9 centre slices in (kh, k) order |
            9 edge slices in (kh, k) order | zeros to 1536 columns]

accumulated in fp32 and rounded once to bf16.  The TPU script's single x
and xe passed three times become one x and one xe; its module-global ac2
becomes an input.  `main()` prints the TPU script's `{variant: ms}` line
per variant with the bound beside it, a line for `full_parallel` (no CUDA
counterpart of its dimension semantics), and a library line for each
variant (`LIBRARY`): nodot's gather, and for the others the
`torch.matmul` of a pre-built concat of the variant's slices with its
stacked weight tiles (fold1536: its own concat with ac2), the GEMM alone.
Every launch reads the same pre-built operands.  Raises without a card.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..utils.bounds import bound_ms
from . import require_card

NB, HP, WP, RC, KE = 128, 130, 16, 128, 32
H = 128
M = H * WP
FOLD_K = 1536
VARIANTS = ("nodot", "c6", "full", "mt4", "fold1536")
ITERS = 10
KERNEL_TILE_M = 128      # the kernels take M in multiples of this


def planes(nb: int, k: int, device=None) -> torch.Tensor:
    """P_k for every plane: clip(bd + k, 0, nb − 1)."""
    return torch.clamp(torch.arange(nb, device=device) + k, 0, nb - 1)


def _check(variant, x, xe, ac, ae, ac2, wp) -> int:
    """The rows M of y; raises on operands the variant cannot take."""
    if variant not in VARIANTS:
        raise ValueError(f"pg: variant {variant!r} not in {VARIANTS}")
    if x.dim() != 3 or xe.dim() != 3 or xe.shape[:2] != x.shape[:2]:
        raise ValueError(f"pg: x {tuple(x.shape)}, xe {tuple(xe.shape)}")
    nb, rows, rc = x.shape
    ke = xe.shape[2]
    m = rows - 2 * wp
    if wp < 1 or m < 1:
        raise ValueError(f"pg: {rows} rows per plane, WP {wp}")
    if ac.shape != (3, 3, rc, rc) or ae.shape != (3, 3, ke, rc):
        raise ValueError(f"pg: ac {tuple(ac.shape)}, ae {tuple(ae.shape)}")
    if variant == "fold1536" and (ac2 is None or ac2.shape != (FOLD_K, rc)
                                  or 9 * (rc + ke) > FOLD_K):
        raise ValueError(f"pg: fold1536 needs ac2 ({FOLD_K}, {rc})")
    return m


def xcat(x: torch.Tensor, xe: torch.Tensor, wp: int) -> torch.Tensor:
    """fold1536's operand (NB, M, 1536) in x's dtype: the 9 centre slices,
    then the 9 edge slices, each in (kh, k) order, then zero columns."""
    nb, rows, _ = x.shape
    m = rows - 2 * wp
    cols = [t[planes(nb, k, t.device), kh * wp:kh * wp + m]
            for t in (x, xe) for kh in range(3) for k in range(3)]
    cat = torch.cat(cols, dim=-1)
    return F.pad(cat, (0, FOLD_K - cat.shape[-1]))


def pg_twin(variant: str, x, xe, ac, ae, ac2, wp: int) -> torch.Tensor:
    """Plain PyTorch E2: fp32 matmuls per term, in the reference's term
    order (`k_full`: for kh, for k, centre then edge), rounded once."""
    m = _check(variant, x, xe, ac, ae, ac2, wp)
    nb = x.shape[0]
    if variant == "nodot":
        return x[planes(nb, 1, x.device), wp:wp + m]
    if variant == "fold1536":
        return (xcat(x, xe, wp).float() @ ac2.float()).to(x.dtype)
    xf, xef = x.float(), xe.float()
    n_kh, edge = (2, False) if variant == "c6" else (3, True)
    y = None
    for kh in range(n_kh):
        for k in range(3):
            p = planes(nb, k, x.device)
            t = xf[p, kh * wp:kh * wp + m] @ ac[k, kh].float()
            y = t if y is None else y + t
            if edge:
                y = y + xef[p, kh * wp:kh * wp + m] @ ae[k, kh].float()
    return y.to(x.dtype)


def pg(variant: str, x, xe, ac, ae, ac2, wp: int) -> torch.Tensor:
    """E2's `variant` on x (NB, HP·WP, RC), xe (NB, HP·WP, KE), ac (3, 3,
    RC, RC), ae (3, 3, KE, RC), ac2 (1536, RC) (fold1536 only; else may be
    None) → y (NB, HP·WP − 2·WP, RC).  The kernels take bf16 with RC = 128,
    KE = 32 and M a multiple of 128; the CPU twin any shape."""
    m = _check(variant, x, xe, ac, ae, ac2, wp)
    name = f"pg_{variant}"
    if _cuda.dispatch(name, x, xe, ac, ae):
        return pg_twin(variant, x, xe, ac, ae, ac2, wp)
    ts = (x, xe, ac, ae) + (() if ac2 is None else (ac2,))
    if _cuda.check(name, *ts) != "bf16":
        raise TypeError(f"{name}: needs bfloat16, got {x.dtype}")
    nb, rows, rc = x.shape
    if rc != 128 or xe.shape[2] != 32 or m % KERNEL_TILE_M:
        raise ValueError(f"{name}: the kernel takes RC 128, KE 32, M a "
                         f"multiple of {KERNEL_TILE_M}; got {rc}, "
                         f"{xe.shape[2]}, {m}")
    y = torch.empty((nb, m, rc), dtype=x.dtype, device=x.device)
    w, we = (ac2, None) if variant == "fold1536" else (ac, ae)
    _cuda.run(f"{name}_bf16", x.device, x.data_ptr(), xe.data_ptr(),
              _cuda.ptr(w), _cuda.ptr(we), y.data_ptr(), nb, rows, wp, m)
    return y


def work(variant: str, nb: int = NB, hp: int = HP, wp: int = WP,
         rc: int = RC, ke: int = KE) -> tuple[float, float]:
    """(flops, bytes) of one call: 2·M·K·N per dot, each input byte the
    variant needs read once (the rows and planes it reads, the weight
    tiles it uses), y written once.  fold1536 computes full's function:
    its 96 zero columns of xcat (and the rows of ac2 they meet) cannot
    change y, so it is counted at full's K = 9·(RC + KE)."""
    m = (hp - 2) * wp
    e = 2                                             # bf16
    out = nb * m * rc * e
    if variant == "nodot":
        return 0.0, float(len(set(planes(nb, 1).tolist())) * m * rc * e + out)
    if variant == "c6":
        return (float(nb * 6 * 2 * m * rc * rc),
                float(nb * (m + wp) * rc * e + 6 * rc * rc * e + out))
    x_in = nb * hp * wp * (rc + ke) * e
    return (float(nb * 9 * 2 * m * rc * (rc + ke)),
            float(x_in + 9 * (rc + ke) * rc * e + out))


LIBRARY = {"nodot": "the gather x[P_1, WP:WP+M], P_1 pre-built",
           "c6": "torch.matmul of the pre-built (NB*M, 6*RC) concat of its "
                 "6 centre slices with their stacked ac tiles, the GEMM "
                 "alone",
           "full": "torch.matmul of the pre-built (NB*M, 9*(RC+KE)) concat "
                   "of its 18 slices with their stacked ac and ae tiles, "
                   "the GEMM alone",
           "mt4": "as full (the same function)",
           "fold1536": "torch.matmul of the pre-built (NB*M, 1536) concat "
                       "with ac2, the GEMM alone"}


def _folded(x, xe, ac, ae, wp: int, n_kh: int, edge: bool):
    """(the concat of a shifted variant's slices (NB·M, K), its tiles
    stacked (K, RC)): the centre terms in (kh, k) order, then the edge
    terms, so that one GEMM computes the variant."""
    nb, rows, _ = x.shape
    m = rows - 2 * wp
    srcs = [(x, ac)] + ([(xe, ae)] if edge else [])
    cols = [t[planes(nb, k, t.device), kh * wp:kh * wp + m]
            for t, _ in srcs for kh in range(n_kh) for k in range(3)]
    tiles = [a[k, kh] for _, a in srcs for kh in range(n_kh)
             for k in range(3)]
    return (torch.cat(cols, dim=-1).reshape(nb * m, -1),
            torch.cat(tiles, dim=0))


def library(variant: str, x, xe, ac, ae, ac2, wp: int):
    """One PyTorch call computing `variant` on operands built beforehand
    (`LIBRARY` says which), as a callable that ignores its arguments."""
    m = x.shape[1] - 2 * wp
    if variant == "nodot":
        p1 = planes(x.shape[0], 1, x.device)
        return lambda *_: x[p1, wp:wp + m]
    if variant == "fold1536":
        a = xcat(x, xe, wp).reshape(-1, FOLD_K)
        return lambda *_: torch.matmul(a, ac2)
    a, b = _folded(x, xe, ac, ae, wp, *((2, False) if variant == "c6"
                                        else (3, True)))
    return lambda *_: torch.matmul(a, b)


def operands(seed: int, device, nb: int = NB, hp: int = HP, wp: int = WP,
             rc: int = RC, ke: int = KE):
    """(x, xe, ac, ae, ac2) in bf16 on `device` from `seed`, at the TPU
    script's scales (weights · 0.05)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).bfloat16()

    return (rand(nb, hp * wp, rc), rand(nb, hp * wp, ke),
            rand(3, 3, rc, rc, scale=0.05), rand(3, 3, ke, rc, scale=0.05),
            rand(FOLD_K, rc, scale=0.05))


def main(argv=None) -> None:
    from ..utils.timing import cuda_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    ops = operands(args.seed, require_card())
    for v in args.variants.split(","):
        ms = cuda_ms(pg, v, *ops, WP, iters=ITERS, warmup=2)
        flops, nbytes = work(v)
        b, by = bound_ms(nbytes, flops)
        print(json.dumps({v: ms, "bound_ms": b, "bound_by": by,
                          "TFLOP_s": flops / ms / 1e9,
                          "GB_s": nbytes / ms / 1e6}), flush=True)
    print(json.dumps({"full_parallel": None, "note": "the same kernel as "
                      "full: CUDA has no dimension semantics, every grid "
                      "runs its blocks in parallel"}), flush=True)
    for v, what in LIBRARY.items():
        ms = cuda_ms(library(v, *ops, WP), iters=ITERS, warmup=2)
        print(json.dumps({"library": v, "call": what, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
