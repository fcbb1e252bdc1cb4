#!/usr/bin/env python3
"""Time the default path of the port in one checkout, to compare two
checkouts on one NVIDIA GPU.

    python3 ab_default_path.py ROOT

ROOT is the root of a checkout (it holds `chip_smoke.py` and
`nas_3d_unet_tpu_torch/`); its kernels are built from its own sources and
its own `chip_smoke.py` helpers make the net and the data.  Prints one
JSON line:
  k1_ms, k1dx_ms, k2_ms  K1, K1-dx and K2 summed over chip_smoke.py's
                         geometries: fp32 per flagship forward (batch 2),
                         bf16 per train step (two microbatches of 1);
  digests                SHA-256 of K1's (y, Σy, Σy²), K1-dx's y and
                         K2's (y, Σy, Σy²) at fixed seeds;
  s_per_patient          3 synthetic patients after one warm-up, as
                         chip_smoke.py's phase "slice" serves them;
  patches_per_s          5 bf16 train steps after 3 warm-up, as its
                         phase "train" takes them.
Run it for two checkouts in turns (A, B, B, A) in one call: equal digests
mean the kernels compute the same bits.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import torch


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        t = t.detach().cpu().contiguous()
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("ab_default_path: no CUDA device; nothing measured",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    import nas_3d_unet_tpu_torch as pkg
    from nas_3d_unet_tpu_torch import _build
    from nas_3d_unet_tpu_torch.infer.predict import predict_records
    from nas_3d_unet_tpu_torch.ops import pgemm
    from nas_3d_unet_tpu_torch.train.loop import make_train_step
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer
    from nas_3d_unet_tpu_torch.utils.precision import strict_fp32
    from nas_3d_unet_tpu_torch.utils.timing import cuda_ms

    if not pkg.__file__.startswith(root):
        raise AssertionError(f"imported {pkg.__file__}, not from {root}")
    _build.library_path().unlink(missing_ok=True)
    _build.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"root": sys.argv[1], "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0],
        "digests": {}}
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    with strict_fp32(), torch.no_grad():
        for dtype, batch, per in ((torch.float32, cs.BATCH, 1),
                                  (torch.bfloat16, cs.MICRO, 2)):
            t1 = t1dx = t2 = 0.0
            for cin, cout, v, dil, n in cs.K1_GEOMS:
                key = f"{cin}_{cout}_{v}_{dil}_{dtype}"
                x = rand(batch, v, v, v, cin).to(dtype)
                w = (rand(3, 3, 3, cin, cout) * (27 * cin) ** -0.5).to(dtype)
                t1 += per * n * cuda_ms(pgemm.conv3x3x3_stats, x, w, dil)
                out["digests"]["k1_" + key] = _digest(
                    *pgemm.conv3x3x3_stats(x, w, dil))
                if cin != 4:         # no dx for the stem
                    dy = rand(batch, v, v, v, cout).to(dtype)
                    wt = pgemm.flip_transpose(w)
                    t1dx += per * n * cuda_ms(pgemm.conv3x3x3, dy, wt, dil)
                    out["digests"]["k1dx_" + key] = _digest(
                        pgemm.conv3x3x3(dy, wt, dil))
            for k, nn, v, n in cs.K2_GEOMS:
                x = rand(batch, v ** 3, k).to(dtype)
                w = (rand(k, nn) * k ** -0.5).to(dtype)
                t2 += per * n * cuda_ms(pgemm.gemm_stats, x, w)
                out["digests"][f"k2_{k}_{nn}_{v}_{dtype}"] = _digest(
                    *pgemm.gemm_stats(x, w))
            out[str(dtype).split(".")[1]] = {"k1_ms": t1, "k1dx_ms": t1dx,
                                             "k2_ms": t2}
    with strict_fp32():
        predictor = cs.flagship_predictor(dev, 0)
        recs = cs.synthetic_records(dev, 0, 4)
        predict_records(predictor, [(recs[0]["patient"], recs[0])],
                        verbose=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_records(predictor, [(r["patient"], r) for r in recs[1:]],
                        verbose=False)
        torch.cuda.synchronize()
        out["s_per_patient"] = (time.perf_counter() - t0) / 3
        del predictor, recs
        net = cs.flagship_net(0, "bfloat16").to(dev)
        x, y = cs.synthetic_batch(dev, 0)
        step = make_train_step(net, make_optimizer(net.parameters(), 3e-4,
                                                   1e-4),
                               augment=cs.AUGMENT, microbatch=cs.MICRO,
                               seed=0)
        for _ in range(cs.WARMUP_STEPS):
            step(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.TIMED_STEPS):
            step(x, y)
        torch.cuda.synchronize()
        out["patches_per_s"] = cs.TRAIN_BATCH / (
            (time.perf_counter() - t0) / cs.TIMED_STEPS)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
