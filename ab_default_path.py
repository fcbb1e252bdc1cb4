#!/usr/bin/env python3
"""Time the default path of the port in one checkout, to compare two
checkouts on one NVIDIA GPU.

    python3 ab_default_path.py ROOT

ROOT is the root of a checkout (it holds `chip_smoke.py` and
`nas_3d_unet_tpu_torch/`); its kernels are built from its own sources and
its own `chip_smoke.py` helpers make the net and the data.  Prints one
JSON line:
  k1_ms, k1dx_ms, k2_ms, k7_ms, k4_ms
                         K1, K1-dx, K2, K7 (the use_pallas 1³ conv) and
                         K4 (its k2s2 transpose conv) summed over
                         chip_smoke.py's geometries: fp32 per flagship
                         forward (batch 2), bf16 per train step (two
                         microbatches of 1);
  k4_device_ms, k4_host_ms
                         K4's device ms and host ms a unit, the same sum
                         (chip_smoke.py's `device_ms`);
  digests                SHA-256 of K1's (y, Σy, Σy²), K1-dx's y, K2's (y,
                         Σy, Σy²) and K2's y alone, K7's y (at P_K7's
                         geometries, and P_K7_EXTRA's with their bias and
                         ReLU) and K4's y (at P_K4's, and P_K4_EXTRA's
                         with their ReLU), at fixed seeds;
  k5                     K5a (moments), K5b (weighted_sums) and masked K5b
                         at every geometry of chip_smoke.py's default and
                         use_pallas paths (inputs from a generator of
                         their own): per kernel the call's ms, its device
                         ms and host ms (chip_smoke.py's `device_ms`) and
                         its bound, summed per unit (fp32 per flagship
                         forward, bf16 per train step; "pallas_moments_*"
                         are the use_pallas configuration's K5a calls),
                         the same per geometry, and a digest of each
                         geometry's sums;
  host_us                host µs a call of the launch path (wrapper,
                         checks, allocation, ctypes launch) of K2, K7, K4,
                         K5a and K5b in both dtypes, at a shape whose
                         device time is a few µs (8³ rows of 16 channels),
                         so the device keeps up and the host's clock times
                         the host alone: the least of 5 loops of 2000
                         calls;
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


def _k5(cs, dev):
    """K5's calls at every geometry of both paths, timed three ways."""
    from nas_3d_unet_tpu_torch.ops import stats
    from nas_3d_unet_tpu_torch.utils.bounds import bound_ms
    from nas_3d_unet_tpu_torch.utils.timing import cuda_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = ([("moments_f32", c, v, cs.BATCH, f32, n)
             for c, v, n in cs.K5A_GEOMS]
            + [("moments_bf16", c, v, cs.MICRO, bf16, n)
               for c, v, n in cs.K5A_TRAIN]
            + [("weighted_sums_bf16", c, v, cs.MICRO, bf16, n)
               for c, v, n in cs.K5B_TRAIN]
            + [("weighted_sums_masked_bf16", c, v, cs.MICRO, bf16, 2 * n)
               for c, v, n in cs.P_K3]
            + [("pallas_moments_f32", c, v, cs.BATCH, f32, n)
               for c, v, n in cs.P_K5A]
            + [("pallas_moments_bf16", c, v, cs.MICRO, bf16, 2 * n)
               for c, v, n in cs.P_K5A])
    keys = ("ms", "device_ms", "host_ms", "bound_ms")
    sums, geoms, digests = {}, [], {}
    for name, c, v, batch, dtype, n in rows:
        nin = 1 if "moments" in name else 3 if "masked" in name else 2
        ts = [torch.randn((batch, v, v, v, c), generator=gen, device=dev)
              .to(dtype) for _ in range(nin)]
        if nin == 3:
            ts[2] = ts[2].relu()
        fn = stats.moments if nin == 1 else stats.weighted_sums
        rec = dict(zip(keys, (
            cuda_ms(fn, *ts, iters=20, warmup=3), *cs.device_ms(fn, ts),
            bound_ms(nin * ts[0].numel() * ts[0].element_size()
                     + 8 * batch * c)[0])))
        geoms.append([name, c, v, n, *rec.values()])
        digests[f"{name}_{c}_{v}"] = _digest(*fn(*ts))
        row = sums.setdefault(name, dict.fromkeys(keys, 0.0))
        for k in keys:
            row[k] += n * rec[k]
        del ts
    return {"per_unit": sums, "geometries": geoms, "digests": digests}


def _k4(cs, dev, out):
    """K4 (`conv_transpose2x`) at P_K4 (timed three ways, summed a unit)
    and P_K4_EXTRA, with inputs from a generator of its own: the sums
    into out[dtype], the y digests into out["digests"]."""
    from nas_3d_unet_tpu_torch.ops import conv3d
    from nas_3d_unet_tpu_torch.utils.timing import cuda_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    for dtype, batch, per in ((torch.float32, cs.BATCH, 1),
                              (torch.bfloat16, cs.MICRO, 2)):
        sums = dict.fromkeys(("k4_ms", "k4_device_ms", "k4_host_ms"), 0.0)
        for cin, cout, v, relu, n in (
                [(c, c, v, False, n) for c, v, n in cs.P_K4]
                + [(*g, 0) for g in cs.P_K4_EXTRA]):
            x = rand(batch, *cs._volume(v), cin).to(dtype)
            w = (rand(2, 2, 2, cin, cout) * cin ** -0.5).to(dtype)
            args = (x, w, relu)
            out["digests"][f"k4_{cin}_{cout}_{v}_{relu}_{dtype}"] = \
                _digest(conv3d.conv_transpose2x(*args))
            if n:
                dev_ms, host_ms = cs.device_ms(conv3d.conv_transpose2x,
                                               args)
                for key, ms in (("k4_ms", cuda_ms(conv3d.conv_transpose2x,
                                                  *args)),
                                ("k4_device_ms", dev_ms),
                                ("k4_host_ms", host_ms)):
                    sums[key] += per * n * ms
        out[str(dtype).split(".")[1]].update(sums)


def _host_us(dev, calls=2000, repeats=5):
    """Host µs a call of K2's, K7's, K4's, K5a's and K5b's launch path,
    each dtype: the least of `repeats` loops of `calls` calls."""
    from nas_3d_unet_tpu_torch.ops import conv3d, pgemm, stats

    out = {}
    for dtype, t in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x5 = torch.randn((1, 8, 8, 8, 16), device=dev).to(dtype)
        x3 = x5.view(1, 512, 16)
        w = torch.randn((16, 16), device=dev).to(dtype)
        w4 = torch.randn((2, 2, 2, 16, 16), device=dev).to(dtype)
        for name, fn, args in (
                ("gemm_stats", pgemm.gemm_stats, (x3, w)),
                ("pointwise_conv", conv3d.pointwise_conv,
                 (x5, w, None, False)),
                ("conv_transpose2x", conv3d.conv_transpose2x,
                 (x5, w4, False)),
                ("moments", stats.moments, (x5,)),
                ("weighted_sums", stats.weighted_sums, (x5, x5))):
            fn(*args)
            best = float("inf")
            for _ in range(repeats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*args)
                best = min(best, (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
            out[f"{name}_{t}"] = best * 1e6
    return out


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
    from nas_3d_unet_tpu_torch.ops import conv3d, pgemm
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
    gen7 = torch.Generator(device=dev)       # K7's own: the other digests'
    gen7.manual_seed(1)                      # inputs stay as before
    rand7 = lambda *s: torch.randn(s, generator=gen7, device=dev)
    with strict_fp32(), torch.no_grad():
        for dtype, batch, per in ((torch.float32, cs.BATCH, 1),
                                  (torch.bfloat16, cs.MICRO, 2)):
            t1 = t1dx = t2 = t7 = 0.0
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
                key = f"{k}_{nn}_{v}_{dtype}"
                y, s1, s2 = pgemm.gemm_stats(x, w)
                out["digests"]["k2_" + key] = _digest(y, s1, s2)
                out["digests"]["k2y_" + key] = _digest(y)
            for cin, cout, v, scale in (
                    [(c, c, v, None) for c, v, _ in cs.P_K7]
                    + cs.P_K7_EXTRA):
                x = rand7(batch, *cs._volume(v), cin).to(dtype)
                w = (rand7(cin, cout) * cin ** -0.5).to(dtype)
                b = None if scale is None else rand7(cout) * scale
                args = (x, w, b, b is not None)
                n = next((n for c, vv, n in cs.P_K7
                          if scale is None and (c, c, vv) == (cin, cout, v)),
                         0)
                t7 += per * n * cuda_ms(conv3d.pointwise_conv, *args)
                out["digests"][f"k7_{cin}_{cout}_{v}_{scale}_{dtype}"] = \
                    _digest(conv3d.pointwise_conv(*args))
            out[str(dtype).split(".")[1]] = {"k1_ms": t1, "k1dx_ms": t1dx,
                                             "k2_ms": t2, "k7_ms": t7}
        _k4(cs, dev, out)
        out["k5"] = _k5(cs, dev)
        out["host_us"] = _host_us(dev)
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
