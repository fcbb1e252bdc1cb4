#!/usr/bin/env python3
"""The readings that set a cell's correctness limits, each judged by the
harness's own comparison against the cell's limits.

    python3 benchmark/controls.py --workload <cell> --seeds 1 2 3
                                  [--sound] [--raw <file>]

For each seed, the cell's inputs as a run makes them, and against the
plain reference the readings of its control (the reference put in the
program's place one precision down: scaled fp8 for the bf16 training and
search, TF32 for fp32 serving) and of the planted faults the cell can
have; with `--sound` (training and search) also the program's own, its
set-up driven as a run drives it.  Each reading goes through
`compare.verdict` against `workloads/<cell>.json`: a control or a fault
has to come out not correct, the program correct.  One JSON line a seed;
`--raw` appends each side's per-step losses and per-leaf norms to a
file.  Runs on the card only.  The benchmark's runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(bench: dict, name: str, seed: int, device, files=None,
             sound: bool = False, raw: dict | None = None) -> dict:
    """{reading: {"numbers": {...}, "correct": bool}} on one seed: the
    control's, the faults' and with `sound` the program's."""
    from benchmark.harness import compare, core

    files = files or core.Files()
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    traffic = files.json("traffic", cell["traffic"])
    ctx = SimpleNamespace(seed=seed, seconds=0.0, trace=False,
                          device=torch.device(device),
                          config=files.json("configs", cell["config"]),
                          traffic=traffic, cell=name)
    driver = files.module("drivers", traffic["driver"])
    if sound:
        st = driver.setup(ctx)
        driver.release(st)
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    else:
        st = driver.inputs_of(ctx)
    limits = files.json("workloads", name)["limits"]
    out = {}
    for k, numbers in driver.controls(ctx, st, raw).items():
        ok, _ = compare.verdict(numbers, limits)
        out[k] = {"numbers": numbers, "correct": ok}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sound", action="store_true")
    ap.add_argument("--raw")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("controls.py: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for seed in args.seeds:
        t0 = time.perf_counter()
        raw = {} if args.raw else None
        out = readings(bench, args.workload, seed, "cuda:0",
                       sound=args.sound, raw=raw)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
        if raw is not None:
            with open(args.raw, "a") as f:
                f.write(json.dumps({"seed": seed, **raw}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
