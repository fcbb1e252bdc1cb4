#!/usr/bin/env python3
"""Where a cell's device idles, cut by the program's spans.

    python3 benchmark/phases.py --workload derived_train_128 --seed 5 --seconds 14

from the root of a checkout, on a CUDA device.  One traced window of the
cell (its driver's, as `run.py --trace 1` makes it, with no reference
check), then one JSON line: the device-idle ms a step (a patient in
serving) under each phase span, inside the step's ranges and outside
them, against the traced part's whole idle (`identity_gap_pct`: the two
cuts add up to it); the host ms a step in CUDA calls that wait for the
device, by thread; and each step's host ms with the phase ranges inside
it.  Nothing here is compared: it says which phase the device idles
under, for a reader of `PERF.md` §5.
"""

import argparse
import json
import os
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each driver's step range and the phase spans inside it (or, for
# `data.fetch`, between steps)
PHASES = {"train": ("train.step", ["train.augment", "step.forward",
                                   "step.backward", "train.optim",
                                   "data.fetch"]),
          "search": ("search.step", ["search.augment", "search.alpha",
                                     "search.weights", "step.forward",
                                     "step.backward", "data.fetch"]),
          "serve": ("serve.dispatch", ["serve.upload", "serve.forward",
                                       "serve.stitch", "serve.decode"])}


def traced_run(bench: dict, name: str, seed: int, seconds: float, device,
               files=None) -> dict:
    """The run dict of one traced window of cell `name`."""
    import torch

    from benchmark.harness import core, program

    files = files or core.Files()
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    config = files.json("configs", cell["config"])
    traffic = files.json("traffic", cell["traffic"])
    driver = files.module("drivers", traffic["driver"])
    ctx = SimpleNamespace(seed=seed, seconds=seconds, trace=True,
                          device=torch.device(device), config=config,
                          traffic=traffic, cell=name)
    st = driver.setup(ctx)
    program.sync(ctx.device)
    win = driver.window(ctx, st)
    driver.release(st)
    return win["run"]


def waits_by_thread(run: dict, top: str) -> dict:
    """Host ms a `top` range in CUDA calls that wait for the device, by
    the thread that made them: the range's own, the autograd engine's,
    or another (a feed worker's)."""
    from benchmark.harness import core, spans
    from benchmark.harness import trace as tr

    red = core.reduced(run)
    ev = run["events"]
    tops = [e for e in ev if e.get("cat") == "user_annotation"
            and e["name"] == top and red.lo <= e["ts"]
            and e["ts"] + e["dur"] <= red.hi]
    engine = {e.get("tid") for e in ev if e.get("cat") == "cpu_op"
              and e["name"].startswith(spans.ENGINE_PREFIX)}
    calls: dict = {}
    for e in ev:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and (
                e["name"] in spans.BLOCKING
                or e["name"].startswith(spans.BLOCKING_PREFIX)):
            calls.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    out: dict = {}
    for r in tops:
        s, t = r["ts"], r["ts"] + r["dur"]
        for tid, iv in calls.items():
            role = ("own" if tid == r.get("tid") else
                    "engine" if tid in engine else "other")
            key = f"{role}:{tid}"
            out[key] = out.get(key, 0.0) + tr.union_ms(iv, s, t) / len(tops)
    return out


def cut(run: dict):
    """The JSON-able cut of a traced run; None where it traced no device
    activity or holds no step range."""
    from benchmark.harness import spans

    kind = run["kind"]
    top, phases = PHASES[kind]
    got = spans.idle_by_phase(run, kind, top, phases)
    if got is None:
        return None
    red, found = spans.traced_ranges(run, kind, top)
    got["identity_gap_pct"] = 100 * abs(
        got["inside_ms"] * got["ranges"] + got["outside_ms"]
        - got["idle_ms"]) / got["idle_ms"]
    got["window_ms"] = red.window_ms
    got["waits_ms"] = waits_by_thread(run, top)
    got["blocked_ms"] = spans.blocked_ms(run, kind, top)
    got["steps"] = [{"host_ms": (t - s) / 1e3,
                     "inside": {p: len(spans.ranges(run["events"], p, s, t))
                                for p in phases}}
                    for s, t in found]
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=14)
    args = ap.parse_args(argv)
    # the builds and kernel caches of `run.py`, inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("phases.py: needs a CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    run = traced_run(bench, args.workload, args.seed, args.seconds, "cuda:0")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(0),
                      "cut": cut(run)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
