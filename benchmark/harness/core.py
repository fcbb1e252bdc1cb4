"""One run of one cell: the files found by name, set-up, the window, the
memory peak, the program freed, the reference's verdict, the metrics and
the result line.

A cell (an entry of `BENCHMARK.json`'s `workloads`) joins a
configuration, `configs/<config>.json`, and a traffic mix,
`traffic/<traffic>.json`, whose `driver` names `drivers/<driver>.py`; its
correctness limits are `workloads/<cell>.json`.  A per-layer metric is
read by `metrics/<metric>.py`.  Each is looked up in the given directories
in order, so a new cell, mix, configuration or metric is a new file.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Iterable, List

import torch

from . import compare, program, trace

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nas_3d_unet_tpu")


class Files:
    """The benchmark's files by kind and name, looked up in `dirs`."""

    def __init__(self, dirs: Iterable = (BENCH,)):
        self.dirs: List[Path] = [Path(d) for d in dirs]

    def path(self, kind: str, name: str, ext: str) -> Path:
        for d in self.dirs:
            p = d / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} in "
                                f"{[str(d) for d in self.dirs]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        path = self.path(kind, name, ".py")
        mod_name = f"benchmark_{kind}_{name.replace('.', '_')}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries of `cell`: an end-to-end
    metric without `workloads` (`setup_s`) is every cell's; a per-layer
    metric names its cells."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    return e2e, [m for m in bench["per_layer"] if cell in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float,
             files: Files | None = None) -> dict:
    """The result of one run (the result line's keys, `checks` last)."""
    files = files or Files()
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    config = files.json("configs", cell["config"])
    traffic = files.json("traffic", cell["traffic"])
    limits = files.json("workloads", name)["limits"]
    driver = files.module("drivers", traffic["driver"])
    ctx = SimpleNamespace(seed=seed, seconds=seconds, trace=traced,
                          device=torch.device(device), config=config,
                          traffic=traffic, cell=name)
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.zeros((), device=ctx.device)       # the context, then its
        torch.cuda.reset_peak_memory_stats(ctx.device)   # peak from here
    st = driver.setup(ctx)
    program.sync(ctx.device)
    setup_s = program.now() - t_start
    win = driver.window(ctx, st)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    driver.release(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = program.now()
    ok, checks = compare.verdict(driver.check(ctx, st), limits)
    print(json.dumps({"setup_s": setup_s, "window_s": win["run"]["window_s"],
                      "check_s": program.now() - t_check}), file=sys.stderr)
    e2e, per_layer = cell_metrics(bench, name)
    values = {"setup_s": setup_s, **win["metrics"]}
    dev = {"platform": "gpu" if cuda else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if cuda
           else "cpu", "count": 1, "memory_peak_bytes": peak}
    out = {"correct": ok and win["failed"] == 0,
           "attempted": win["attempted"], "failed": win["failed"]}
    run = dict(win["run"], model=config["model"], patch=traffic["patch"],
               dtype=config[driver.SECTION]["dtype"])
    if not traced:
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]} for m in e2e}
        out["device"] = dev
    else:
        metrics = {}
        for m in per_layer:
            v = files.module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        red = reduced(run)
        if red is not None:
            dev.update(busy_s=red.busy_ms() / 1e3,
                       window_s=red.window_ms / 1e3)
            out["breakdown"] = red.breakdown()
        out["device"] = dev
    out["checks"] = checks
    return out


def reduced(run: dict):
    """The traced part of a run, reduced once (None: no device activity
    was traced)."""
    if "_reduced" not in run:
        events = run.get("events")
        red = trace.Reduced(events) if events else None
        run["_reduced"] = red if red is not None and red.has_kernels() \
            else None
    return run["_reduced"]
