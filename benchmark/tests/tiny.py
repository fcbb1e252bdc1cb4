"""Tiny cells for the CPU tests: the flagship's and the supernet's
structure at base 4, depth 2, 2 nodes, 16³ patches, and the files a cell
needs, written to a directory of their own."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.harness import core

BENCH = core.BENCH


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


TINY_MODEL = {"base_channels": 4, "depth": 2, "n_nodes": 2, "gn_groups": 4}
GENOTYPE = {"down": [[["in0", "down_conv3"], ["in1", "down_sep_conv3"]],
                     [["in1", "down_conv3"], ["n0", "conv3"]]],
            "up": [[["below", "up_transpose"], ["skip", "conv3"]],
                   [["skip", "sep_conv3"], ["n0", "conv3"]]]}
PATIENTS = {"count": 2, "shape": [24, 20, 18], "channels": 4}


def configs(dtype: str = "float32") -> dict:
    """The two configurations at the tiny size, their training and search
    body in `dtype` (fp32: the program's twins agree with the reference
    to fp32 rounding, which the tests hold them to)."""
    derived = load("configs", "flagship_derived")
    derived["model"].update(TINY_MODEL, genotype=GENOTYPE)
    derived["train"]["dtype"] = dtype
    supernet = load("configs", "darts_supernet")
    supernet["model"].update(TINY_MODEL)
    supernet["search"]["dtype"] = dtype
    return {"tiny_derived": derived, "tiny_supernet": supernet}


def traffics() -> dict:
    train = load("traffic", "train_128_b2")
    train.update(patch=16, patients=PATIENTS)
    # the graph-replay path: n steps a call, the first call followed
    graph = dict(train, steps_per_call=2, follow_calls=1, trace_calls=1)
    search = load("traffic", "search_128_b1")
    search.update(patch=16, patients=PATIENTS)
    serve = load("traffic", "serve_brats_pool16")
    serve.update(patch=16, pool={"channels": 4,
                                 "shapes": [[20, 24, 12], [16, 18, 16],
                                            [24, 40, 20]]},
                 check_share=0.5, trace_patients=2)
    return {"tiny_train": train, "tiny_graph": graph, "tiny_search": search,
            "tiny_serve": serve}


CELLS = {"tiny_train_cell": ("tiny_derived", "tiny_train"),
         "tiny_graph_cell": ("tiny_derived", "tiny_graph"),
         "tiny_search_cell": ("tiny_supernet", "tiny_search"),
         "tiny_serve_cell": ("tiny_derived", "tiny_serve")}
LIMITS = {"tiny_train_cell": "derived_train_128",
          "tiny_graph_cell": "derived_train_128",
          "tiny_search_cell": "supernet_search_128",
          "tiny_serve_cell": "derived_serve_brats"}


def write(root: Path, dtype: str = "float32") -> dict:
    """The tiny cells' files under `root`; returns a BENCHMARK.json dict
    holding the real metrics and the tiny cells, each as the real cell
    whose limits it takes."""
    for kind, items in (("configs", configs(dtype)),
                        ("traffic", traffics())):
        (root / kind).mkdir(parents=True, exist_ok=True)
        for name, obj in items.items():
            (root / kind / f"{name}.json").write_text(json.dumps(obj))
    (root / "workloads").mkdir(exist_ok=True)
    for cell, real in LIMITS.items():
        (root / "workloads" / f"{cell}.json").write_text(
            json.dumps(load("workloads", real)))
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["workloads"] = [{"name": c, "config": cfg, "traffic": t,
                           "chips": 1, "why": "tiny"}
                          for c, (cfg, t) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c, real in LIMITS.items()
                              if real in m["workloads"]]
    return bench


def run(bench: dict, files, cell: str, trace: bool = False,
        seed: int = 2 ** 31 + 11, seconds: float = 0.6) -> dict:
    """One run of a tiny cell on the CPU, as run.py makes it on the card."""
    return core.run_cell(bench, cell, seed, seconds, trace, "cpu",
                         core.program.now(), files)
