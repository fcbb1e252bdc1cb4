#!/usr/bin/env python3
"""Run one cell of the benchmark on one NVIDIA GPU and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  The cell is an entry of `BENCHMARK.json`'s
`workloads`; its configuration, traffic, driver, limits and per-layer
readers are found by name under `benchmark/` (see README.md).  With
`--trace 0` the last line of standard output is the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics from a traced part of the
window; each numbered comparison with the reference is printed beside its
limit on standard error, last, and under `checks` in the result line.
Without a CUDA device the run fails and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here: loading counts

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of a run lives inside the checkout, at a
# fixed path, so that only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import core

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"run.py: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}: nothing measured",
              file=sys.stderr)
        return 2
    out = core.run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda:0", T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
