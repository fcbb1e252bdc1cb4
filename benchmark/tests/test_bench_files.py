"""A configuration, a traffic mix, a cell and a per-layer metric are
files found by name: each added in a directory of its own runs with no
edit to a file of the benchmark."""

import json
import subprocess

from benchmark.harness import core
from benchmark.tests import tiny


def test_new_files_in_a_directory_of_their_own_are_found_and_run(tmp_path):
    bench = tiny.write(tmp_path)          # configs, traffic, workloads
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "calls_counted.train.py").write_text(
        "def read(run):\n"
        "    return float(len(run['spans']['step_call']))\n")
    bench["per_layer"].append(
        {"name": "calls_counted.train", "unit": "calls", "better": "higher",
         "source": "program_span", "layer": "train step",
         "moves": "train_patches_per_s", "workloads": ["tiny_train_cell"]})
    files = core.Files([tmp_path, core.BENCH])
    out = tiny.run(bench, files, "tiny_train_cell", trace=True)
    assert out["metrics"]["calls_counted.train"]["value"] >= 1
    assert out["correct"], out["checks"]
    tracked = subprocess.run(["git", "status", "--porcelain", "--",
                              str(core.BENCH)], capture_output=True,
                             text=True, cwd=core.ROOT).stdout
    assert "calls_counted" not in tracked


def test_every_cell_of_the_benchmark_has_its_files():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    files = core.Files()
    for cell in bench["workloads"]:
        traffic = files.json("traffic", cell["traffic"])
        files.path("drivers", traffic["driver"], ".py")
        files.json("configs", cell["config"])
        assert files.json("workloads", cell["name"])["limits"]
    for m in bench["per_layer"]:
        assert callable(files.module("metrics", m["name"]).read)
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"


def test_a_metric_applies_by_its_cells():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    e2e, per_layer = core.cell_metrics(bench, "derived_serve_brats")
    assert {m["name"] for m in e2e} == {"serve_s_per_patient", "serve_p90_s",
                                        "setup_s"}
    assert "stitch_device_ms.serve" in {m["name"] for m in per_layer}
    assert not any(m["name"].endswith(".train") for m in per_layer)
    assert all("workloads" in m for m in bench["per_layer"])
