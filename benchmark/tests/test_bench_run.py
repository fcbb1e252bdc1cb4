"""run.py on a machine without a card: it fails and prints no result,
also in a checkout that holds only BENCHMARK.json and the benchmark."""

import os
import shutil
import subprocess
import sys

from benchmark.harness import core

ARGS = ["--workload", "derived_train_128", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


def test_without_a_card_no_result():
    proc = _run(core.ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
