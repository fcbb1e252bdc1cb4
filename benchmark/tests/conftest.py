"""CPU tests of the benchmark: tiny cells through the program's plain
twins, one torch thread."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import core  # noqa: E402
from benchmark.tests import tiny  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    """(BENCHMARK.json dict, Files) of the tiny cells."""
    root = tmp_path_factory.mktemp("tiny")
    bench = tiny.write(root)
    return bench, core.Files([root, core.BENCH])

