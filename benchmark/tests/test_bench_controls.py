"""The controls and the planted faults at the tiny size on the CPU, read
as `controls.py` reads them on the card at the cells' sizes: each reads
at least one of its cell's numbers three times higher than a sound run of
the program in the cell's own precision does, the separation the limits
are set in (PERF.md §2), and each reading comes with the harness's own
verdict on it."""

import pytest

from benchmark import controls
from benchmark.harness import core
from benchmark.tests import tiny

CELLS = ["tiny_train_cell", "tiny_graph_cell", "tiny_search_cell",
         "tiny_serve_cell"]


@pytest.fixture(scope="module")
def bf16_bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16")
    return tiny.write(root, dtype="bfloat16"), core.Files([root, core.BENCH])


@pytest.mark.parametrize("cell", CELLS)
def test_controls_and_faults_stand_apart_from_sound_runs(bf16_bench, cell):
    bench, files = bf16_bench
    seed = 2 ** 31 + 99
    run = tiny.run(bench, files, cell, seed=seed)
    sound = {k: v for k, (v, _) in run["checks"].items()}
    out = controls.readings(bench, cell, seed, "cpu", files)
    assert out and all(k.startswith(("control_", "fault_")) for k in out)
    for name, r in out.items():
        numbers = r["numbers"]
        assert set(numbers) == set(sound)
        assert r["correct"] is all(numbers[k] <= lim
                                   for k, (_, lim) in run["checks"].items())
        assert any(numbers[k] > 3 * sound[k] for k in numbers), \
            (name, numbers, sound)


@pytest.mark.parametrize("cell", ["tiny_train_cell", "tiny_search_cell"])
def test_the_sound_reading_is_the_runs_own(bf16_bench, cell):
    """`--sound` drives the program's set-up as a run does: its numbers
    are the run's checks, and the raw sides hold every leaf."""
    bench, files = bf16_bench
    seed = 2 ** 31 + 7
    checks = tiny.run(bench, files, cell, seed=seed)["checks"]
    raw = {}
    out = controls.readings(bench, cell, seed, "cpu", files, sound=True,
                            raw=raw)
    assert out["sound"]["numbers"] == {k: v for k, (v, _) in checks.items()}
    assert out["sound"]["correct"] is all(v <= lim
                                          for v, lim in checks.values())
    assert {"reference", "sound", "control_fp8"} <= set(raw)
    assert len(raw["sound"]) == len(raw["reference"])
