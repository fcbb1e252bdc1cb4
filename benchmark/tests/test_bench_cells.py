"""Every driver and per-layer reader runs a tiny cell on the CPU through
the program's plain twins, the reference agrees with the program there,
and a run whose timed path is broken underneath comes out not correct."""

import contextlib

import pytest
import torch

from benchmark.harness import core
from benchmark.tests import tiny

CELLS = sorted(tiny.CELLS)
HOST_METRICS = {"tiny_train_cell": {"data_wait_ms.train",
                                    "step_host_ms.train", "mfu.train"},
                "tiny_graph_cell": {"data_wait_ms.train",
                                    "step_host_ms.train", "mfu.train"},
                "tiny_search_cell": {"search_host_ms.search", "mfu.search"},
                "tiny_serve_cell": {"mfu.serve"}}


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees_with_the_reference(tiny_bench, cell, trace):
    bench, files = tiny_bench
    out = tiny.run(bench, files, cell, trace)
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"], out["checks"]
    # fp32 twins against the fp32 reference: rounding apart
    assert all(v < 1e-3 for v, _ in out["checks"].values()), out["checks"]
    e2e, per_layer = core.cell_metrics(bench, cell)
    if trace:
        # the CPU trace holds no device activity: the device readers
        # return nothing, the host ones read their spans and counts
        assert set(out["metrics"]) == HOST_METRICS[cell]
    else:
        assert set(out["metrics"]) == {m["name"] for m in e2e}
        assert "setup_s" in out["metrics"]
    for m in out["metrics"].values():
        assert m["unit"] and m["value"] > 0


@pytest.mark.parametrize("cell", ["tiny_train_cell", "tiny_graph_cell",
                                  "tiny_search_cell", "tiny_serve_cell"])
def test_the_traced_part_stays_out_of_the_host_clock_numbers(tiny_bench,
                                                             cell):
    """Spans, seconds and units of the host-clock metrics leave out the
    traced calls (the profiler slows them)."""
    from types import SimpleNamespace

    bench, files = tiny_bench
    w = next(c for c in bench["workloads"] if c["name"] == cell)
    traffic = files.json("traffic", w["traffic"])
    ctx = SimpleNamespace(seed=2 ** 31 + 5, seconds=0.6, trace=True,
                          device=torch.device("cpu"),
                          config=files.json("configs", w["config"]),
                          traffic=traffic, cell=cell)
    driver = files.module("drivers", traffic["driver"])
    st = driver.setup(ctx)
    try:
        run = driver.window(ctx, st)["run"]
    finally:
        driver.release(st)
    assert run["events"] is not None and run["traced_units"]
    assert 0 < run["untraced_s"] < run["window_s"]
    assert run["untraced_units"] > 0
    calls = run["untraced_units"] // (traffic.get("batch", 1)
                                      * traffic.get("steps_per_call", 1))
    for spans in run["spans"].values():
        assert len(spans) == calls


def _state_unchanged(mp):
    from nas_3d_unet_tpu_torch.train import optim
    mp.setattr(optim.AdamW, "update", lambda self, *a, **k: None)


def _half_batch_train(mp):
    from nas_3d_unet_tpu_torch.train import loop
    orig = loop.loss_and_grads

    def half(model, x, y, loss_fn, microbatch=0):
        b = x.shape[0] // 2
        return orig(model, x[:b], y[:b], loss_fn, 0)
    mp.setattr(loop, "loss_and_grads", half)


def _half_batch_serve(mp):
    from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor
    orig = SlidingWindowPredictor.forward_probs

    def half(self, patches):
        probs = orig(self, patches[::2])
        return probs.repeat_interleave(2, 0)[:patches.shape[0]]
    mp.setattr(SlidingWindowPredictor, "forward_probs", half)


def _labels_altered(mp):
    from nas_3d_unet_tpu_torch.infer import sliding
    orig = sliding.decode_labels

    def swapped(*a, **k):
        lab = orig(*a, **k)
        return torch.where(lab == 1, 2, torch.where(lab == 2, 1, lab)).to(
            lab.dtype)
    mp.setattr(sliding, "decode_labels", swapped)


FAULTS = [("tiny_train_cell", _state_unchanged),
          ("tiny_train_cell", _half_batch_train),
          ("tiny_graph_cell", _state_unchanged),
          ("tiny_graph_cell", _half_batch_train),
          ("tiny_search_cell", _state_unchanged),
          ("tiny_serve_cell", _half_batch_serve),
          ("tiny_serve_cell", _labels_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_bench, cell, fault,
                                            monkeypatch):
    bench, files = tiny_bench
    with contextlib.ExitStack():
        fault(monkeypatch)
        out = tiny.run(bench, files, cell)
    assert out["correct"] is False, out["checks"]


def test_the_bf16_body_runs_to_its_verdict(tmp_path):
    """The cells' own precision: training in bf16 through the twins."""
    bench = tiny.write(tmp_path, dtype="bfloat16")
    files = core.Files([tmp_path, core.BENCH])
    out = tiny.run(bench, files, "tiny_train_cell")
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(0 <= v < 1 for v, _ in out["checks"].values()), out["checks"]
