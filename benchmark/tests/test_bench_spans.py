"""The readers of the program's spans (`harness/spans.py` and its seven
metrics) on made-up traces and rings with known answers: a blocked
`cudaStreamSynchronize` inside `train.step`, a feed worker's wait beside
it that is not the step's, an idle gap outside the step, an α launch that
runs under the w-step, worker and writer spans placed on the trace's
clock; and None on another driver's run."""

import pytest

from benchmark.harness import core, spans
from benchmark.harness import trace as tr

D = 123_456.0          # ring µs − trace µs
MAIN, WORKER, ENGINE = 1, 2, 3
KERNEL = "void at::native::elementwise_kernel<128, 4>()"


def _range(name, s, t, cat="user_annotation", tid=MAIN):
    return {"ph": "X", "cat": cat, "name": name, "ts": s, "dur": t - s,
            "tid": tid}


def _kernels(*ks):
    """(start, end, launch) → a kernel and its launch, by correlation."""
    ev = []
    for i, (s, t, launch) in enumerate(ks):
        ev.append({"ph": "X", "cat": "kernel", "name": KERNEL, "ts": s,
                   "dur": t - s, "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "args": {"correlation": i}})
    return ev


def _ring(*sp):
    """(name, thread, start µs, end µs) on the trace's clock → the ring's
    (name, thread, start ns, end ns)."""
    return [(n, tid, int((s + D) * 1e3), int((t + D) * 1e3))
            for n, tid, s, t in sp]


def _train():
    events = [_range(tr.WINDOW, 0, 1000),
              _range("train.step", 100, 400), _range("train.step", 500, 800),
              _range("data.fetch", 90, 95), _range("data.fetch", 490, 495),
              # inside step 1: a sync and a copy overlapping, 70 µs in all
              _range("cudaStreamSynchronize", 150, 200, "cuda_runtime"),
              _range("cudaMemcpyAsync", 180, 220, "cuda_runtime"),
              _range("cudaLaunchKernel", 300, 301, "cuda_runtime"),
              _range("cudaFree", 600, 610, "cuda_driver"),        # step 2
              _range("cudaDeviceSynchronize", 850, 900, "cuda_runtime"),
              # the feed's worker waits for its own copies during both
              # steps: not the step's
              _range("cudaMemcpyAsync", 200, 240, "cuda_runtime", WORKER),
              _range("cudaEventSynchronize", 240, 290, "cuda_runtime",
                     WORKER),
              _range("cudaEventSynchronize", 620, 680, "cuda_runtime",
                     WORKER),
              # step 2's backward on the autograd engine's thread, which
              # waits 20 µs: the step's
              _range("autograd::engine::evaluate_function: "
                     "ConvolutionBackward0", 690, 760, "cpu_op", ENGINE),
              _range("cudaStreamSynchronize", 700, 720, "cuda_runtime",
                     ENGINE),
              # the forward phase of each step: 20 µs idle in each
              _range("step.forward", 100, 250),
              _range("step.forward", 500, 600)]
    events += _kernels((120, 350, 110), (520, 700, 510), (820, 900, 805))
    ring = _ring(("train.step", MAIN, -3000, -2500),
                 ("data.fetch", MAIN, -3010, -3005),
                 ("data.fetch", MAIN, 90, 95), ("train.step", MAIN, 100, 400),
                 ("data.fetch", MAIN, 490, 495),
                 ("train.step", MAIN, 500, 800),
                 ("data.assemble", WORKER, -400, -100),     # before: out
                 ("data.stage", WORKER, -100, -20),
                 ("data.assemble", WORKER, 150, 250),       # 150 µs, in
                 ("data.stage", WORKER, 250, 300),
                 ("data.assemble", WORKER, 700, 900),       # ends after: out
                 ("data.stage", WORKER, 900, 1100))
    return {"kind": "train", "events": events}, ring


def _search():
    events = [_range(tr.WINDOW, 0, 1000), _range("search.step", 100, 900),
              _range("search.augment", 100, 110),
              _range("search.alpha", 110, 400),
              _range("search.weights", 400, 900),
              _range("cudaStreamSynchronize", 380, 420, "cuda_runtime")]
    # the second kernel is launched in the α-step and runs under the
    # w-step's host range; the last is launched after the step
    events += _kernels((150, 350, 120), (300, 600, 390), (650, 850, 450),
                       (920, 990, 910))
    return {"kind": "search", "events": events}, []


def _serve():
    events = [_range(tr.WINDOW, 0, 1000),
              _range("serve.dispatch", 100, 300),
              _range("serve.forward", 150, 250),
              _range("serve.forward", 260, 290),
              _range("serve.dispatch", 500, 650),
              _range("serve.forward", 520, 600),
              _range("serve.dispatch", 950, 1100)]          # past the end
    events += _kernels((160, 400, 155), (530, 700, 525))
    ring = _ring(("serve.dispatch", MAIN, 100, 300),
                 ("serve.forward", MAIN, 150, 250),
                 ("serve.forward", MAIN, 260, 290),
                 ("serve.dispatch", MAIN, 500, 650),
                 ("serve.forward", MAIN, 520, 600),
                 ("serve.dispatch", MAIN, 950, 1100),
                 ("serve.finalize", WORKER, 320, 480),      # 160 − 70
                 ("serve.readback", WORKER, 330, 400),
                 ("serve.finalize", WORKER, 700, 800),      # 100 − 80
                 ("serve.readback", WORKER, 700, 780),
                 ("serve.finalize", WORKER, 980, 1050),     # ends after
                 ("serve.readback", WORKER, 990, 1040))
    return {"kind": "serve", "events": events}, ring


RUNS = {"train": _train, "search": _search, "serve": _serve}
KNOWN = [
    # (0.070 + 0.010 + 0.020 on the engine's thread) / 2 steps
    ("host_blocked_ms.train", "train", 0.050),
    # step 1: 300 − 230 µs; step 2: 300 − 180
    ("step_idle_ms.train", "train", (0.070 + 0.120) / 2),
    # one batch staged inside the window
    ("data_stage_ms.train", "train", 0.150),
    ("host_blocked_ms.search", "search", 0.040),
    # busy launched in the step [150, 600] + [650, 850]; in α [150, 600]
    ("alpha_share.search", "search", 100 * 450 / 650),
    # two patients, three forwards
    ("dispatch_host_ms.serve", "serve", (0.200 + 0.150) / 3),
    ("finalize_host_ms.serve", "serve", (0.090 + 0.020) / 2),
]


def _read(name, run, ring, monkeypatch):
    monkeypatch.setattr(spans, "program_ring", lambda: ring)
    return core.Files().module("metrics", name).read(run)


@pytest.mark.parametrize("name,kind,want", KNOWN, ids=[k[0] for k in KNOWN])
def test_each_reader_reads_its_known_answer(name, kind, want, monkeypatch):
    run, ring = RUNS[kind]()
    assert _read(name, run, ring, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("name,kind,want", KNOWN, ids=[k[0] for k in KNOWN])
def test_each_reader_reads_nothing_in_another_drivers_run(name, kind, want,
                                                          monkeypatch):
    for other, make in RUNS.items():
        run, ring = make()
        if other != kind:
            assert _read(name, run, ring, monkeypatch) is None
    run, ring = RUNS[kind]()
    assert _read(name, dict(run, events=None), ring, monkeypatch) is None
    # a trace with no device activity (the CPU's)
    host = [e for e in run["events"] if e["cat"] != "kernel"]
    assert _read(name, dict(run, events=host), ring, monkeypatch) is None


def test_step_idle_and_the_idle_outside_the_steps_add_up_to_the_window():
    run, _ = _train()
    red = core.reduced(run)
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in red.device]
    steps = spans.ranges(run["events"], "train.step")
    inside = spans.idle_ms(run, "train", "train.step") * len(steps)
    outside = sum((t - s) / 1e3 - tr.union_ms(busy, s, t)
                  for s, t in ((0, 100), (400, 500), (800, 1000)))
    assert inside + outside == pytest.approx(red.window_ms - red.busy_ms())
    cut = spans.idle_by_phase(run, "train", "train.step",
                              ["step.forward", "data.fetch"])
    assert cut["ranges"] == 2
    assert cut["inside_ms"] == pytest.approx(inside / 2)
    assert cut["outside_ms"] == pytest.approx(outside)
    assert cut["idle_ms"] == pytest.approx(inside + outside)
    # a step's share: 20 µs of forward idle a step, two 5-µs fetches
    assert cut["phase_ms"] == {"step.forward": pytest.approx(0.020),
                               "data.fetch": pytest.approx(0.005)}
    assert spans.idle_by_phase(dict(run, kind="serve"), "train",
                               "train.step", []) is None


def test_a_workers_wait_during_the_step_is_not_the_steps():
    run, _ = _train()
    mine = [e for e in run["events"] if e.get("tid") != WORKER]
    assert spans.blocked_ms(run, "train", "train.step") == pytest.approx(
        spans.blocked_ms(dict(run, events=mine), "train", "train.step"))
    # the engine's thread counts only where it ran a backward in the step
    lone = [e for e in run["events"] if e["cat"] != "cpu_op"]
    assert spans.blocked_ms(dict(run, events=lone), "train",
                            "train.step") == pytest.approx(0.040)


def test_the_ring_is_aligned_by_the_consumer_spans_both_hold():
    run, ring = _train()
    # the earlier train.step (500 µs long) is not the traced one
    assert spans.offset_us(run["events"], ring) == pytest.approx(-D)
    placed = spans.placed(run["events"], ring, {"data.stage"})
    assert [p[2:] for p in placed] == [pytest.approx((-100, -20)),
                                       pytest.approx((250, 300)),
                                       pytest.approx((900, 1100))]
    # a ring that holds none of the trace's spans cannot be aligned
    lone = [s for s in ring if s[0] in spans.WORKER]
    assert spans.offset_us(run["events"], lone) is None


def test_the_worker_readers_read_nothing_without_an_aligned_ring(
        monkeypatch):
    for name, make in (("data_stage_ms.train", _train),
                       ("finalize_host_ms.serve", _serve)):
        run, ring = make()
        lone = [s for s in ring if s[0] in spans.WORKER]
        assert _read(name, run, lone, monkeypatch) is None


def test_a_program_without_spans_gives_readers_nothing(monkeypatch):
    """A program that keeps no ring and opens no range (as before it had
    spans) makes each reader return None, and none raises."""
    from nas_3d_unet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.program_ring() == []
    for name, kind, _ in KNOWN:
        run, _ = RUNS[kind]()
        run["events"] = [e for e in run["events"]
                         if e["cat"] != "user_annotation"
                         or e["name"] == tr.WINDOW]
        assert core.Files().module("metrics", name).read(run) is None


def test_the_phase_tool_cuts_a_traced_run_by_its_spans():
    from benchmark import phases

    run, _ = _train()
    got = phases.cut(run)
    assert got["ranges"] == 2 and got["identity_gap_pct"] < 1e-9
    assert got["blocked_ms"] == pytest.approx(0.050)
    # per step: the own thread's 70 + 10 µs, the engine's 20, the
    # worker's 40 + 50 and 60 µs
    assert got["waits_ms"] == {f"own:{MAIN}": pytest.approx(0.040),
                               f"engine:{ENGINE}": pytest.approx(0.010),
                               f"other:{WORKER}": pytest.approx(0.075)}
    assert [s["inside"]["step.forward"] for s in got["steps"]] == [1, 1]
    run, _ = _train()
    assert phases.cut(dict(run, events=[
        e for e in run["events"] if e["cat"] != "kernel"])) is None


def test_the_phase_tool_runs_a_tiny_cell_on_the_cpu(tmp_path):
    """On the CPU the trace holds the step's spans but no device activity,
    so there is nothing to cut."""
    from benchmark import phases
    from benchmark.tests import tiny

    bench = tiny.write(tmp_path)
    files = core.Files([tmp_path, core.BENCH])
    run = phases.traced_run(bench, "tiny_train_cell", 2 ** 31 + 5, 0.6,
                            "cpu", files)
    assert spans.ranges(run["events"], "train.step")
    assert phases.cut(run) is None
