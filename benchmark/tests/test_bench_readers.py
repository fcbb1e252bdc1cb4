"""The per-layer readers' arithmetic on a made-up trace: the union of
device intervals, the shares, the roofline's launch check and the
attribution to the net's forwards."""

import pytest

from benchmark.harness import core, geometry, readers
from benchmark.harness import trace as tr

K5 = "void stats_sums_kernel<float, false, false, 4>(Args)"
CUDNN = "sm90_xmma_fprop_implicit_gemm_bf16 cudnn"
ELEM = "void at::native::elementwise_kernel<128, 4>()"


def _events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": tr.WINDOW,
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": tr.FORWARD,
           "ts": 50, "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 40,
           "dur": 20}]
    for i, (name, start, dur, launch) in enumerate([
            (CUDNN, 100, 200, 55), (K5, 400, 100, 60),
            (ELEM, 450, 150, 500), (ELEM, 990, 50, 980)]):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start,
                   "dur": dur, "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": launch, "dur": 1,
                   "args": {"correlation": i}})
    return ev


def _run(kind="train", **kw):
    return dict({"kind": kind, "events": _events(), "traced_units": 1,
                 "launches": geometry.launches_per_unit(kind == "train"),
                 "traced_patients": 2}, **kw)


def test_union_idle_and_shares():
    run = _run()
    # busy: [100, 300] + [400, 600] + [990, 1000] = 410 µs of 1000
    assert readers.device_idle(run, "train") == pytest.approx(59.0)
    assert readers.cudnn_share(run, "train") == pytest.approx(
        100 * 200 / 410)
    assert readers.device_idle(run, "serve") is None
    red = core.reduced(run)
    bd = red.breakdown()
    assert bd["device_ops"][0][0].startswith("sm90_xmma")
    # idle: [0, 100], [300, 400], [600, 990], no host range open
    assert bd["idle_gaps"] == [["host idle", pytest.approx(590e-6)]]


def test_roofline_needs_the_tables_launches():
    run = _run()
    want = 100 * geometry.bound_ms_per_unit(True) / 0.1   # K5: 100 µs
    assert readers.hand_kernel_roofline(run, "train") == pytest.approx(want)
    off = _run(launches={"conv3x3x3_stats": 1})
    assert readers.hand_kernel_roofline(off, "train") is None


def test_stitch_time_is_what_the_forwards_did_not_launch():
    run = _run("serve")
    # launched inside the forward range: the cuDNN and K5 kernels
    assert readers.stitch_device_ms(run) == pytest.approx(
        (0.150 + 0.010) / 2)


def test_readers_without_a_trace_read_nothing():
    run = _run(events=None)
    for fn in (readers.device_idle, readers.cudnn_share,
               readers.hand_kernel_roofline):
        assert fn(run, "train") is None
    assert readers.stitch_device_ms(_run("serve", events=None)) is None


def test_host_spans_per_step():
    run = {"kind": "train", "spans": {"data_wait": [0.002, 0.004]},
           "steps_per_span": 2}
    assert readers.host_ms(run, "train", "data_wait") == pytest.approx(1.5)
    assert readers.host_ms(run, "search", "data_wait") is None


def test_mfu_reads_the_window_without_its_traced_part():
    """The profiler's cost stays out: the untraced work over the untraced
    seconds, not the whole window's."""
    run = {"kind": "search", "model": {"name": "x"}, "patch": 128,
           "dtype": "bfloat16", "window_s": 60.0, "units": 20,
           "untraced_s": 51.0, "untraced_units": 18}
    per = 6.8e12
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(readers.flops, "per_unit", lambda *a: per)
        want = 100 * per * 18 / 51.0 / readers.PEAK_FLOPS[
            readers.DTYPES["bfloat16"]]
        assert readers.mfu(run, "search") == pytest.approx(want)
        assert readers.mfu(dict(run, untraced_units=0), "search") is None
