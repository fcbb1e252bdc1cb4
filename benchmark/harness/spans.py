"""The program's spans in a traced part: its ranges in the trace, and its
in-memory ring placed on the trace's timeline.

The program's span (`nas_3d_unet_tpu_torch/utils/profiling.py`
`annotate`) is kept in a ring, (name, thread id, start ns, end ns) on
`time.perf_counter_ns`, and while a profiler runs it is also a range in
the trace (`user_annotation`).  A range opened on a thread that started
before the profiler does not show in the trace, so the spans of the
Prefetcher's workers and of the patient writer (`WORKER`) are read from
the ring and placed on the trace's clock: the offset is the median
difference of starts over the consumer thread's spans that both hold.
Those are found as the run of ring spans whose names are the trace's, in
order, and whose lengths agree best with the trace's (the least mean
difference).

A device activity belongs to a span when its launch was issued inside it
(the launch's time by correlation, on any thread: the autograd engine
issues the backward's launches from a thread of its own).  A CUDA call
that waits belongs to a span only when it was made on the span's own
thread or on a thread that ran the span's backward: the feed's workers
wait for their own copies while the step runs.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Callable, List, Optional, Sequence, Tuple

from . import trace as tr
from .core import reduced

# spans made on the Prefetcher's workers and the patient writer
WORKER = frozenset({"data.assemble", "data.stage", "serve.finalize",
                    "serve.readback"})
# CUDA runtime and driver calls that wait for the device (frozen)
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMalloc", "cudaFree"})
BLOCKING_PREFIX = "cudaMemcpy"
# the host ops the autograd engine runs a backward's nodes under
ENGINE_PREFIX = "autograd::engine::evaluate_function"

Span = Tuple[str, int, float, float]        # name, thread, start, end (µs)


def program_ring() -> list:
    """The program's ring, oldest first; [] where the program keeps
    none."""
    from nas_3d_unet_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def ranges(events: Sequence[dict], name: str, lo: float = float("-inf"),
           hi: float = float("inf")) -> List[Tuple[float, float]]:
    """(start, end) µs of the trace's `name` ranges that lie in [lo, hi]."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == name
                  and e["ts"] >= lo and e["ts"] + e["dur"] <= hi)


def offset_us(events: Sequence[dict], ring: Sequence) -> Optional[float]:
    """Trace µs − ring µs, from the consumer thread's spans that both the
    trace and the ring hold; None where none match."""
    names = {s[0] for s in ring} - WORKER
    held = sorted(((e["ts"], -e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] in names))
    if not held:
        return None
    mine = sorted((s[2] / 1e3, -(s[3] - s[2]) / 1e3, s[0]) for s in ring
                  if s[0] in names)
    want = [h[2] for h in held]
    best = None
    for j in range(len(mine) - len(held) + 1):
        if mine[j][2] != want[0] or \
                [m[2] for m in mine[j:j + len(held)]] != want:
            continue
        pairs = list(zip(held, mine[j:j + len(held)]))
        score = statistics.fmean(abs(h[1] - m[1]) for h, m in pairs)
        if best is None or score < best[0]:
            best = (score, statistics.median(h[0] - m[0] for h, m in pairs))
    return None if best is None else best[1]


def placed(events: Sequence[dict], ring: Sequence,
           names) -> Optional[List[Span]]:
    """The ring's spans named in `names` on the trace's clock (µs); None
    where the ring cannot be aligned with the trace."""
    off = offset_us(events, ring)
    if off is None:
        return None
    return [(s[0], s[1], s[2] / 1e3 + off, s[3] / 1e3 + off) for s in ring
            if s[0] in names]


def traced_ranges(run: dict, kind: str, name: str):
    """(the reduced traced part, its `name` ranges) of a `kind` run; None
    where the run is another driver's, traced no device activity or holds
    no such range."""
    red = reduced(run) if run["kind"] == kind else None
    if red is None:
        return None
    found = ranges(run["events"], name, red.lo, red.hi)
    return (red, found) if found else None


def launched_in(red, found: Sequence[Tuple[float, float]]) -> Callable:
    """pred(e): the device activity e was launched inside one of `found`
    (sorted, not overlapping)."""
    starts = [s for s, _ in found]

    def pred(e) -> bool:
        ts = red.launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            return False
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= found[i][1]

    return pred


def blocked_ms(run: dict, kind: str, name: str):
    """Host ms a `name` range spends in CUDA calls that wait for the
    device (`BLOCKING`, the union of their intervals), made on the
    range's own thread or on a thread that ran autograd's nodes inside
    it."""
    got = traced_ranges(run, kind, name)
    if got is None:
        return None
    _, found = got
    events = run["events"]
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and (e["name"] in BLOCKING
                  or e["name"].startswith(BLOCKING_PREFIX))]
    total = 0.0
    for s, t in found:
        tids = {e.get("tid") for e in events
                if s <= e["ts"] <= t and (
                    e.get("cat") == "user_annotation" and e["name"] == name
                    or e.get("cat") == "cpu_op"
                    and e["name"].startswith(ENGINE_PREFIX))}
        total += tr.union_ms([(e["ts"], e["ts"] + e["dur"]) for e in calls
                              if e.get("tid") in tids], s, t)
    return total / len(found)


def _idle_in(red, found) -> float:
    """Device-idle ms within the ranges `found` (not overlapping), clipped
    to the traced part."""
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in red.device]
    out = 0.0
    for s, t in found:
        s, t = max(s, red.lo), min(t, red.hi)
        if t > s:
            out += (t - s) / 1e3 - tr.union_ms(busy, s, t)
    return out


def _merged(found) -> list:
    """The union of ranges, as sorted ranges that do not overlap."""
    out: list = []
    for s, t in sorted(found):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def idle_ms(run: dict, kind: str, name: str):
    """Device-idle ms inside a `name` range: its length less the union of
    the device activities within it."""
    got = traced_ranges(run, kind, name)
    if got is None:
        return None
    red, found = got
    return _idle_in(red, found) / len(found)


def idle_by_phase(run: dict, kind: str, top: str, phases: Sequence[str]):
    """The traced part's device idle cut by the program's ranges: ms a
    `top` range inside each of `phases` (the union of its ranges) and
    inside `top` ranges; ms of the whole part outside `top` ranges, and
    its whole idle ms; None where the run holds no `top` range."""
    got = traced_ranges(run, kind, top)
    if got is None:
        return None
    red, found = got
    n = len(found)
    inside = _idle_in(red, found)
    gaps = list(zip([red.lo] + [t for _, t in found],
                    [s for s, _ in found] + [red.hi]))
    return {"ranges": n,
            "phase_ms": {p: _idle_in(red, _merged(
                ranges(run["events"], p, red.lo, red.hi))) / n
                for p in phases},
            "inside_ms": inside / n,
            "outside_ms": _idle_in(red, gaps),
            "idle_ms": red.window_ms - red.busy_ms()}


def launched_share(run: dict, kind: str, part: str, whole: str):
    """The share (%) of the device-busy ms launched inside `whole` ranges
    that was launched inside `part` ranges."""
    got = traced_ranges(run, kind, whole)
    if got is None:
        return None
    red, found = got
    total = red.busy_ms(launched_in(red, found))
    if total <= 0:
        return None
    inner = ranges(run["events"], part, red.lo, red.hi)
    return 100 * red.busy_ms(launched_in(red, inner)) / total


def ms_per_inner(run: dict, kind: str, name: str, inner: str):
    """Host ms in `name` ranges over the number of `inner` ranges inside
    them: the cost of a range per unit of the work it issues."""
    got = traced_ranges(run, kind, name)
    if got is None:
        return None
    red, found = got
    n = sum(1 for s, t in ranges(run["events"], inner, red.lo, red.hi)
            if any(a <= s and t <= b for a, b in found))
    return sum(t - s for s, t in found) / n / 1e3 if n else None


def _ring_in_window(run: dict, kind: str, names):
    """The ring's `names` spans on the trace's clock, and the window."""
    red = reduced(run) if run["kind"] == kind else None
    if red is None:
        return None
    got = placed(run["events"], program_ring(), names)
    return None if got is None else (got, red.lo, red.hi)


def stage_ms(run: dict):
    """Host ms a batch in `data.assemble` + `data.stage` on the workers,
    over the batches whose staging ended inside the traced part."""
    got = _ring_in_window(run, "train", {"data.assemble", "data.stage"})
    if got is None:
        return None
    spans, lo, hi = got
    last, per = {}, []
    for name, tid, s, t in sorted(spans, key=lambda x: x[2]):
        if name == "data.assemble":
            last[tid] = t - s
        elif tid in last:
            if lo <= t <= hi:
                per.append(last[tid] + t - s)
            del last[tid]
    return sum(per) / len(per) / 1e3 if per else None


def finalize_ms(run: dict):
    """Host ms a patient in `serve.finalize` less its `serve.readback`,
    over the patients finalized inside the traced part."""
    got = _ring_in_window(run, "serve", {"serve.finalize", "serve.readback"})
    if got is None:
        return None
    spans, lo, hi = got
    reads = [x for x in spans if x[0] == "serve.readback"]
    per = []
    for name, tid, s, t in spans:
        if name == "serve.finalize" and lo <= t <= hi:
            inner = sum(rt - rs for _, rtid, rs, rt in reads
                        if rtid == tid and rs >= s and rt <= t)
            per.append(t - s - inner)
    return sum(per) / len(per) / 1e3 if per else None
