"""The arithmetic of the per-layer metrics, which the small readers in
`metrics/` call.  A reader returns None where its run holds nothing to
read (another driver's run, no device activity in the trace, launches that
the frozen tables do not describe)."""

from __future__ import annotations

import torch

from . import flops, geometry
from . import trace as tr
from .bounds import PEAK_FLOPS
from .core import reduced

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def host_ms(run: dict, kind: str, span: str):
    """Host ms a step in `span` (a span may cover several steps)."""
    spans = run["spans"].get(span) if run["kind"] == kind else None
    if not spans:
        return None
    return 1e3 * sum(spans) / (len(spans) * run["steps_per_span"])


def mfu(run: dict, kind: str):
    """Model FLOPs of the window's work outside its traced part over its
    seconds, as a share (%) of the peak of the configuration's
    precision."""
    if run["kind"] != kind or not run["untraced_units"]:
        return None
    per_unit = flops.per_unit(run["model"], kind, run["patch"])
    return 100 * per_unit * run["untraced_units"] / run["untraced_s"] \
        / PEAK_FLOPS[DTYPES[run["dtype"]]]


def device_idle(run: dict, kind: str):
    """1 − busy / window of the traced part, %."""
    red = reduced(run) if run["kind"] == kind else None
    return None if red is None else 100 * (1 - red.busy_ms() / red.window_ms)


def cudnn_share(run: dict, kind: str):
    """The share (%) of the traced part's device-busy time in which a
    kernel of cuDNN's ran (the union of their intervals: cuDNN runs some
    kernels side by side)."""
    red = reduced(run) if run["kind"] == kind else None
    if red is None:
        return None
    return 100 * red.busy_ms(lambda e: tr.kernel_class(
        e["name"], e["cat"]) in tr.CUDNN) / red.busy_ms()


def hand_kernel_roofline(run: dict, kind: str):
    """Σ of the hand kernels' least times (frozen tables × frozen peaks)
    over their Σ device ms in the traced part, %; None where the program's
    launch counts of the traced part are not the tables' (another net, or
    launches the trace cannot see)."""
    red = reduced(run) if run["kind"] == kind else None
    if red is None or not run.get("traced_units"):
        return None
    train = kind == "train"
    units = run["traced_units"]
    want = {k: n * units for k, n in geometry.launches_per_unit(train).items()}
    if dict(run.get("launches") or {}) != want:
        return None
    ms = red.ms_where(lambda e: tr.is_hand_kernel(e["name"], e["cat"]))
    if ms <= 0:
        return None
    return 100 * geometry.bound_ms_per_unit(train) * units / ms


def stitch_device_ms(run: dict):
    """Device ms a served patient outside the net's forwards in the traced
    part (pad, patch stacking, sigmoid, stitch sums, decode, copies)."""
    red = reduced(run) if run["kind"] == "serve" else None
    if red is None or not run.get("traced_patients"):
        return None
    return red.ms_where(lambda e: not red.in_forward(e)) \
        / run["traced_patients"]
