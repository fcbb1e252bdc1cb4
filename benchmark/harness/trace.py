"""Reduction of a `torch.profiler` trace (Chrome trace events) of the
traced part of a window to device busy time, shares and attributions.

`CLASSES`, `kernel_class` and `union_ms` are frozen copies of
profile_slice.py's: the kernel-name classifier and the union of
device intervals.  A traced part is the user range `WINDOW`; the serve
driver marks the net's forwards with `FORWARD` ranges.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

WINDOW = "bench_window"
FORWARD = "bench_net_forward"

CLASSES = [   # (class, kernel-name pattern), first match wins
    ("K1 bf16 conv3x3x3_stats (tensor cores)",
     r"conv_mma_kernel<\d+, true"),
    ("K1-dx / K6 bf16 conv (tensor cores)", r"conv_mma_kernel<"),
    ("K2 bf16 gemm_stats (tensor cores)", r"gemm_mma_kernel<\d+, true"),
    ("K4 bf16 conv_transpose2x (tensor cores)",
     r"gemm_mma_kernel<\d+, false, true, true"),
    ("K7 bf16 pointwise_conv (tensor cores)", r"gemm_mma_kernel<"),
    ("K1 fp32 conv3x3x3_stats (FMA conv tile)",
     r"conv_fma_kernel<\d+, 1, \d, true"),
    ("K1-dx / K6 stride-1 fp32 conv (FMA conv tile)",
     r"conv_fma_kernel<\d+, 1,"),
    ("K6 stride-2 fp32 conv3d (FMA conv tile)", r"conv_fma_kernel<\d+, 2,"),
    ("K2 fp32 gemm_stats (FMA GEMM tile)", r"gemm_fma_kernel<\d+, true"),
    ("K4 fp32 conv_transpose2x (FMA GEMM tile)",
     r"gemm_fma_kernel<\d+, false, \w+, true>"),
    ("K7 fp32 pointwise_conv (FMA GEMM tile)", r"gemm_fma_kernel<"),
    ("K1/K2 moments reduce", r"moments_reduce_kernel"),
    ("K3 apply", r"apply_kernel<"),
    ("K3 dx", r"dx_kernel<"),
    ("K5b masked (K3 backward sums)",
     r"stats_sums_kernel<[\w:]+, true, true"),
    ("K5b weighted_sums", r"stats_sums_kernel<[\w:]+, true"),
    ("K5a moments", r"stats_sums_kernel<[\w:]+, false"),
    ("AdamW (foreach)", r"multi_tensor_apply"),
    ("cuDNN layout transform", r"nhwcToNchw|nchwToNhwc"),
    ("cuDNN conv", r"conv|xmma_fprop|cudnn"),
    ("cuBLAS gemm", r"gemm"),
    ("reduction", r"reduce_kernel"),
    ("elementwise", r"elementwise|Fill|copy|cat|index"),
]
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
CUDNN = ("cuDNN conv", "cuDNN layout transform")


def kernel_class(name: str, cat: str) -> str:
    if cat != "kernel":
        return cat
    for cls, pat in CLASSES:
        if re.search(pat, name):
            return cls
    return "other"


def is_hand_kernel(name: str, cat: str) -> bool:
    """A kernel of the program's own CUDA library (a class K1..K7)."""
    return kernel_class(name, cat).startswith("K")


def union_ms(intervals, lo, hi) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy / 1e3


def export(prof) -> list:
    """The profiler's complete events ("ph" X), through a Chrome trace
    file under TMPDIR that is deleted again."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


class Reduced:
    """A traced part: its window [lo, hi] (µs), the device activities
    that overlap it, and the host ranges and launches needed to attribute
    them."""

    def __init__(self, events: list):
        windows = [e for e in events if e.get("cat") == "user_annotation"
                   and e["name"] == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"{len(windows)} {WINDOW!r} ranges in the trace")
        w = windows[0]
        self.lo, self.hi = w["ts"], w["ts"] + w["dur"]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and e["ts"] < self.hi
                       and e["ts"] + e["dur"] > self.lo]
        self.forwards = sorted(
            (e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"] == FORWARD)
        self.launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                          if e.get("cat") in ("cuda_runtime", "cuda_driver")
                          and "correlation" in e.get("args", {})}
        self.host = [e for e in events
                     if e.get("cat") in ("cpu_op", "user_annotation")
                     and e["name"] != WINDOW]

    @property
    def window_ms(self) -> float:
        return (self.hi - self.lo) / 1e3

    def clipped_ms(self, e) -> float:
        return (min(e["ts"] + e["dur"], self.hi) - max(e["ts"], self.lo)) / 1e3

    def busy_ms(self, pred=None) -> float:
        """The union of the device activities (those for which pred(e))
        within the window, ms."""
        return union_ms([(e["ts"], e["ts"] + e["dur"]) for e in self.device
                         if pred is None or pred(e)], self.lo, self.hi)

    def has_kernels(self) -> bool:
        return any(e["cat"] == "kernel" for e in self.device)

    def ms_where(self, pred) -> float:
        """Σ clipped ms of the device activities for which pred(e)."""
        return sum(self.clipped_ms(e) for e in self.device if pred(e))

    def in_forward(self, e) -> bool:
        """Whether the activity was launched inside a `FORWARD` range."""
        ts = self.launch_ts.get(e.get("args", {}).get("correlation"))
        return ts is not None and any(s <= ts <= t for s, t in self.forwards)

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle stretches summed by the host operation in progress at
        their start (the innermost one)."""
        ops = collections.Counter()
        for e in self.device:
            ops[e["name"][:120]] += self.clipped_ms(e) / 1e3
        gaps = collections.Counter()
        end = self.lo
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        for s, t in spans:
            if s > end:
                gaps[_doing(host, starts, end)] += (min(s, self.hi) - end) / 1e6
            end = max(end, t)
        if end < self.hi:
            gaps[_doing(host, starts, end)] += (self.hi - end) / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(10)]}


def _doing(host: list, starts: list, ts: float) -> str:
    """The innermost host range that holds `ts` (the latest to start)."""
    for i in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
        e = host[i]
        if e["ts"] + e["dur"] >= ts:
            return e["name"][:120]
    return "host idle"
