"""Driver `serve`: whole-volume inference with the program's
`predict_records` and `SlidingWindowPredictor`.

The traffic's pool of patients (fixed extents, voxels from the seed) is
held in host memory and served round-robin in an order drawn from the
seed, closed loop: the loop hands `predict_records` the next patient
whenever it asks for one, until `--seconds` have passed, as the `predict`
command's loader does over a dataset; then the patients in flight are
waited for.  A patient's latency runs from its hand-over until its
result line is written, after its labels have reached the host.  Set-up
serves one patient of each window count in the pool (the shapes the
window uses).

End to end: `serve_s_per_patient`, from the first hand-over to the last
result over the patients served, and `serve_p90_s`, the 90th percentile
of the latencies.  The labels of a sample of the window's patients,
drawn from the seed before the window, are kept for the reference.
`untraced_s` and `untraced_units` are the window's seconds and served
windows without its traced part (the device drained before it starts).
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import threading

import numpy as np
import torch

from benchmark.harness import inputs, program
from benchmark.harness import trace as tr
from benchmark.reference import serve as rs
from benchmark.reference.net import Net, Params, param_spec
from benchmark.reference.ops import FP32, TF32, Precision, tf32

SECTION = "infer"    # the configuration's section this driver runs


class _Stamps(io.TextIOBase):
    """A stdout that notes when each result line of `predict_records` is
    written, by patient name; other output goes to stderr."""

    def __init__(self):
        self.done, self._buf, self._lock = {}, "", threading.Lock()

    def write(self, s: str) -> int:
        t = program.now()
        with self._lock:
            self._buf += s
            while "\n" in self._buf:
                line, self._buf = self._buf.split("\n", 1)
                try:
                    self.done[json.loads(line)["patient"]] = t
                except (ValueError, KeyError, TypeError):
                    sys.stderr.write(line + "\n")
        return len(s)


def _predictor(ctx, net):
    from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor

    class Keeping(SlidingWindowPredictor):
        """Keeps the labels of the patients marked for the reference."""

        keep, current, kept = set(), None, {}

        def predict_labels(self, volume, threshold=0.5, mesh=None):
            out = super().predict_labels(volume, threshold, mesh)
            if self.current in self.keep:
                self.kept[self.current] = out
            return out

    inf = ctx.config["infer"]
    return Keeping(net, (ctx.traffic["patch"],) * 3, overlap=inf["overlap"],
                   batch_size=inf["batch_size"],
                   num_classes=ctx.config["model"]["num_classes"])


def _windows(ctx, shape) -> int:
    return len(rs.windows(shape, ctx.traffic["patch"],
                          ctx.config["infer"]["overlap"]))


def inputs_of(ctx) -> dict:
    """What the run feeds both sides, from the seed: the weights, the
    pool's volumes, the order they are served in."""
    tf, dev = ctx.traffic, ctx.device
    shapes = [tuple(s) for s in tf["pool"]["shapes"]]
    rng = np.random.default_rng(inputs.derive(ctx.seed, "order"))
    order = rng.permutation(len(shapes)).tolist()
    return dict(w0=inputs.make_weights(param_spec(ctx.config["model"]),
                                       ctx.seed, dev),
                pool=inputs.make_patients(ctx.seed, "pool", shapes,
                                          tf["pool"]["channels"], dev,
                                          labels=False),
                shapes=shapes, order=list(order), rng=rng)


def setup(ctx) -> dict:
    st = inputs_of(ctx)
    shapes = st["shapes"]
    net = program.derived_net(ctx.config["model"],
                              ctx.config["infer"]["dtype"], st["w0"],
                              ctx.device)
    st.update(net=net, predictor=_predictor(ctx, net))
    first = {}
    for i, s in enumerate(shapes):
        first.setdefault(_windows(ctx, s), i)
    warm = [first[k] for k in sorted(first)]
    _serve(ctx, st, warm, lambda p: p < len(warm))
    return st


def _record(st, i: int, name: str) -> dict:
    shape = st["shapes"][i]
    return {"patient": name, "image": st["pool"][i]["image"],
            "crop_start": inputs.crop_start(shape),
            "orig_shape": np.asarray(inputs.RAW_SHAPE, np.int64)}


def _serve(ctx, st, indices, more, on_handover=None):
    """Serve pool patients `indices[p % len]` for p = 0, 1, … while
    `more(p)`; returns ({p: hand-over time}, {p: done time}, results)."""
    from nas_3d_unet_tpu_torch.infer.predict import predict_records

    pred, handed = st["predictor"], {}

    def records():
        p = 0
        while more(p):
            i = indices[p % len(indices)]
            if on_handover is not None:
                on_handover(p)
            pred.current = p
            handed[p] = program.now()
            yield None, _record(st, i, f"p{p:06d}")
            p += 1

    stamps = _Stamps()
    with contextlib.redirect_stdout(stamps):
        results = predict_records(pred, records(), threshold=ctx.config[
            "infer"]["threshold"], verbose=True)
    done = {int(k[1:]): t for k, t in stamps.done.items()}
    return handed, done, results


def window(ctx, st) -> dict:
    tf, dev, pred = ctx.traffic, ctx.device, st["predictor"]
    order, shapes = st["order"], st["shapes"]
    # the sample the reference checks, drawn before the window: about
    # `check_share` of the positions, and the first one of the pool's
    # most windows
    most = max(range(len(shapes)), key=lambda i: _windows(ctx, shapes[i]))
    first_most = next(p for p in range(len(order)) if order[p] == most)
    pred.keep = {first_most} | {
        p for p in range(tf["max_patients"])
        if st["rng"].random() < tf["check_share"]}
    pred.kept = {}
    prof = {"traced": None, "events": None, "hooks": [], "s": 0.0}
    t0 = program.now()

    def more(p):
        return program.now() < t0 + ctx.seconds

    trace_at = t0 + tf["trace_after"] * ctx.seconds
    trace_span = []

    def on_handover(p):
        if not ctx.trace:
            return
        if prof["traced"] is None and program.now() >= trace_at:
            _mark_forwards(pred.model, prof["hooks"])
            program.sync(dev)
            prof["t0"], prof["before"] = program.now(), program.launches()
            prof["traced"] = program.Traced(dev).__enter__()
            trace_span.append(p)
        elif prof["traced"] is not None and len(trace_span) == 1 \
                and p >= trace_span[0] + tf["trace_patients"]:
            _close(prof)
            trace_span.append(p)

    handed, done, results = _serve(ctx, st, order, more, on_handover)
    if len(trace_span) == 1:
        _close(prof)
        trace_span.append(len(handed))
    if prof["traced"] is not None:
        prof["events"] = prof["traced"].events()
    n = len(handed)
    lat = [done[p] - handed[p] for p in handed if p in done]
    window_s = max(done.values()) - min(handed.values())
    wins = [_windows(ctx, shapes[order[p % len(order)]]) for p in handed]
    st["served"] = {p: order[p % len(order)] for p in handed}
    traced_fwd, traced_wins = None, 0
    if len(trace_span) == 2:
        bsz = ctx.config["infer"]["batch_size"]
        span = range(trace_span[0], trace_span[1])
        traced_fwd = sum(-(-wins[p] // bsz) for p in span)
        traced_wins = sum(wins[p] for p in span)
    p90 = float(np.percentile(lat, 90))
    sys.stderr.write(json.dumps({
        "patients": n, "latency_p90_s": p90,
        "program_seconds_p90": float(np.percentile(
            [r["seconds"] for r in results], 90))}) + "\n")
    return {"metrics": {"serve_s_per_patient": window_s / n,
                        "serve_p90_s": p90},
            "attempted": n, "failed": n - len(lat),
            "run": {"kind": "serve", "window_s": window_s,
                    "untraced_s": window_s - prof["s"],
                    "untraced_units": sum(wins) - traced_wins,
                    "patients": n, "spans": {}, "events": prof["events"],
                    "traced_units": traced_fwd,
                    "traced_patients": (trace_span[1] - trace_span[0]
                                        if len(trace_span) == 2 else None),
                    "launches": prof.get("launches")}}


def _mark_forwards(model, hooks):
    """`trace.FORWARD` ranges around the net's forwards, by hooks from
    outside."""
    from torch.profiler import record_function

    live = []

    def enter(mod, args):
        rf = record_function(tr.FORWARD)
        rf.__enter__()
        live.append(rf)

    def leave(mod, args, out):
        live.pop().__exit__(None, None, None)

    hooks.append(model.register_forward_pre_hook(enter))
    hooks.append(model.register_forward_hook(leave))


def _close(prof):
    prof["traced"].__exit__(None, None, None)
    prof["s"] = program.now() - prof["t0"]
    prof["launches"] = program.launches() - prof["before"]
    for h in prof["hooks"]:
        h.remove()


def release(st) -> None:
    pred = st["predictor"]
    st["kept"] = {p: t.cpu().numpy() for p, t in pred.kept.items()}
    for key in ("net", "predictor"):
        st.pop(key, None)


def reference_labels(ctx, st, prec: Precision = FP32, skip=None):
    """{position: labels} of the kept patients by the reference
    (`rs.labels`' `skip`: a planted fault)."""
    model, inf, tf = ctx.config["model"], ctx.config["infer"], ctx.traffic
    dev = ctx.device
    net, params = Net(model, prec), Params(st["w0"])
    out = {}
    with tf32(False):
        for p in sorted(st["kept"]):
            vol = torch.from_numpy(st["pool"][st["served"][p]]["image"])
            out[p] = rs.labels(net, params, vol.to(dev), tf["patch"],
                               inf["overlap"], inf["threshold"],
                               inf["batch_size"], skip)
    return out


def numbers(prog: dict, ref: dict) -> dict:
    """The share of the sampled patients' voxels whose label differs."""
    diff = sum(int((prog[p] != ref[p]).sum()) for p in ref)
    total = sum(ref[p].size for p in ref)
    missing = set(ref) - set(prog)
    return {"label_mismatch": float("inf") if missing or not total
            else diff / total}


def check(ctx, st) -> dict:
    return numbers(st["kept"], reference_labels(ctx, st))


def controls(ctx, st, raw: dict | None = None) -> dict:
    """On a sample of the pool as large as a run's (the patient of most
    windows among it), the readings of the control (the reference in
    TF32) and of two planted faults (the second window of each batch left
    out of the stitch; labels 1 and 2 swapped where they are decoded),
    against the reference.  Labels are compared whole: `raw` stays
    empty."""
    tf = ctx.traffic
    shapes = st["shapes"]
    most = max(range(len(shapes)), key=lambda i: _windows(ctx, shapes[i]))
    size = max(1, round(tf["check_share"] * tf["sample_patients"]))
    others = [i for i in st["rng"].permutation(len(shapes)).tolist()
              if i != most][:size]
    st["served"] = {i: i for i in [most] + others}
    st["kept"] = dict.fromkeys(st["served"])
    ref = reference_labels(ctx, st)
    swapped = {p: np.where(v == 1, 2, np.where(v == 2, 1, v))
               for p, v in ref.items()}
    return {"control_tf32": numbers(reference_labels(ctx, st, TF32), ref),
            "fault_half_batch": numbers(
                reference_labels(ctx, st, skip=lambda j: j % 2 == 1), ref),
            "fault_labels_altered": numbers(swapped, ref)}
