"""Driver `search`: the program's first-order DARTS bilevel step.

Set-up builds the supernet holding the benchmark's weights, α, AdamW for
the weights and for α, the augmentation generator, the step
(`make_search_step`: an α-step on a validation batch, then a w-step on an
augmented train batch) and two of the program's `PatchGenerator` →
`Prefetcher` feeds (train and validation streams) over the traffic's
patients in host memory; then it drives the step through its first
`follow_calls` steps, which the reference follows.  The window repeats
fetch → step until `--seconds` have passed, then drains the device.

End to end: `search_s_per_step`, the window's seconds over its steps.
Spans: `data_wait` (both fetches) and `step_call` (the step, to its
return), per step outside the traced part; `untraced_s` and
`untraced_units` are the window's seconds and steps without it.
"""

from __future__ import annotations

import torch

from benchmark.harness import compare, inputs, program
from benchmark.reference import train as rt
from benchmark.reference.net import Net, arch_shapes, param_spec
from benchmark.reference.ops import FP8, FP32, Precision, tf32

SECTION = "search"   # the configuration's section this driver runs


def inputs_of(ctx) -> dict:
    """What the run feeds both sides, from the seed: the weights, α, the
    patients, the train and validation streams' seeds; `names` the leaves
    in a fixed order."""
    model, tf, dev = ctx.config["model"], ctx.traffic, ctx.device
    spec = param_spec(model)
    pts = tf["patients"]
    return dict(w0=inputs.make_weights(spec, ctx.seed, dev),
                a0=inputs.make_alphas(arch_shapes(model["n_nodes"]),
                                      ctx.seed, dev),
                names=sorted(spec),
                patients=inputs.make_patients(
                    ctx.seed, "patients", [pts["shape"]] * pts["count"],
                    pts["channels"], dev),
                streams=[inputs.derive(ctx.seed, t)
                         for t in ("patches", "val")])


def setup(ctx) -> dict:
    from nas_3d_unet_tpu_torch.data.pipeline import PatchGenerator, Prefetcher
    from nas_3d_unet_tpu_torch.search.bilevel import make_search_step
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer

    sc, tf, dev = ctx.config["search"], ctx.traffic, ctx.device
    st = inputs_of(ctx)
    w0, a0 = st["w0"], st["a0"]
    net = program.supernet(ctx.config["model"], sc["dtype"],
                           sc["partial_channels"], w0, dev)
    st["names"] = [k for k, _ in net.named_parameters()]
    alphas = {k: v.clone().requires_grad_(True) for k, v in a0.items()}
    pool = inputs.PatientPool(st["patients"])
    feeds = [Prefetcher(PatchGenerator(pool, (tf["patch"],) * 3,
                                       tf["batch"], seed=s, augment=False),
                        dev, depth=tf["prefetch_depth"])
             for s in st["streams"]]
    w_opt = make_optimizer(net.parameters(), sc["w_lr"],
                           sc["w_weight_decay"])
    a_opt = make_optimizer(alphas.values(), sc["alpha_lr"],
                           sc["alpha_weight_decay"])
    gen = inputs.generator(ctx.seed, "augment", dev)
    step = make_search_step(net, w_opt, a_opt, alphas, sc["augment"],
                            gen=gen)
    st.update(net=net, w_opt=w_opt, a_opt=a_opt, feeds=feeds, step=step,
              alphas=alphas)
    for c in range(tf["follow_calls"]):
        step(*feeds[0].next(), *feeds[1].next())
        if c == 0:
            st["prog_moments"] = (rt.norms(w_opt.mu), rt.norms(a_opt.mu))
    st["prog_change"] = (
        rt.norms([p - w0[k] for k, p in net.named_parameters()]),
        rt.norms([alphas[k] - a0[k] for k in alphas]))
    return st


def window(ctx, st) -> dict:
    tf, dev, step, feeds = ctx.traffic, ctx.device, st["step"], st["feeds"]
    waits, calls, losses = [], [], []
    traced, traced_s = None, 0.0
    t_start = program.now()
    trace_at = t_start + tf["trace_after"] * ctx.seconds

    def one(spans=True):
        t0 = program.now()
        batches = (*feeds[0].next(), *feeds[1].next())
        t1 = program.now()
        out = step(*batches)
        if spans:
            calls.append(program.now() - t1)
            waits.append(t1 - t0)
        losses.append(torch.stack([out["train_loss"], out["val_loss"]]))

    while program.now() - t_start < ctx.seconds:
        if ctx.trace and traced is None and program.now() >= trace_at:
            program.sync(dev)
            t0 = program.now()
            with program.Traced(dev) as traced:
                for _ in range(tf["trace_calls"]):
                    one(spans=False)
            traced_s = program.now() - t0
            continue
        one()
    program.sync(dev)
    window_s = program.now() - t_start
    events = traced.events() if traced is not None else None
    steps = len(losses)
    traced_steps = tf["trace_calls"] if traced is not None else 0
    failed = int((~torch.isfinite(torch.stack(losses))).any(1).sum())
    return {"metrics": {"search_s_per_step": window_s / steps},
            "attempted": steps, "failed": failed,
            "run": {"kind": "search", "window_s": window_s,
                    "untraced_s": window_s - traced_s,
                    "untraced_units": steps - traced_steps,
                    "spans": {"data_wait": waits, "step_call": calls},
                    "steps_per_span": 1, "events": events,
                    "traced_units": traced_steps, "launches": None}}


def release(st) -> None:
    for f in st["feeds"]:
        f.close()
    for key in ("net", "w_opt", "a_opt", "feeds", "step"):
        st.pop(key, None)


def follow(ctx, st, prec: Precision = FP32):
    """The reference through the followed steps: ((w, α) moment norms
    after the first step, (w, α) change norms)."""
    model, sc, tf = ctx.config["model"], ctx.config["search"], ctx.traffic
    dev, names, w0, a0 = ctx.device, st["names"], st["w0"], st["a0"]
    weights = rt.leaves(names, w0, dev)
    alphas = rt.leaves(list(a0), a0, dev)
    net = Net(model, prec)
    w_opt = rt.AdamW([weights[k] for k in names], sc["w_lr"],
                     sc["w_weight_decay"])
    a_opt = rt.AdamW(list(alphas.values()), sc["alpha_lr"],
                     sc["alpha_weight_decay"])
    gen = inputs.generator(ctx.seed, "augment", dev)
    patch = (tf["patch"],) * 3
    moments = None
    with tf32(False):
        for t in range(tf["follow_calls"]):
            tr, va = (rt.crop_batch(st["patients"], s, t, patch, tf["batch"])
                      for s in st["streams"])
            tr = rt.augment(gen, *(torch.from_numpy(a).to(dev) for a in tr),
                            **sc["augment"])
            va = tuple(torch.from_numpy(a).to(dev) for a in va)
            rt.search_step(net, weights, alphas, w_opt, a_opt, tr, va)
            if t == 0:
                moments = (rt.norms(w_opt.mu), rt.norms(a_opt.mu))
    change = (rt.norms([weights[k] - w0[k] for k in names]),
              rt.norms([alphas[k] - a0[k] for k in alphas]))
    return moments, change


def numbers(prog, ref) -> dict:
    """The compared numbers: the moment and change gaps of the weights and
    of α.  The losses are not compared (PERF.md §2: no control or fault
    reads three times their sound gaps)."""
    out = {}
    for i, part in enumerate(("w", "alpha")):
        keep = compare.nonzero(ref[0][i])
        out[f"moment_gap.{part}"] = max(compare.leaf_gaps(prog[0][i],
                                                          ref[0][i]))
        out[f"change_gap.{part}"] = max(compare.leaf_gaps(prog[1][i],
                                                          ref[1][i], keep))
    return out


def _prog(st):
    return st["prog_moments"], st["prog_change"]


def check(ctx, st) -> dict:
    return numbers(_prog(st), follow(ctx, st))


def controls(ctx, st, raw: dict | None = None) -> dict:
    """The reading of the control (the reference in scaled fp8) against
    the reference; with the program's set-up run, its own reading
    (`sound`) too.  A search batch holds one sample: no half-batch fault.
    `raw` takes each side's (moment norms, change norms) of (w, α)."""
    sides = {"reference": follow(ctx, st),
             "control_fp8": follow(ctx, st, FP8)}
    if "prog_moments" in st:
        sides["sound"] = _prog(st)
    if raw is not None:
        raw.update(sides)
    return {k: numbers(v, sides["reference"]) for k, v in sides.items()
            if k != "reference"}
