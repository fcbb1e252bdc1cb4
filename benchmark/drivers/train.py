"""Driver `train`: the program's training loop on its own data pipeline.

Set-up builds one training step (`make_train_step`, or with
`steps_per_call` n > 1 `make_train_step_n`, one CUDA graph replay per n
steps), its net holding the benchmark's weights, AdamW, the augmentation
generator, and the program's `PatchGenerator` → `Prefetcher` over the
traffic's patients in host memory.  It then drives that same step through
its first `follow_calls` calls, the batches coming from the same feed:
those calls warm every shape up (and capture the graph), and they are
what the reference follows.  The window repeats fetch → call until
`--seconds` have passed, then drains the device.

End to end: the traffic's `metric` (`train_patches_per_s`): the
patches of every call issued in the window over the window's seconds,
the device drained at its end.
Spans: `data_wait` (the fetch of a call's batches) and `step_call` (the
call, to its return), per call outside the traced part; `untraced_s` and
`untraced_units` are the window's seconds and patches without it (the
device drained before it starts), so that the host-clock metrics do not
read the profiler's cost.
"""

from __future__ import annotations

import statistics

import torch

from benchmark.harness import compare, inputs, program
from benchmark.reference import train as rt
from benchmark.reference.net import Net, param_spec
from benchmark.reference.ops import FP8, FP32, Precision, tf32

SECTION = "train"    # the configuration's section this driver runs


def inputs_of(ctx) -> dict:
    """What the run feeds both sides, from the seed: the weights, the
    patients, the patch stream's seed; `names` the leaves in a fixed
    order."""
    model, tf, dev = ctx.config["model"], ctx.traffic, ctx.device
    spec = param_spec(model)
    pts = tf["patients"]
    return dict(w0=inputs.make_weights(spec, ctx.seed, dev),
                names=sorted(spec), n=tf["steps_per_call"],
                patients=inputs.make_patients(
                    ctx.seed, "patients", [pts["shape"]] * pts["count"],
                    pts["channels"], dev),
                stream=inputs.derive(ctx.seed, "patches"))


def setup(ctx) -> dict:
    from nas_3d_unet_tpu_torch.data.pipeline import PatchGenerator, Prefetcher
    from nas_3d_unet_tpu_torch.train.loop import (make_train_step,
                                                  make_train_step_n)
    from nas_3d_unet_tpu_torch.train.optim import make_optimizer

    tc, tf, dev = ctx.config["train"], ctx.traffic, ctx.device
    st = inputs_of(ctx)
    w0, n = st["w0"], st["n"]
    net = program.derived_net(ctx.config["model"], tc["dtype"], w0, dev)
    st["names"] = [k for k, _ in net.named_parameters()]
    feed = Prefetcher(PatchGenerator(inputs.PatientPool(st["patients"]),
                                     (tf["patch"],) * 3, tf["batch"],
                                     seed=st["stream"], augment=False),
                      dev, depth=tf["prefetch_depth"])
    opt = make_optimizer(net.parameters(), tc["lr"], tc["weight_decay"])
    gen = inputs.generator(ctx.seed, "augment", dev)
    kw = dict(augment=tc["augment"], microbatch=tc["microbatch"], gen=gen)
    if n == 1:
        one = make_train_step(net, opt, **kw)

        def call(batches):
            return one(*batches[0]).reshape(1)
    else:
        many = make_train_step_n(net, opt, n=n, **kw)

        def call(batches):
            xs, ys = zip(*batches)
            return many(xs, ys)

    st.update(net=net, opt=opt, feed=feed, call=call,
              many=None if n == 1 else many)
    losses = []
    for c in range(tf["follow_calls"]):
        losses.append(call([feed.next() for _ in range(n)]))
        if c == 0:
            st["prog_moments"] = rt.norms(opt.mu)
    st["prog_losses"] = torch.cat(losses).tolist()
    st["prog_change"] = rt.norms([p - w0[k] for k, p in
                                  net.named_parameters()])
    return st


def window(ctx, st) -> dict:
    tf, dev, n, call, feed = (ctx.traffic, ctx.device, st["n"], st["call"],
                              st["feed"])
    waits, calls, losses = [], [], []
    traced, launched, traced_s = None, None, 0.0
    t_start = program.now()
    trace_at = t_start + tf["trace_after"] * ctx.seconds

    def one(spans=True):
        t0 = program.now()
        batches = [feed.next() for _ in range(n)]
        t1 = program.now()
        losses.append(call(batches))
        if spans:
            waits.append(t1 - t0)
            calls.append(program.now() - t1)

    while program.now() - t_start < ctx.seconds:
        if ctx.trace and traced is None and program.now() >= trace_at:
            program.sync(dev)
            t0, before = program.now(), program.launches()
            with program.Traced(dev) as traced:
                for _ in range(tf["trace_calls"]):
                    one(spans=False)
            traced_s = program.now() - t0
            launched = (program.launches() - before if st["many"] is None
                        else program.by_kernel(
                            st["many"].launches_at_capture,
                            tf["trace_calls"]))
            continue
        one()
    program.sync(dev)
    window_s = program.now() - t_start
    events = traced.events() if traced is not None else None
    steps = len(losses) * n
    traced_steps = tf["trace_calls"] * n if traced is not None else 0
    lost = torch.cat(losses)
    failed = int((~torch.isfinite(lost)).sum())
    return {"metrics": {tf["metric"]: steps * tf["batch"] / window_s},
            "attempted": steps, "failed": failed,
            "run": {"kind": "train", "window_s": window_s,
                    "untraced_s": window_s - traced_s,
                    "untraced_units": (steps - traced_steps) * tf["batch"],
                    "spans": {"data_wait": waits, "step_call": calls},
                    "steps_per_span": n, "events": events,
                    "traced_units": traced_steps, "launches": launched}}


def release(st) -> None:
    st["feed"].close()
    for key in ("net", "opt", "call", "feed", "many"):
        st.pop(key, None)


def follow(ctx, st, prec: Precision = FP32, half: bool = False):
    """The reference through the followed calls, from the weights and the
    feed's patients and seeds: (losses, moment norms after the first call,
    change norms), by the program's leaf order.  `half`: each step takes
    the first half of its batch only (a planted fault)."""
    model, tc, tf = ctx.config["model"], ctx.config["train"], ctx.traffic
    dev, names = ctx.device, st["names"]
    w0 = st["w0"]
    params = rt.leaves(names, w0, dev)
    net = Net(model, prec)
    opt = rt.AdamW([params[k] for k in names], tc["lr"], tc["weight_decay"])
    gen = inputs.generator(ctx.seed, "augment", dev)
    losses, moments = [], None
    b = tf["batch"]
    with tf32(False):
        for t in range(tf["follow_calls"] * st["n"]):
            x, y = rt.crop_batch(st["patients"], st["stream"], t,
                                 (tf["patch"],) * 3, b)
            x, y = rt.augment(gen, torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev), **tc["augment"])
            if half:
                x, y = x[:b // 2], y[:b // 2]
            loss, grads = rt.train_grads(net, params, x, y)
            opt.step(grads)
            losses.append(loss)
            if t + 1 == st["n"]:
                moments = rt.norms(opt.mu)
    change = rt.norms([params[k] - w0[k] for k in names])
    return losses, moments, change


def numbers(prog, ref) -> dict:
    """The compared numbers of (losses, moments, change) against the
    reference's: the losses' gap, the worst leaf's moment and change gaps
    and the median leaf's moment gap."""
    moments = compare.leaf_gaps(prog[1], ref[1])
    return {"loss_gap": compare.loss_gap(prog[0], ref[0]),
            "moment_gap": max(moments),
            "moment_gap.median": statistics.median(moments),
            "change_gap": max(compare.leaf_gaps(prog[2], ref[2],
                                                compare.nonzero(ref[1])))}


def _prog(st):
    return st["prog_losses"], st["prog_moments"], st["prog_change"]


def check(ctx, st) -> dict:
    return numbers(_prog(st), follow(ctx, st))


def controls(ctx, st, raw: dict | None = None) -> dict:
    """The readings of the control (the reference in scaled fp8) and of
    the planted fault that leaves half of each batch out, against the
    reference; with the program's set-up run, its own reading (`sound`)
    too.  `raw` takes each side's (losses, moment norms, change norms)."""
    sides = {"reference": follow(ctx, st),
             "control_fp8": follow(ctx, st, FP8),
             "fault_half_batch": follow(ctx, st, half=True)}
    if "prog_losses" in st:
        sides["sound"] = _prog(st)
    if raw is not None:
        raw.update(sides)
    return {k: numbers(v, sides["reference"]) for k, v in sides.items()
            if k != "reference"}
