"""The port's spans (`utils/profiling.py` `annotate`): the names, counts
and nesting that a train step, an n-step call, a search step, the
Prefetcher and `predict_records` record; the ring's bound; no profiler
range while no profiler runs; and a span made on a thread that started
before the profiler placed on the trace's timeline by the benchmark's
alignment (`benchmark/harness/spans.py`).  Spans are counted, never
timed."""

import collections
import json
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from benchmark.harness import spans as bench_spans
from nas_3d_unet_tpu_torch.data.pipeline import PatchGenerator, Prefetcher
from nas_3d_unet_tpu_torch.infer.predict import predict_records
from nas_3d_unet_tpu_torch.infer.sliding import SlidingWindowPredictor
from nas_3d_unet_tpu_torch.models.genotype import (default_genotype,
                                                   init_alphas)
from nas_3d_unet_tpu_torch.models.unet import DerivedNet, SuperNet
from nas_3d_unet_tpu_torch.search import bilevel
from nas_3d_unet_tpu_torch.train import loop
from nas_3d_unet_tpu_torch.train.optim import make_optimizer
from nas_3d_unet_tpu_torch.utils import profiling
from tests.torch_helpers import ROOT
from tests.torch_helpers import one_torch_thread  # noqa: F401

SMALL = dict(in_channels=4, num_classes=3, base_channels=4, depth=1,
             n_nodes=2, gn_groups=4)
AUGMENT = dict(flip_prob=0.5, intensity_shift=0.1, intensity_scale=0.1)
# every span the port records
NAMES = {"train.step", "train.augment", "step.forward", "step.backward",
         "train.optim", "train.step_n", "train.stage", "train.replay",
         "search.step", "search.augment", "search.alpha", "search.weights",
         "data.fetch", "data.assemble", "data.stage", "serve.dispatch",
         "serve.upload", "serve.forward", "serve.stitch", "serve.decode",
         "serve.finalize", "serve.readback"}


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _batch(b=2, s=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, s, s, 4), generator=g)
    return x, (x[..., :3] > 0.5).float()


def _counts(ring):
    return collections.Counter(s[0] for s in ring)


def _inside(child, parent) -> bool:
    return child[1] == parent[1] and parent[2] <= child[2] \
        and child[3] <= parent[3]


def _each_inside(ring, child: str, parent: str) -> None:
    parents = [s for s in ring if s[0] == parent]
    for s in ring:
        if s[0] == child:
            assert any(_inside(s, p) for p in parents), (child, parent)


def _derived():
    torch.manual_seed(0)
    return DerivedNet(default_genotype(2), **SMALL)


@pytest.mark.parametrize("microbatch,slices", [(0, 1), (1, 2)])
def test_a_train_step_records_its_spans(microbatch, slices):
    net = _derived()
    step = loop.make_train_step(
        net, make_optimizer(net.parameters(), 1e-3, 1e-4), augment=AUGMENT,
        microbatch=microbatch, gen=torch.Generator().manual_seed(1))
    step(*_batch())
    ring = profiling.spans()
    assert _counts(ring) == {"train.step": 1, "train.augment": 1,
                             "step.forward": slices,
                             "step.backward": slices, "train.optim": 1}
    for child in ("train.augment", "step.forward", "step.backward",
                  "train.optim"):
        _each_inside(ring, child, "train.step")
    # a slice's backward follows its forward
    order = [s[0] for s in sorted(ring, key=lambda s: s[2])][2:-1]
    assert order == ["step.forward", "step.backward"] * slices


def test_an_n_step_call_records_its_spans():
    """On the CPU the n steps run eagerly inside `train.step_n` (the card
    replays them in `train.replay`)."""
    net = _derived()
    step_n = loop.make_train_step_n(
        net, make_optimizer(net.parameters(), 1e-3, 1e-4), augment=AUGMENT,
        gen=torch.Generator().manual_seed(1), n=2)
    xs, ys = zip(_batch(seed=0), _batch(seed=1))
    step_n(xs, ys)
    ring = profiling.spans()
    assert _counts(ring) == {"train.step_n": 1, "train.stage": 1,
                             "train.step": 2, "train.augment": 2,
                             "step.forward": 2, "step.backward": 2,
                             "train.optim": 2}
    for child in ("train.stage", "train.step"):
        _each_inside(ring, child, "train.step_n")


def _search_parts():
    torch.manual_seed(0)
    net = SuperNet(**SMALL)
    alphas = {k: v.requires_grad_() for k, v in
              init_alphas(torch.Generator().manual_seed(0), 2).items()}
    return (net, make_optimizer(net.parameters(), 1e-3, 1e-4),
            make_optimizer(alphas.values(), 1e-3, 1e-4), alphas)


@pytest.mark.parametrize("unrolled", [False, True],
                         ids=["first_order", "second_order"])
def test_a_search_step_records_its_spans(unrolled):
    net, w_opt, a_opt, alphas = _search_parts()
    kw = dict(gen=torch.Generator().manual_seed(1))
    if unrolled:
        step = bilevel.make_search_step_unrolled(net, w_opt, a_opt, alphas,
                                                 1e-3, AUGMENT, **kw)
    else:
        step = bilevel.make_search_step(net, w_opt, a_opt, alphas, AUGMENT,
                                        **kw)
    step(*_batch(b=1), *_batch(b=1, seed=1))
    ring = profiling.spans()
    assert _counts(ring) == {"search.step": 1, "search.augment": 1,
                             "search.alpha": 1, "search.weights": 1,
                             "step.forward": 1, "step.backward": 1}
    for child in ("search.augment", "search.alpha", "search.weights"):
        _each_inside(ring, child, "search.step")
    for child in ("step.forward", "step.backward"):
        _each_inside(ring, child, "search.weights")


class _Pool:
    label_mode = "regions"

    def __init__(self):
        rng = np.random.default_rng(0)
        self.records = [{"image": rng.standard_normal(
            (10, 10, 10, 4)).astype(np.float32),
            "label_u8": rng.choice(np.array([0, 1, 2, 4], np.uint8),
                                   (10, 10, 10))} for _ in range(2)]

    def __len__(self):
        return len(self.records)


def test_the_prefetcher_records_its_spans():
    feed = Prefetcher(PatchGenerator(_Pool(), (8, 8, 8), 2, augment=False),
                      torch.device("cpu"), depth=2)
    try:
        for _ in range(3):
            feed.next()
    finally:
        feed.close()
    ring = profiling.spans()
    me = threading.get_ident()
    fetch = [s for s in ring if s[0] == "data.fetch"]
    assert len(fetch) == 3 and all(s[1] == me for s in fetch)
    worker = sorted((s for s in ring if s[0] != "data.fetch"),
                    key=lambda s: s[2])
    assert me not in {s[1] for s in worker}
    assert [s[0] for s in worker] == ["data.assemble", "data.stage"] * (
        len(worker) // 2) and len(worker) >= 6


def test_predict_records_records_its_spans():
    torch.manual_seed(0)
    net = DerivedNet(default_genotype(2), **SMALL)
    pred = SlidingWindowPredictor(net, (8, 8, 8), overlap=0.5, batch_size=2)
    rng = np.random.default_rng(0)
    # 2 and 4 windows: one and two batches of 2
    shapes = [(8, 8, 12), (8, 12, 12)]
    records = [(None, {"patient": f"p{i}",
                       "image": rng.standard_normal(
                           (*s, 4)).astype(np.float32),
                       "crop_start": (0, 0, 0), "orig_shape": s})
               for i, s in enumerate(shapes)]
    out = predict_records(pred, records, verbose=False)
    assert [r["patient"] for r in out] == ["p0", "p1"]
    ring = profiling.spans()
    assert _counts(ring) == {"serve.dispatch": 2, "serve.upload": 2,
                             "serve.forward": 3, "serve.stitch": 3,
                             "serve.decode": 2, "serve.finalize": 2,
                             "serve.readback": 2}
    for child in ("serve.upload", "serve.forward", "serve.stitch",
                  "serve.decode"):
        _each_inside(ring, child, "serve.dispatch")
    _each_inside(ring, "serve.readback", "serve.finalize")
    me = threading.get_ident()
    assert all((s[1] == me) == (s[0] not in ("serve.finalize",
                                             "serve.readback"))
               for s in ring)


def test_the_ring_keeps_the_newest_spans_up_to_its_bound():
    n = profiling.SPANS_MAXLEN
    for i in range(n + 10):
        with profiling.annotate(f"s{i}"):
            pass
    ring = profiling.spans()
    assert len(ring) == n
    assert ring[0][0] == "s10" and ring[-1][0] == f"s{n + 9}"


def test_spans_from_many_threads_are_all_kept_and_read_safely():
    """More threads than cores close spans while the ring is read: no span
    is lost and no read fails."""
    threads, each = 2 * (os.cpu_count() or 4), 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(name):
            for _ in range(each):
                with profiling.annotate(name):
                    pass

        ts = [threading.Thread(target=work, args=(f"s{k}",))
              for k in range(threads)]
        for t in ts:
            t.start()
        while any(t.is_alive() for t in ts):
            profiling.spans()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert _counts(profiling.spans()) == {f"s{k}": each
                                          for k in range(threads)}


def test_without_a_profiler_a_span_opens_no_range(monkeypatch):
    opened = []

    def noted(name):
        opened.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", noted)
    with profiling.annotate("train.step"):
        pass
    assert opened == [] and _counts(profiling.spans()) == {"train.step": 1}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("train.step"):
            pass
    assert opened == ["train.step"]
    assert _counts(profiling.spans()) == {"train.step": 2}


def test_a_worker_span_is_placed_inside_the_range_that_brackets_it(
        tmp_path):
    """The worker thread starts before the profiler, so its range is not
    in the trace; the ring's span is placed on the trace's clock from the
    main thread's spans, inside the main range that was open around it."""
    go, done, stop = (threading.Event() for _ in range(3))

    def worker():
        while not stop.is_set():
            if go.wait(timeout=0.05):
                go.clear()
                with profiling.annotate("data.stage"):
                    torch.ones(64).sum()
                done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        for _ in range(3):                   # before the profiler: not traced
            with profiling.annotate("train.step"):
                pass
        with profiling.trace(str(tmp_path)):
            for i in range(4):
                with profiling.annotate("train.step"):
                    with profiling.annotate("data.fetch"):
                        if i == 2:
                            go.set()
                            done.wait()
    finally:
        stop.set()
        t.join()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    fetches = bench_spans.ranges(events, "data.fetch")
    assert len(fetches) == 4
    (placed,) = bench_spans.placed(events, profiling.spans(), {"data.stage"})
    s, e = fetches[2]
    assert placed[1] == t.ident
    assert s - 500 <= placed[2] and placed[3] <= e + 500


def test_every_span_name_comes_from_the_port_through_annotate():
    """The port opens its spans through `annotate` alone, with the names
    above; no module but `utils/profiling.py` opens a profiler range."""
    pkg = ROOT / "nas_3d_unet_tpu_torch"
    found = set()
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        found |= set(re.findall(r'annotate\("([\w.]+)"\)', text))
        if path.name != "profiling.py":
            assert "record_function" not in text, path
            assert "nvtx" not in text, path
    assert found == NAMES
