"""The program under test as the benchmark drives it: its nets built from
a configuration file and loaded with the benchmark's weights, its launch
counter, and the device fences and profiler the drivers wrap around it.
The program is imported here, when a driver first asks, and nowhere in
the reference."""

from __future__ import annotations

import collections
import json
import time
from typing import Mapping

import torch

from . import trace as tr


def derived_net(model: Mapping, dtype: str, weights: Mapping, device):
    """The program's derived net of the configuration's genotype, on
    `device`, holding `weights`."""
    from nas_3d_unet_tpu_torch.models.genotype import Genotype
    from nas_3d_unet_tpu_torch.models.unet import DerivedNet

    geno = dict(model["genotype"], n_nodes=model["n_nodes"])
    net = DerivedNet(Genotype.from_json(json.dumps(geno)),
                     in_channels=model["in_channels"],
                     num_classes=model["num_classes"],
                     base_channels=model["base_channels"],
                     depth=model["depth"], n_nodes=model["n_nodes"],
                     gn_groups=model["gn_groups"], dtype=dtype)
    return _loaded(net, weights, device)


def supernet(model: Mapping, dtype: str, pc_k: int, weights: Mapping,
             device):
    """The program's supernet, on `device`, holding `weights`."""
    from nas_3d_unet_tpu_torch.models.unet import SuperNet

    net = SuperNet(in_channels=model["in_channels"],
                   num_classes=model["num_classes"],
                   base_channels=model["base_channels"],
                   depth=model["depth"], n_nodes=model["n_nodes"],
                   gn_groups=model["gn_groups"], dtype=dtype, pc_k=pc_k)
    return _loaded(net, weights, device)


def _loaded(net, weights, device):
    net.to(device)
    net.load_state_dict(dict(weights), strict=True)
    return net


def launches() -> collections.Counter:
    """The program's kernel launches so far, by kernel (dtype suffix
    dropped)."""
    from nas_3d_unet_tpu_torch.ops import _cuda

    return by_kernel(_cuda.LAUNCHES)


def by_kernel(counter, times: int = 1) -> collections.Counter:
    """Launch counts keyed `<kernel>_<dtype>` summed by kernel, times
    `times`."""
    out = collections.Counter()
    for k, v in counter.items():
        out[k.rsplit("_", 1)[0]] += v * times
    return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Traced:
    """The profiled part of a window: `torch.profiler` over CPU (and the
    card), a `trace.WINDOW` range around the work, the device drained
    before and inside it.  `events()` exports the trace's complete events:
    call it once the window has closed."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self._prof = profile(activities=acts)
        self._range = record_function(tr.WINDOW)

    def __enter__(self):
        sync(self.device)
        self._prof.start()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self._range.__exit__(*exc)
        self._prof.stop()

    def events(self) -> list:
        return tr.export(self._prof)


def now() -> float:
    return time.perf_counter()
