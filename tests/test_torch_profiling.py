"""The port's profiling hooks (nas_3d_unet_tpu_torch/utils/profiling.py),
the counterparts of tests/test_utils.py's: a trace file written that holds
the annotation's name, `device_memory_stats` a dict, and `debug_nans`
raising at the first op that outputs a NaN, forward ops included (the
JAX package's `jax_debug_nans` does; autograd's anomaly mode alone checks
only backward outputs), naming the op, and at a NaN made in the backward;
`--debug-nans` on a command goes through it."""

import json
import os

import pytest
import torch

from nas_3d_unet_tpu_torch import cli
from nas_3d_unet_tpu_torch.utils import profiling
from tests.torch_helpers import one_torch_thread  # noqa: F401


def test_trace_holds_the_annotation(tmp_path):
    log_dir = str(tmp_path / "prof")
    with profiling.trace(log_dir):
        with profiling.annotate("test_scope"):
            (torch.ones(4, 4) @ torch.ones(4, 4)).sum()
    (name,) = os.listdir(log_dir)
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "test_scope" for e in events)
    assert any("mm" in str(e.get("name")) for e in events)


def test_device_memory_stats_is_a_dict():
    assert isinstance(profiling.device_memory_stats(), dict)
    assert profiling.device_memory_stats("cpu") == {}


@pytest.fixture
def nans_off():
    yield
    profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()


def test_debug_nans_raises_at_a_forward_op(nans_off):
    x = torch.zeros(4) - 1.0
    torch.log(x)                             # off: NaN passes silently
    profiling.debug_nans(True)
    with pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(x)
    with torch.no_grad():                    # no graph needed
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.nn.functional.relu(torch.sqrt(x))
    torch.empty(1000)                        # uninitialised memory: no fault
    profiling.debug_nans(False)
    assert torch.isnan(torch.log(x)).all()


def test_debug_nans_raises_at_a_backward_nan(nans_off):
    """sqrt(0)·0 is finite, its backward 0 / 0 is not."""
    x = torch.zeros(3, requires_grad=True)
    profiling.debug_nans(True)
    y = (torch.sqrt(x) * 0).sum()
    with pytest.raises((FloatingPointError, RuntimeError), match="(?i)nan"):
        y.backward()


def test_cli_debug_nans_checks_forward_only_commands(monkeypatch, nans_off):
    """A command that only runs forwards (as `predict` does) and makes a
    NaN raises under --debug-nans and returns without it; the check is
    off again after the command."""
    def forward_only(args, device):
        torch.log(torch.zeros(2, device=device) - 1)
        return 0

    monkeypatch.setattr(cli, "cmd_predict", forward_only)
    assert cli.main(["predict", "--device", "cpu"]) == 0
    with pytest.raises(FloatingPointError):
        cli.main(["predict", "--device", "cpu", "--debug-nans"])
    assert not torch.is_anomaly_enabled()
    torch.log(torch.zeros(2) - 1)
