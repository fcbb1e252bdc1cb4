"""device_idle.search: the device's idle share of the traced part, %."""

from benchmark.harness import readers


def read(run):
    return readers.device_idle(run, "search")
