"""stitch_device_ms.serve: device ms a patient outside the net's forwards."""

from benchmark.harness import readers


def read(run):
    return readers.stitch_device_ms(run)
