"""hand_kernel_roofline.serve: the hand kernels' least time over their
device time, %."""

from benchmark.harness import readers


def read(run):
    return readers.hand_kernel_roofline(run, "serve")
