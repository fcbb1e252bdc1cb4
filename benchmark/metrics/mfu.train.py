"""mfu.train: model FLOPs over the window over the peak of the
configuration's precision, %."""

from benchmark.harness import readers


def read(run):
    return readers.mfu(run, "train")
