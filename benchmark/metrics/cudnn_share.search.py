"""cudnn_share.search: cuDNN's share of the traced device-busy time, %."""

from benchmark.harness import readers


def read(run):
    return readers.cudnn_share(run, "search")
