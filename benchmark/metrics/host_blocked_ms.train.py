"""host_blocked_ms.train: host ms a train step (`train.step` ranges)
spends in CUDA calls that wait for the device."""

from benchmark.harness import spans


def read(run):
    return spans.blocked_ms(run, "train", "train.step")
