"""step_idle_ms.train: device-idle ms inside a train step (`train.step`
ranges)."""

from benchmark.harness import spans


def read(run):
    return spans.idle_ms(run, "train", "train.step")
