"""step_host_ms.train: host ms from calling the train step to its return,
per step."""

from benchmark.harness import readers


def read(run):
    return readers.host_ms(run, "train", "step_call")
