"""data_wait_ms.train: host ms a train step waits for its staged batch (the
fetch from the Prefetcher)."""

from benchmark.harness import readers


def read(run):
    return readers.host_ms(run, "train", "data_wait")
