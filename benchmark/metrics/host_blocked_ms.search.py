"""host_blocked_ms.search: host ms a search step (`search.step` ranges)
spends in CUDA calls that wait for the device."""

from benchmark.harness import spans


def read(run):
    return spans.blocked_ms(run, "search", "search.step")
