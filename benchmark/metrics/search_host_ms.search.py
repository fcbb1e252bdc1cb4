"""search_host_ms.search: host ms from calling the bilevel step to its
return."""

from benchmark.harness import readers


def read(run):
    return readers.host_ms(run, "search", "step_call")
