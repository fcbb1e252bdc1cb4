"""alpha_share.search: the share (%) of a search step's device-busy time
launched inside its α-step (`search.alpha` within `search.step`)."""

from benchmark.harness import spans


def read(run):
    return spans.launched_share(run, "search", "search.alpha", "search.step")
