"""finalize_host_ms.serve: host ms a patient on the writer thread in
`serve.finalize` less its `serve.readback`, over the patients finalized
inside the traced part."""

from benchmark.harness import spans


def read(run):
    return spans.finalize_ms(run)
