"""dispatch_host_ms.serve: host ms in `serve.dispatch` (a patient's device
work queued, the volume's upload included) per `serve.forward` it issues,
so that the patients the traced part happens to hold, of 2 to 12 windows,
do not move it."""

from benchmark.harness import spans


def read(run):
    return spans.ms_per_inner(run, "serve", "serve.dispatch", "serve.forward")
