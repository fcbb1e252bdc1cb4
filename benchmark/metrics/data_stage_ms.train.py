"""data_stage_ms.train: host ms a batch in the Prefetcher's workers
(`data.assemble` + `data.stage`), over the batches staged inside the
traced part."""

from benchmark.harness import spans


def read(run):
    return spans.stage_ms(run)
