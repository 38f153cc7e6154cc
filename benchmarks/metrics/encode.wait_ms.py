"""Mean host ms of the program's ``encode.wait`` span a batch over the
window, from the port's recorder (``encode.py`` ``Encoder._run_batches``):
the host waiting for a batch's copies while the next batch computes, the
share of a batch by which the host runs ahead of the device."""

from benchmarks.program_spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "encode.wait")
