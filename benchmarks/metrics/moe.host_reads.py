"""Device-to-host reads a batch inside the MoE layers over the window: the
program's counter ``moe.host_reads`` (the reads each layer made, counted
once a layer: 0 on the grouped path) over the window's ``moe.experts``
spans (one a layer), times the MoE layers of a batch, from the port's
recorder."""

from benchmarks.program_spans import counted, spans
from benchmarks.roofline_moe import layer_counts


def read(run):
    reads, layers = counted(run, "moe.host_reads"), \
        len(spans(run, "moe.experts"))
    if reads is None or not layers:
        return None
    return reads / layers * layer_counts(run.ctx.config)[1]
