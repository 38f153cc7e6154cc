"""Device ms of the program's ``moe.experts`` spans a batch over the window:
each MoE layer's dispatch, three grouped GEMMs and combine (the shared
experts outside), from the CUDA event pairs in the port's recorder
(``models/decoder.py`` ``MoE.forward``); the mean span times the MoE
layers of a batch."""

from benchmarks.program_spans import mean_device_ms
from benchmarks.roofline_moe import layer_counts


def read(run):
    ms = mean_device_ms(run, "moe.experts")
    return ms * layer_counts(run.ctx.config)[1] if ms is not None else None
