"""Device ms of the program's ``kda.attention`` spans a batch over the
window: each KDA layer's input RMSNorm, Kimi Delta Attention (projections,
short convolutions, gates, the chunked scan, the gated norm, ``o_proj``)
and residual add, from the CUDA event pairs in the port's recorder
(``models/decoder.py`` ``DecoderLayer.forward``); the mean span times the
KDA layers of a batch."""

from benchmarks.program_spans import mean_device_ms
from benchmarks.roofline_kda import layer_counts


def read(run):
    ms = mean_device_ms(run, "kda.attention")
    return ms * layer_counts(run.ctx.config)["kda"] if ms is not None \
        else None
