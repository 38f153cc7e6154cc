"""Device ms of the program's ``mla.attention`` spans a batch over the
window: each layer's input RMSNorm, latent attention and residual add,
from the CUDA event pairs in the port's recorder (``models/decoder.py``
``DecoderLayer.forward``); the mean span times the layers of a batch."""

from benchmarks.program_spans import mean_device_ms
from benchmarks.roofline_moe import layer_counts


def read(run):
    ms = mean_device_ms(run, "mla.attention")
    return ms * sum(layer_counts(run.ctx.config)) if ms is not None \
        else None
