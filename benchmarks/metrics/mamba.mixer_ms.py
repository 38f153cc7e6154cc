"""Device ms of the program's ``mamba.mixer`` spans a batch over the
window: each Mamba-2 block's RMSNorm, mixer (``in_proj``, the depthwise
convolution, dt, the SSD scan, the gated norm, ``out_proj``) and residual
add, from the CUDA event pairs in the port's recorder
(``models/decoder.py`` ``MixerBlock.forward``); the mean span times the
Mamba-2 blocks of a batch."""

from benchmarks.program_spans import mean_device_ms
from benchmarks.roofline_mamba import layer_counts


def read(run):
    ms = mean_device_ms(run, "mamba.mixer")
    return ms * layer_counts(run.ctx.config)["mamba"] if ms is not None \
        else None
