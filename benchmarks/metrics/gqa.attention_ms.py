"""Device ms of the program's ``gqa.attention`` spans a batch over the
window: each attention block's RMSNorm, projections, causal core with
grouped key / value heads (SDPA on the card) and residual add, from the
CUDA event pairs in the port's recorder (``models/decoder.py``
``MixerBlock.forward``); the mean span times the attention blocks of a
batch."""

from benchmarks.program_spans import mean_device_ms
from benchmarks.roofline_mamba import layer_counts


def read(run):
    ms = mean_device_ms(run, "gqa.attention")
    return ms * layer_counts(run.ctx.config)["attention"] \
        if ms is not None else None
