"""Device ms of the program's ``mamba.scan`` spans a batch over the
window: each Mamba-2 mixer's SSD recurrence alone, from its
post-convolution x, B and C, dt, A and D to y, from the CUDA event pairs
in the port's recorder (``models/decoder.py`` ``Mamba2.forward``); the
mean span times the Mamba-2 blocks of a batch."""

from benchmarks.program_spans import mean_device_ms
from benchmarks.roofline_mamba import layer_counts


def read(run):
    ms = mean_device_ms(run, "mamba.scan")
    return ms * layer_counts(run.ctx.config)["mamba"] if ms is not None \
        else None
