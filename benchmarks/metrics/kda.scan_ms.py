"""Device ms of the program's ``kda.scan`` spans a batch over the window:
each KDA layer's recurrence alone, from its post-convolution q / k / v,
log-decays and beta to its output before the gated norm, from the CUDA
event pairs in the port's recorder (``models/decoder.py`` ``KDA.forward``);
the mean span times the KDA layers of a batch."""

from benchmarks.program_spans import mean_device_ms
from benchmarks.roofline_kda import layer_counts


def read(run):
    ms = mean_device_ms(run, "kda.scan")
    return ms * layer_counts(run.ctx.config)["kda"] if ms is not None \
        else None
