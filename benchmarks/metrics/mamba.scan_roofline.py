"""The SSD scans' share of their roofline over the window: a batch's scan
work (every Mamba-2 mixer's chunked-algorithm FLOPs at 989 TFLOP/s or its
bytes at 3.35 TB/s, whichever takes longer; ``roofline_mamba.scan_flops``
/ ``scan_bytes``, from widths and real lengths alone) over the device time
of a batch's ``mamba.scan`` spans."""

from benchmarks.program_spans import mean_device_ms
from benchmarks.roofline import H100_BF16_FLOPS_PER_S, H100_HBM_BYTES_PER_S
from benchmarks.roofline_mamba import layer_counts


def read(run):
    ms = mean_device_ms(run, "mamba.scan")
    flops, nbytes, batches = (run.work.get(k) for k in (
        "mamba_scan_flops", "mamba_scan_bytes", "window_batches"))
    if ms is None or not flops or not nbytes or not batches:
        return None
    bound_s = max(flops / H100_BF16_FLOPS_PER_S,
                  nbytes / H100_HBM_BYTES_PER_S) / batches
    return 100.0 * bound_s / (ms * layer_counts(run.ctx.config)["mamba"]
                              / 1e3)
