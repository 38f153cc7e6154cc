"""The routed experts' share of their roofline over the window: the
window's routed-expert FLOPs (every MoE layer's 6 experts' SwiGLU on every
real token, ``roofline_moe.routed_expert_flops``, from shapes and lengths
alone) a batch at 989 TFLOP/s, over the device time of a batch's
``moe.experts`` spans (the three grouped GEMMs with their dispatch and
combine)."""

from benchmarks.program_spans import mean_device_ms
from benchmarks.roofline import H100_BF16_FLOPS_PER_S
from benchmarks.roofline_moe import layer_counts


def read(run):
    ms = mean_device_ms(run, "moe.experts")
    flops, batches = run.work.get("routed_flops"), \
        run.work.get("window_batches")
    if ms is None or not flops or not batches:
        return None
    per_batch_s = ms * layer_counts(run.ctx.config)[1] / 1e3
    return 100.0 * flops / batches / (H100_BF16_FLOPS_PER_S * per_batch_s)
