"""The train steps' share of the card's bf16 peak over the window: three
times the forward FLOPs of every step's real tokens, queries and passages
(``roofline.train_step_flops``), over 989 TFLOP/s times the window's
length."""

from benchmarks.roofline import H100_BF16_FLOPS_PER_S


def read(run):
    flops = run.work.get("flops")
    if not flops or not run.window_s:
        return None
    return 100.0 * flops / (H100_BF16_FLOPS_PER_S * run.window_s)
