"""Stage 1 and selection's share of their roofline over the window: the
least time of each batch's work (``roofline.candidates_bytes``: the used
dims' value and fold rows read once, the pool written once, at the HBM
peak) over the device time ``Searcher.candidates`` took, summed over every
batch of every call."""

from benchmarks.roofline import H100_HBM_BYTES_PER_S


def read(run):
    ms = run.spans.get("search.candidates")
    per_call = run.work.get("candidates_bytes")
    if not ms or not per_call or len(ms) % len(per_call):
        return None
    least_s = sum(per_call) * (len(ms) // len(per_call)) \
        / H100_HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(ms) / 1e3)
