"""The whole search's share of the card's peak over the window: the least
time of every batch's work at the HBM peak (stage 1 and selection as in
``search.candidates_roofline``, plus the rerank reading each query's pool
rows once and writing its top-k once) over the window's length.  Search
does no work that the FLOP peak bounds first."""

from benchmarks.roofline import H100_HBM_BYTES_PER_S


def read(run):
    per_call = run.work.get("search_bytes")
    calls = run.work.get("calls")
    if not per_call or not calls or not run.window_s:
        return None
    least_s = sum(per_call) * calls / H100_HBM_BYTES_PER_S
    return 100.0 * least_s / run.window_s
