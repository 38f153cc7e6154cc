"""Mean device ms of ``Searcher.stage2`` (the K2 rerank and the final
top-k) a batch over the window, from CUDA events around each call."""


def read(run):
    ms = run.spans.get("search.rerank")
    return sum(ms) / len(ms) if ms else None
