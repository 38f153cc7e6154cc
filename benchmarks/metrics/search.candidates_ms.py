"""Mean device ms of ``Searcher.candidates`` (stage 1 and selection) a
batch over the window, from the harness's CUDA events around each call."""


def read(run):
    ms = run.spans.get("search.candidates")
    return sum(ms) / len(ms) if ms else None
