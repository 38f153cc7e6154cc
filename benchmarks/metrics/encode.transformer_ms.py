"""Mean device ms of the passage tower's transformer stack a batch over the
window, from CUDA events in forward hooks on the port's
``TransformerEncoder``."""


def read(run):
    ms = run.spans.get("encode.transformer")
    return sum(ms) / len(ms) if ms else None
