"""Mean host ms to issue one train step over the window: the step call to
its return, with no synchronise (the step returns its loss on the device),
on the host clock."""


def read(run):
    ms = run.work.get("host_ms")
    return sum(ms) / len(ms) if ms else None
