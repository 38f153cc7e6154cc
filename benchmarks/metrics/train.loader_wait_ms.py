"""Mean host ms a window step waits for its batch from the port's loader
thread (``next`` on the epoch's iterator, before the step is called), on
the host clock: above 0 only where collation falls behind the step."""


def read(run):
    ms = run.work.get("wait_ms")
    return sum(ms) / len(ms) if ms else None
