"""Mean queries a micro-batch over the window, from the service's own
counters (``MicroBatcher.queries_run`` over ``batches_run``, read before
and after the window)."""


def read(run):
    return run.work.get("batch_queries")
