"""Device-to-host reads a batch over the window: the program's counter
``search.host_reads`` (each read of device data by the staging plan,
``ops/partial_gip.py`` ``staging_plan``) over the window's batches, one
``search.plan_gap`` span each, from the port's recorder."""

from benchmarks.program_spans import counted, spans


def read(run):
    reads, batches = counted(run, "search.host_reads"), \
        len(spans(run, "search.plan_gap"))
    return reads / batches if reads is not None and batches else None
