"""Mean host ms of the program's ``search.plan_gap`` span a batch over the
window, from the port's recorder (``ops/partial_gip.py``): from the return
of the staging plan's last read of the device to K1's launch, when the
device has nothing queued."""

from benchmarks.program_spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "search.plan_gap")
