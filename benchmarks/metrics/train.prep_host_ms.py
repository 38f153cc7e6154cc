"""Mean host ms of the program's ``train.prep`` span a window step (the
batch to the device, the dropout generator, the gradients cleared), from
the port's recorder (``train/step.py`` ``make_train_step``): the host's
time to issue that part of the step."""

from benchmarks.program_spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "train.prep")
