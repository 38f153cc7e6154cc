"""Mean host ms of the program's ``train.optimizer`` span a window step
(``apply_gradients``: clipping, AdamW, the schedule), from the port's
recorder (``train/step.py`` ``make_train_step``): the host's time to issue
that part of the step."""

from benchmarks.program_spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "train.optimizer")
