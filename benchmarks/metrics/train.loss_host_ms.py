"""Mean host ms of the program's ``train.loss`` span a window step
(``compute_loss``), from the port's recorder (``train/step.py``
``make_train_step``): with the other four parts, the step's whole host
time."""

from benchmarks.program_spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "train.loss")
