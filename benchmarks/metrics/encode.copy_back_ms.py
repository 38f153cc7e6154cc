"""Mean device ms of the program's ``encode.copy_back`` span a batch over
the window, from its CUDA event pair in the port's recorder (``encode.py``
``Encoder._copy_back``): a batch's planes copied to the host on the
compute stream."""

from benchmarks.program_spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "encode.copy_back")
