"""Mean device ms of the program's ``search.copy_back`` span a call over
the window, from its CUDA event pair in the port's recorder
(``retrieval/searcher.py`` ``Searcher._run``): the results' join and their
pageable copy to the host."""

from benchmarks.program_spans import mean_device_ms


def read(run):
    return mean_device_ms(run, "search.copy_back")
