"""The readers of the program's own spans and counters: each keeps what
starts and ends inside the window, and reads nothing from a program
without the recorder."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmarks import harness, program_spans
from dhr_tpu_torch.utils import profiling

HOST = ("train.prep_host_ms", "train.forward_host_ms", "train.loss_host_ms",
        "train.backward_host_ms", "train.optimizer_host_ms",
        "search.plan_gap_ms", "encode.wait_ms")
DEVICE = ("search.copy_back_ms", "encode.copy_back_ms")
SPAN_OF = {m: m.rsplit("_", 2)[0] if m.endswith("_host_ms")
           else m[:-len("_ms")] for m in HOST + DEVICE}


def fake_run(t0: float, t1: float):
    """A run whose window is ``[t0, t1]`` on the host clock."""
    ctx = SimpleNamespace(t_start=t0 - 20.0, setup_s=20.0)
    return SimpleNamespace(ctx=ctx, window_s=t1 - t0)


class Event:
    def __init__(self, ms: float):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def straddle(name: str, t0: float, t1: float, device: bool) -> None:
    """Spans of ``name`` before, across and after the window's edges (each
    1000 ms, device 100 ms), and two inside it (4 and 6 ms, device 1 and
    3 ms)."""
    for start, end, dev in ((t0 - 5, t0 - 4, 100.0), (t0 - 0.5, t0 + 0.5,
                                                      100.0),
                            (t0 + 1, t0 + 1.004, 1.0),
                            (t0 + 5, t0 + 5.006, 3.0),
                            (t1 - 0.5, t1 + 0.5, 100.0),
                            (t1 + 1, t1 + 2, 100.0)):
        s = profiling.record(name, start, end)
        if device:
            s.start_event, s.end_event = Event(0.0), Event(dev)


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("metric", HOST + DEVICE)
def test_reader_keeps_the_spans_inside_the_window(metric):
    t0, t1 = 1000.0, 1010.0
    straddle(SPAN_OF[metric], t0, t1, metric in DEVICE)
    got = harness.load_reader(metric).read(fake_run(t0, t1))
    assert got == pytest.approx(2.0 if metric in DEVICE else 5.0)
    assert harness.load_reader(metric).read(fake_run(t1 + 5, t1 + 9)) \
        is None


def test_host_reads_counts_the_windows_reads_a_batch():
    profiling.count("search.host_reads", 7)          # before the window
    t0 = time.perf_counter()
    for _ in range(3):
        profiling.count("search.host_reads")
    time.sleep(0.001)
    t1 = time.perf_counter()
    profiling.count("search.host_reads", 7)          # after it
    for a, b in ((0.1, 0.2), (0.5, 0.6), (0.9, 1.1), (-0.1, 0.05)):
        profiling.record("search.plan_gap", t0 + a * (t1 - t0),
                         t0 + b * (t1 - t0))
    read = harness.load_reader("search.host_reads").read
    assert read(fake_run(t0, t1)) == pytest.approx(3 / 2)
    assert read(fake_run(t1 + 1, t1 + 2)) is None


@pytest.mark.parametrize("metric", HOST + DEVICE + ("search.host_reads",))
def test_reader_reads_nothing_from_a_program_without_the_recorder(
        metric, monkeypatch):
    """An older program's ``utils.profiling`` (no ``spans``): None, no
    error."""
    t0, t1 = 1000.0, 1010.0
    straddle(SPAN_OF.get(metric, "search.plan_gap"), t0, t1, True)
    monkeypatch.setattr(harness, "import_program",
                        lambda name: SimpleNamespace(report=dict))
    assert program_spans.recorder() is None
    assert harness.load_reader(metric).read(fake_run(t0, t1)) is None
