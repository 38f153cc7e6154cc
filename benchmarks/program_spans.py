"""The program's own spans and counters over a run's window, for the
per-layer metrics that read them.

The port records spans and counters in its recorder
(``dhr_tpu_torch.utils.profiling``): each span with its host start and end
on ``time.perf_counter()``, the harness's clock, and a device span with a
CUDA event pair.  A reader here keeps the spans that start and end inside
the window, ``[t_start + setup_s, that + window_s]``, and the counts made
inside it, so its number comes from the calls the end-to-end metric
counts.  A program without the recorder (an older checkout) gives None,
and so does a window with no such span.
"""

from __future__ import annotations


def recorder():
    """The program's recorder module, or None where it has none."""
    from benchmarks.harness import import_program

    try:
        rec = import_program("dhr_tpu_torch.utils.profiling")
    except ImportError:
        return None
    return rec if hasattr(rec, "spans") and hasattr(rec, "counters") \
        else None


def window(run):
    """``(t0, t1)`` of the run's window on the host clock, or None."""
    ctx = run.ctx
    if ctx.setup_s is None or not run.window_s:
        return None
    t0 = ctx.t_start + ctx.setup_s
    return t0, t0 + run.window_s


def spans(run, name: str) -> list:
    """The program's ``name`` spans inside the window (empty without the
    recorder)."""
    rec, win = recorder(), window(run)
    if rec is None or win is None:
        return []
    return rec.spans(name, *win)


def mean_host_ms(run, name: str):
    """Mean host ms of the window's ``name`` spans, or None."""
    got = spans(run, name)
    return sum((s.end - s.start) * 1e3 for s in got) / len(got) \
        if got else None


def mean_device_ms(run, name: str):
    """Mean device ms of the window's ``name`` spans (their CUDA event
    pairs), or None where they have none."""
    got = [s.device_ms() for s in spans(run, name)]
    got = [ms for ms in got if ms is not None]
    return sum(got) / len(got) if got else None


def counted(run, name: str):
    """The counter ``name``'s counts made inside the window, or None."""
    rec, win = recorder(), window(run)
    if rec is None or win is None:
        return None
    return rec.counters(*win).get(name)
