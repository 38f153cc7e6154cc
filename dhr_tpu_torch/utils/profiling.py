"""Phase timing and ``torch.profiler`` traces.

Port of ``dhr_tpu/utils/profiling.py``: a pipeline stage wraps itself in
:func:`phase` for accumulated wall times, and :func:`trace` captures a
``torch.profiler`` trace of a block (the reference's ``jax.profiler``
one), written as a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

logger = logging.getLogger("dhr_tpu_torch.profiling")

_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase(name: str, log: bool = False):
    """Time a named phase; accumulate it into the module's report."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _totals[name] += dt
        _counts[name] += 1
        if log:
            logger.info("%s: %.3fs", name, dt)


def report() -> dict[str, dict]:
    """``{name: {"total_s", "count", "mean_s"}}`` of every phase since the
    last :func:`reset`."""
    return {
        k: {"total_s": _totals[k], "count": _counts[k],
            "mean_s": _totals[k] / _counts[k]}
        for k in _totals
    }


def reset() -> None:
    _totals.clear()
    _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU, and CUDA when a GPU is present)
    and write ``log_dir/trace.json`` (Chrome trace format, also on
    error); yields the ``torch.profiler.profile``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
