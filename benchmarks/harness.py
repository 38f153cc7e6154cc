"""The benchmark's harness: finds a cell's files by name, times set-up and
the window, traces it, reads the per-layer metrics, compares the outputs
and prints the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Everything that
belongs to it is found by name, so a new cell, configuration or per-layer
metric is new files only:

- ``benchmarks/configs/<config>.json``: the configuration (the ``file`` the
  manifest names);
- ``benchmarks/traffic/<traffic>.json``: the traffic mix, whose ``driver``
  names ``benchmarks/drivers/<driver>.py``;
- ``benchmarks/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares;
- ``benchmarks/metrics/<metric>.py``: one reader per per-layer metric, a
  ``read(run)`` that returns a number, or None where it finds nothing.

A driver module has ``run(ctx)``: it builds the system under test from
``ctx`` (marking each part of set-up with ``ctx.setup_part``), runs the
window through ``ctx.window()``, reads the peak memory with
``ctx.read_peak()``, frees the program's state, and compares its outputs
with the plain reference through ``ctx.compare``.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path


BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dhr_tpu")
# a traced run profiles this many seconds of calls after its window (to the
# end of the call running then), recording device activity alone: enough
# calls or steps for the idle share and the device ops, without reading a
# whole window's millions of events
TRACE_S = 4.0
# and then this many seconds with the host's ops recorded too, which only
# name the idle gaps (recording host ops slows the host)
LABEL_S = 1.5


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


class Cell:
    """One workload of the manifest with its configuration, traffic and
    limits, loaded from their files."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT,
                 bench: Path = BENCH):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(by_name)}")
        self.workload = by_name[name]
        self.name = name
        self.bench = bench
        cfg_entry = {c["name"]: c for c in spec["configs"]}[
            self.workload["config"]]
        self.config = load_json(root / cfg_entry["file"])
        self.traffic = load_json(bench / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{name}.json")
        self.driver = self.traffic["driver"]
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.workload["chips"])


def load_driver(name: str, bench: Path = BENCH):
    return _load_file(bench / "drivers" / f"{name}.py", f"_driver_{name}")


def load_reader(metric: str, bench: Path = BENCH):
    return _load_file(bench / "metrics" / f"{metric}.py",
                      "_metric_" + metric.replace(".", "_"))


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def top_level_modules() -> set[str]:
    return {m.split(".", 1)[0] for m in list(sys.modules)}


def forbidden_loaded() -> list[str]:
    """The forbidden top-level module names this process holds, compared
    whole (``dhr_tpu_torch`` is not ``dhr_tpu``)."""
    return sorted(top_level_modules() & set(FORBIDDEN))


def process_start_perf() -> float:
    """``time.perf_counter()``'s reading at this process's start, from
    ``/proc`` (the interpreter's own start-up counts as set-up)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


# -- spans: CUDA events around calls into a layer -------------------------


class Spans:
    """Per-layer device spans, recorded with CUDA events on the calling
    stream around each call and read after the window (no synchronise in
    between).  On the CPU (tests) the host clock stands in."""

    def __init__(self, torch_mod, device):
        self.torch = torch_mod
        self.cuda = device.type == "cuda"
        self.pending: dict[str, list] = {}
        self.on = False

    def _mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wrap(self, obj, attr: str, name: str) -> None:
        """Record ``name`` around every call of ``obj.attr`` (an instance
        attribute shadows the method, so the program's own calls through
        ``self.attr`` are caught too)."""
        orig = getattr(obj, attr)

        def wrapped(*a, **k):
            if not self.on:
                return orig(*a, **k)
            s = self._mark()
            out = orig(*a, **k)
            self.pending.setdefault(name, []).append((s, self._mark()))
            return out

        setattr(obj, attr, wrapped)

    def hook(self, module, name: str) -> None:
        """Record ``name`` around every forward of ``module``."""
        starts = []

        def pre(_m, _a):
            if self.on:
                starts.append(self._mark())

        def post(_m, _a, _o):
            if self.on and starts:
                self.pending.setdefault(name, []).append(
                    (starts.pop(), self._mark()))

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    def read_ms(self) -> dict[str, list[float]]:
        if self.cuda:
            self.torch.cuda.synchronize()
            return {k: [s.elapsed_time(e) for s, e in v]
                    for k, v in self.pending.items()}
        return {k: [(e - s) * 1e3 for s, e in v]
                for k, v in self.pending.items()}


# -- the device trace -----------------------------------------------------


def device_intervals(events) -> list[tuple[float, float, str]]:
    """The device ops of a profiler's events: ``(start_us, end_us, name)``
    (a host annotation's shadow on the device's timeline is no device
    op)."""
    out = []
    for e in events:
        if "CUDA" in str(e.device_type) \
                and not getattr(e, "is_user_annotation", False) \
                and not e.name.startswith("bench."):
            out.append((e.time_range.start, e.time_range.end, e.name))
    return sorted(out)


def busy_and_ops(dev, t0_us: float = -math.inf, t1_us: float = math.inf,
                 top: int = 10):
    """``(busy_us, ops, gaps)`` of device intervals clipped to ``[t0_us,
    t1_us]``: the length of their union, the ``top`` op names by time
    (``[[name, seconds], ...]``), and the idle gaps between them,
    ``(length_us, start_us, end_us)``, longest first."""
    busy, gaps, by_name = 0.0, [], {}
    cur_s = cur_e = None
    for s, e, name in dev:
        s, e = max(s, t0_us), min(e, t1_us)
        if e <= s:
            continue
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return busy, [[n, t / 1e6] for n, t in ops], gaps


def label_gaps(events, t0_us: float, t1_us: float, top: int = 10):
    """The ``top`` longest idle gaps of the device over ``[t0_us, t1_us]``
    (the edges included), ``[[name, seconds], ...]``, each named by the
    innermost host op running at the gap's middle."""
    dev = device_intervals(events)
    _busy, _ops, gaps = busy_and_ops(dev, t0_us, t1_us, top)
    inside = [(s, e) for s, e, _ in dev if e > t0_us and s < t1_us]
    if inside:
        first = max(min(s for s, _ in inside), t0_us)
        last = min(max(e for _, e in inside), t1_us)
        gaps += [(first - t0_us, t0_us, first), (t1_us - last, last, t1_us)]
    else:
        gaps.append((t1_us - t0_us, t0_us, t1_us))
    gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if "CUDA" not in str(e.device_type)
                  and e.time_range.end > e.time_range.start
                  and not e.name.startswith("bench."))
    labelled = []
    for length, gs, ge in gaps[:top]:
        mid = (gs + ge) / 2
        inner = None
        for s, e, name in host:
            if s > mid:
                break
            if e >= mid and (inner is None or s >= inner[0]):
                inner = (s, name)
        labelled.append([inner[1] if inner else "host: Python between ops",
                         length / 1e6])
    return labelled


def repeat(call):
    """``run_for(seconds)`` that repeats ``call()`` until ``seconds`` have
    passed (to the end of the call running then) and returns the number of
    calls."""
    def run_for(seconds: float) -> int:
        t0, n = time.perf_counter(), 0
        while True:
            call()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                return n
    return run_for


# -- a run ----------------------------------------------------------------


class Ctx:
    """What a driver gets: the cell's files, the seed, the window's length,
    whether to trace, and the hooks that time set-up, run the window and
    record the comparison."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, out=sys.stdout):
        import torch

        self.torch = torch
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        self._t_mark = t_start
        self.setup = {}
        self.spans = Spans(torch, self.device)
        self.counters: dict[str, float] = {}
        self.work: dict = {}
        self.checks: dict[str, dict] = {}
        self.window_s = None
        self.setup_s = None
        self.peak_bytes = None
        self.trace_summary = None
        self.out = out

    # set-up ----------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def setup_part(self, part: str) -> None:
        """Close the set-up part ``part``: the time since the last mark."""
        self.sync()
        now = time.perf_counter()
        self.setup[part] = now - self._t_mark
        self._t_mark = now
        print(f"# setup {part}_s {self.setup[part]!r}", file=self.out,
              flush=True)
        print(f"setup {part}_s {self.setup[part]!r}", file=sys.stderr,
              flush=True)

    # the window --------------------------------------------------------
    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends as it opens and spans record
        inside it.  The body runs its calls until ``ctx.seconds`` have
        passed and finishes on a synchronise; the window's length is the
        whole of it."""
        self.sync()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        self.spans.on = True
        w0 = time.perf_counter()
        try:
            yield w0
            self.sync()
        finally:
            self.window_s = time.perf_counter() - w0
            self.spans.on = False

    def traced(self, run_for) -> None:
        """In a traced run, after the window: the window's calls under the
        profiler, ``run_for(seconds)`` running them for ``seconds`` and
        returning how many it ran.  First ``TRACE_S`` seconds that record
        device activity alone: the busy time, the device ops, and the time
        of a call beside the window's (``work["window_calls"]``), which
        shows what the profiler costs.  Then ``LABEL_S`` seconds that record
        the host's ops too, only to name the longest idle gaps (there the
        host runs slower).  Untraced, nothing runs."""
        if not self.trace:
            return
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            calls = run_for(TRACE_S)
            self.sync()
            window_s = time.perf_counter() - t0
        dev = device_intervals(prof.events())
        busy_us, ops, _ = busy_and_ops(dev)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with self.torch.profiler.record_function("bench.traced"):
                run_for(LABEL_S)
                self.sync()
        events = prof.events()
        win = [e for e in events if e.name == "bench.traced"]
        gaps = label_gaps(events, win[0].time_range.start,
                          win[0].time_range.end) if win else []
        self.trace_summary = {
            "busy_s": busy_us / 1e6, "window_s": window_s,
            "breakdown": {"device_ops": ops, "idle_gaps": gaps}}
        n = self.work.get("window_calls")
        if n and self.window_s:
            print(f"# trace call_s_traced {window_s / calls!r} call_s_window "
                  f"{self.window_s / n!r}", file=self.out, flush=True)

    def read_peak(self) -> None:
        """The peak device memory so far: read once the window has closed
        and before the reference runs."""
        if self.device.type == "cuda":
            self.peak_bytes = int(self.torch.cuda.max_memory_allocated())
        else:
            self.peak_bytes = 0

    # the comparison ------------------------------------------------------
    def compare(self, name: str, value: float) -> None:
        """Record a compared number against its limit in the cell's limits
        file (a number passes at or under its limit)."""
        limit = float(self.cell.limits[name])
        v = float(value)
        self.checks[name] = {"value": v, "limit": limit,
                             "ok": bool(math.isfinite(v) and v <= limit)}

    def free(self) -> None:
        import gc

        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def device_info(torch_mod, ctx: Ctx, count: int) -> dict:
    info = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
            "kind": (torch_mod.cuda.get_device_name(0)
                     if ctx.device.type == "cuda" else "cpu"),
            "count": count, "memory_peak_bytes": ctx.peak_bytes}
    if ctx.trace and ctx.trace_summary is not None:
        info["busy_s"] = ctx.trace_summary["busy_s"]
        info["window_s"] = ctx.trace_summary["window_s"]
    return info


class Run:
    """What a per-layer metric's reader sees."""

    def __init__(self, ctx: Ctx, spans_ms: dict, result: dict):
        self.ctx = ctx
        self.spans = spans_ms
        self.counters = ctx.counters
        self.work = ctx.work
        self.trace = ctx.trace_summary
        self.window_s = ctx.window_s
        self.result = result


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, out=sys.stdout) -> dict:
    """Run ``cell`` once and return its result line (a dict, in the
    manifest's key order)."""
    ctx = Ctx(cell, seed, seconds, trace, device, t_start, out=out)
    res = load_driver(cell.driver, cell.bench).run(ctx)
    spans_ms = ctx.spans.read_ms() if trace else {}
    if trace:
        metrics = {}
        run = Run(ctx, spans_ms, res)
        for m in cell.per_layer:
            v = load_reader(m["name"], cell.bench).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = ctx.setup_s if m["name"] == "setup_s" else res["e2e"].get(
                m["name"])
            if v is None:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = ctx.checks
    correct = bool(checks) and all(c["ok"] for c in checks.values()) \
        and res["failed"] == 0 and res["attempted"] > 0
    line = {"correct": correct, "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": device_info(ctx.torch, ctx, cell.chips)}
    if trace and ctx.trace_summary is not None:
        line["breakdown"] = ctx.trace_summary["breakdown"]
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def finite(x):
    """``x`` with every infinite or NaN number (a check that found no
    answer, a tail of failed requests) put at the largest finite float,
    so that the line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    return x


def print_result(line: dict, out=sys.stdout) -> None:
    line = finite(line)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line, allow_nan=False), file=out, flush=True)


def import_program(name: str):
    """The program's module ``name`` (the port's package sits at the
    checkout's root)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(name)
