"""Spawn the gloo ranks of tests/torch_parallel_worker.py and collect their
results (one group per call).

Each rank writes its stdout and stderr to a log file under ``tmp`` (no
pipe for the parent to drain).  Every spawn has a time limit, so a hung
collective fails the test instead of hanging the worker; a rank that exits
non-zero stops the others at once.  Either failure puts every rank's log
tail (the worker logs each scenario's start and end with a timestamp) in
the assertion."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")


def log_tails(paths, chars: int = 4000) -> str:
    """The last ``chars`` characters of each rank's log, rank by rank."""
    parts = []
    for r, path in enumerate(paths):
        try:
            with open(path, errors="replace") as f:
                text = f.read()
        except OSError as e:
            text = f"<no log: {e}>"
        parts.append(f"--- rank {r} ({path}):\n{text[-chars:]}")
    return "\n".join(parts)


def wait_all(procs, logs, timeout: float, what: str) -> float:
    """Wait for every process; returns the wall seconds.  Raises, with
    every log's tail, when one exits non-zero (the rest are killed: their
    collectives would wait for it until the limit) or when ``timeout``
    seconds pass first."""
    t0 = time.monotonic()
    failed = None
    while True:
        codes = [p.poll() for p in procs]
        if any(c for c in codes if c is not None):
            failed = "exited " + ", ".join(
                f"rank {r}: {'running' if c is None else c}"
                for r, c in enumerate(codes))
            break
        if all(c is not None for c in codes):
            break
        if time.monotonic() - t0 > timeout:
            failed = (f"passed its {timeout:.0f} s limit (" + ", ".join(
                f"rank {r}: {'running' if c is None else 'exited ' + str(c)}"
                for r, c in enumerate(codes)) + ")")
            break
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    wall = time.monotonic() - t0
    if failed:
        raise AssertionError(f"{what} {failed} after {wall:.1f} s\n"
                             f"{log_tails(logs)}")
    return wall


def run_ranks(task: str, world: int, inp, tmp, timeout: float = 300,
              extra_env: dict | None = None) -> list:
    """Run ``task`` on ``world`` CPU ranks; returns each rank's result.
    ``timeout`` bounds the whole group's wall."""
    tmp = str(tmp)
    tag = f"{task}_{world}_{os.getpid()}"
    inp_path = os.path.join(tmp, f"{tag}.in.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    init = "file://" + os.path.join(tmp, f"{tag}.rdzv")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "GROUP_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT, **(extra_env or {}))
    outs = [os.path.join(tmp, f"{tag}.out{r}.pkl") for r in range(world)]
    logs = [os.path.join(tmp, f"{tag}.rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, WORKER, task, str(world), str(r), init,
                     inp_path, outs[r]], cwd=ROOT, env=env,
                    stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT))
        wait_all(procs, logs, timeout, f"{task} on {world} ranks")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results
