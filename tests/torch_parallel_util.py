"""Spawn the gloo ranks of tests/torch_parallel_worker.py and collect their
results (one group per call; every spawn has a timeout, so a hung
collective fails the test instead of hanging the worker)."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")


def run_ranks(task: str, world: int, inp, tmp, timeout: float = 300,
              extra_env: dict | None = None) -> list:
    """Run ``task`` on ``world`` CPU ranks; returns each rank's result."""
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
    procs = [subprocess.Popen(
        [sys.executable, WORKER, task, str(world), str(r), init, inp_path,
         outs[r]], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode:
                errs.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{task} on {world} ranks passed {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if errs:
        raise AssertionError("\n".join(errs))
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results
