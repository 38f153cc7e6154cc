"""Tiny versions of the cells for the CPU tests: the same files, cut in
memory to sizes a test run holds."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = {"num_hidden_layers": 2, "hidden_size": 64,
              "num_attention_heads": 4, "intermediate_size": 128,
              "vocab_size": 570 + 768 * 2, "max_position_embeddings": 128}


def tiny_cell(name: str, f32: bool = False):
    """The cell ``name`` from the repository's files, cut to a CPU size;
    ``f32`` computes the model in f32 (so a sound run's numbers are
    round-off)."""
    from benchmarks import harness
    from benchmarks.tools.sweep_online import with_online_cell

    spec = with_online_cell(harness.manifest())
    cell = harness.Cell(spec, name)
    if cell.driver in ("search_batch", "online_text"):
        cell.config["index"]["rows"] = 30000
        cell.config["search"].update(pool=1000, topk=100, query_batch=64)
        cell.traffic.update(queries=150, checked_queries=6, chunk_rows=8192)
    if cell.driver != "search_batch":
        cell.config["model"].update(TINY_MODEL)
        cell.config["head"].update(projection_dim=16)
    if cell.driver == "online_text":
        cell.config["index"]["cls_dim"] = 16
        cell.traffic.update(rate_per_s=10, checked_requests=4, texts=200,
                            warmup_s=0.5)
        if f32:
            cell.config["serve"]["compute_dtype"] = "float32"
    if cell.driver == "encode_corpus":
        cell.traffic.update(passages_per_call=96, pool_calls=2,
                            checked_per_call=5)
        if f32:
            cell.config["encode"]["compute_dtype"] = "float32"
    if cell.driver == "train_step":
        cell.config["train"].update(batch_size=4, n_passages=4,
                                    learning_rate=1e-3)
        cell.traffic.update(groups=40, n_passages=4)
        if f32:
            cell.config["train"]["compute_dtype"] = "float32"
    return cell


def run_tiny(cell, seed: int = 2**33 + 5, trace: bool = False,
             seconds: float = 1.0) -> dict:
    import time

    import torch

    from benchmarks import harness

    torch.set_num_threads(2)
    return harness.execute(cell, seed, seconds, trace, "cpu",
                           time.perf_counter())
