"""Format converters and small readers (host only).

Port of ``dhr_tpu/utils/convert.py``.  Parity targets: retrieval/format/
convert_result_to_trec.py (3-column ranking -> TREC 6-column),
tevatron/utils/data_reader.py (tsv / qrel readers) and
tevatron/utils/convert_from_dpr.py (a DPR bi-encoder checkpoint -> the
untied query_model/ + passage_model/ layout).
"""

from __future__ import annotations

import csv
import json
import os
from collections import defaultdict

import torch


def convert_ranking_to_trec(in_path: str, out_path: str,
                            run_name: str = "dhr_tpu") -> None:
    """``qid\\tdocid\\tscore`` rows -> a ranked TREC run (score
    descending, then docid)."""
    per_q: dict[str, list[tuple[str, float]]] = defaultdict(list)
    with open(in_path, newline="") as f:
        for parts in csv.reader(f, delimiter="\t"):
            if len(parts) >= 3:
                per_q[parts[0]].append((parts[1], float(parts[2])))
    with open(out_path, "w") as out:
        for qid, rows in per_q.items():
            rows.sort(key=lambda x: (-x[1], x[0]))
            for rank, (docid, score) in enumerate(rows, start=1):
                out.write(f"{qid} Q0 {docid} {rank} {score} {run_name}\n")


def read_tsv_pairs(path: str) -> dict[str, str]:
    """``id\\ttext`` rows -> dict."""
    out = {}
    with open(path, newline="") as f:
        for parts in csv.reader(f, delimiter="\t"):
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def read_qrel_tsv(path: str) -> dict[str, dict[str, int]]:
    """``qid\\t0\\tdocid\\trel`` rows -> ``{qid: {docid: rel}}``."""
    out: dict[str, dict[str, int]] = defaultdict(dict)
    with open(path, newline="") as f:
        for parts in csv.reader(f, delimiter="\t"):
            if len(parts) == 4:
                out[parts[0]][parts[2]] = int(parts[3])
    return dict(out)


def convert_dpr_checkpoint(dpr_ckpt_path: str, out_dir: str,
                           hf_config: dict | None = None) -> None:
    """Split a DPR bi-encoder torch checkpoint into the untied layout
    (``query_model/`` + ``passage_model/``, each a ``pytorch_model.bin``
    and, given ``hf_config``, a ``config.json``).

    DPR state dicts prefix the two towers ``question_model.`` /
    ``ctx_model.``, under ``model_dict`` when present (reference
    utils/convert_from_dpr.py).
    """
    state = torch.load(dpr_ckpt_path, map_location="cpu")
    model_dict = state.get("model_dict", state)
    towers = {"query_model": "question_model.", "passage_model": "ctx_model."}
    for sub, prefix in towers.items():
        tower = {k[len(prefix):]: v for k, v in model_dict.items()
                 if k.startswith(prefix)}
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        torch.save(tower, os.path.join(d, "pytorch_model.bin"))
        if hf_config is not None:
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(hf_config, f)
