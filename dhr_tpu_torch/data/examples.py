"""Readers and a writer for the pipeline's interchange JSONL files.

Port of the encode path's part of ``dhr_tpu/data/examples.py``.  A
tokenized corpus or query file holds one ``{"text_id": id, "text":
[vocab ids]}`` row per line, ids without special tokens.  The reader is
the Python one (the reference's C++ host parser is not ported yet).
"""

from __future__ import annotations

import glob
import json
import os
from collections.abc import Iterable, Iterator


def _expand(path: str) -> list[str]:
    if os.path.isdir(path):
        return sorted(
            p for p in glob.glob(os.path.join(path, "*"))
            if p.endswith((".json", ".jsonl"))
        )
    matches = sorted(glob.glob(path))
    return matches if matches else [path]


def read_jsonl(path: str) -> Iterator[dict]:
    """Rows of a JSONL file, a glob of them, or a directory of them."""
    for p in _expand(path):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)


def load_tokenized_corpus(path: str) -> tuple[list[str], list[list[int]]]:
    """``{"text_id", "text"}`` rows -> (ids, token lists); an empty text
    becomes ``[0]``."""
    ids, texts = [], []
    for row in read_jsonl(path):
        ids.append(str(row["text_id"]))
        texts.append(row["text"] if row["text"] else [0])
    return ids, texts


def write_jsonl(path: str, rows: Iterable[dict]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
