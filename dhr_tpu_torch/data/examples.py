"""Readers and a writer for the pipeline's interchange JSONL files.

Port of ``dhr_tpu/data/examples.py`` (not ported: the loader of HF-hub
datasets).  The formats:

- tokenized corpus / queries: ``{"text_id": id, "text": [vocab ids]}``,
  ids without special tokens;
- train groups: ``{"query": [...], "positives": [...], "negatives": [...]}``
  or the pid form ``positive_pids`` / ``negative_pids`` (+ ``bin_pairs``
  for margin-KD) resolved against a :class:`Corpus`;
- sparse vectors: ``{"id": docid, "vector": {token: weight}}``.

The reader is the Python one (the reference's C++ host parser is not
ported yet).
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


def load_train_groups(path: str) -> list[dict]:
    return list(read_jsonl(path))


def load_sparse_vectors(path: str) -> Iterator[tuple[str, dict]]:
    for row in read_jsonl(path):
        yield str(row["id"]), row["vector"]


def write_jsonl(path: str, rows: Iterable[dict]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


class Corpus:
    """Random-access pid -> token-id list.  Pids index positionally when
    they are integers in range, else through a docid map."""

    def __init__(self, ids: list[str], texts: list[list[int]]):
        self.ids = ids
        self.texts = texts
        self._by_id: dict[str, int] | None = None

    @staticmethod
    def load(path: str) -> "Corpus":
        return Corpus(*load_tokenized_corpus(path))

    def __len__(self) -> int:
        return len(self.ids)

    def text_by_pid(self, pid) -> list[int]:
        try:
            return self.texts[int(pid)]
        except (ValueError, IndexError):
            if self._by_id is None:
                self._by_id = {d: i for i, d in enumerate(self.ids)}
            return self.texts[self._by_id[str(pid)]]
