"""Offline tokenization + MS MARCO TSV preprocessing.

Port of ``dhr_tpu/data/tokenize.py``.  Produces the pipeline's
tokenized-JSONL interchange files:

- corpus/query tokenizers (reference utils/tokenize_corpus.py:14-96,
  tokenize_query.py:12-34): text -> ``{"text_id", "text": [ids]}`` with
  per-dataset field schemas and multiprocessing over file shards;
- MS MARCO official-TSV converters (reference preprocessor/
  preprocessor_tsv.py:9-105): qrels+queries+collection -> train groups,
  collection.tsv -> corpus JSONL.

Any object with ``encode(text, add_special_tokens=False, max_length=...,
truncation=True)`` works as the tokenizer (HF tokenizers qualify); nothing
here imports transformers.
"""

from __future__ import annotations

import csv
import json
import os
from collections.abc import Iterable, Iterator

# field schemas per dataset family (reference tokenize_corpus.py:11-12)
DATA_SCHEMAS = {
    "msmarco-passage": {"id": "id", "content": ["text"]},
    "msmarco-doc": {"id": "id", "content": ["title", "url", "text"]},
    "beir": {"id": "_id", "content": ["title", "text"]},
}


def _content_of(row: dict, schema: dict) -> str:
    parts = [str(row.get(f, "") or "") for f in schema["content"]]
    return " ".join(p for p in parts if p)


def tokenize_corpus_file(
    in_path: str, out_path: str, tokenizer, max_len: int = 512,
    schema: str | dict = "msmarco-passage",
) -> int:
    """Tokenize one corpus JSONL/TSV file -> ``{"text_id", "text"}`` JSONL."""
    if isinstance(schema, str):
        schema = DATA_SCHEMAS[schema]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    n = 0
    with open(out_path, "w") as out:
        for row in _iter_rows(in_path):
            ids = tokenizer.encode(
                _content_of(row, schema), add_special_tokens=False,
                max_length=max_len, truncation=True,
            )
            out.write(json.dumps(
                {"text_id": row[schema["id"]], "text": ids}
            ) + "\n")
            n += 1
    return n


def tokenize_queries(
    queries: Iterable[tuple[str, str]], tokenizer, max_len: int = 64,
) -> Iterator[dict]:
    for qid, text in queries:
        ids = tokenizer.encode(
            text, add_special_tokens=False, max_length=max_len, truncation=True
        )
        yield {"text_id": qid, "text": ids}


def _iter_rows(path: str) -> Iterator[dict]:
    if path.endswith((".tsv", ".txt")):
        with open(path, newline="") as f:
            for parts in csv.reader(f, delimiter="\t"):
                if len(parts) == 2:
                    yield {"id": parts[0], "text": parts[1]}
                elif len(parts) >= 4:  # msmarco-doc: id, url, title, body
                    yield {
                        "id": parts[0], "url": parts[1],
                        "title": parts[2], "text": parts[3],
                    }
                elif parts:
                    yield {"id": parts[0], "text": " ".join(parts[1:])}
    else:
        with open(path) as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)


# --------------------------------------------------------------------------
# MS MARCO official TSV -> train/corpus JSONL (reference preprocessor_tsv.py)
# --------------------------------------------------------------------------


def read_queries_tsv(path: str) -> dict[str, str]:
    out = {}
    with open(path, newline="") as f:
        for qid, text in csv.reader(f, delimiter="\t"):
            out[qid] = text
    return out


def read_qrels_tsv(path: str) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    with open(path, newline="") as f:
        for parts in csv.reader(f, delimiter="\t"):
            if len(parts) == 4:
                qid, _, pid, rel = parts
                if int(rel) > 0:
                    out.setdefault(qid, []).append(pid)
            elif len(parts) == 2:
                out.setdefault(parts[0], []).append(parts[1])
    return out


def read_negatives_tsv(path: str) -> dict[str, list[str]]:
    """qid\\tpid ranking file -> negatives per query (top-ranked first)."""
    out: dict[str, list[str]] = {}
    with open(path, newline="") as f:
        for parts in csv.reader(f, delimiter="\t"):
            out.setdefault(parts[0], []).append(parts[1])
    return out


def build_train_groups(
    queries: dict[str, str],
    qrels: dict[str, list[str]],
    negatives: dict[str, list[str]],
    tokenizer,
    q_max_len: int = 32,
    n_negatives: int = 200,
    as_pids: bool = True,
    corpus_texts: dict[str, list[int]] | None = None,
) -> Iterator[dict]:
    """Emit train-group JSONL rows, pid-based or with inline token ids."""
    for qid, pos_pids in qrels.items():
        if qid not in queries:
            continue
        q_ids = tokenizer.encode(
            queries[qid], add_special_tokens=False,
            max_length=q_max_len, truncation=True,
        )
        negs = [p for p in negatives.get(qid, []) if p not in set(pos_pids)]
        negs = negs[:n_negatives]
        if not negs:
            continue
        if as_pids:
            yield {
                "query": q_ids,
                "positive_pids": pos_pids,
                "negative_pids": negs,
            }
        else:
            yield {
                "query": q_ids,
                "positives": [corpus_texts[p] for p in pos_pids],
                "negatives": [corpus_texts[p] for p in negs],
            }


# --------------------------------------------------------------------------
# row preprocessors for raw-text datasets (reference datasets/preprocessor.py
# + the PROCESSOR_INFO registry in datasets/__init__.py) — convert hub-format
# rows (Tevatron self-contained: query + positive_passages/negative_passages
# with optional titles) into the tokenized interchange schemas.
# --------------------------------------------------------------------------


def _passage_text(p: dict, separator: str = " ") -> str:
    if isinstance(p, str):
        return p
    title = p.get("title")
    return f"{title}{separator}{p['text']}" if title else p["text"]


def make_train_preprocessor(tokenizer, q_max_len: int = 32,
                            p_max_len: int = 256, separator: str = " "):
    """Row {'query', 'positive_passages', 'negative_passages'} -> train group."""

    def enc(text, max_len):
        return tokenizer.encode(text, add_special_tokens=False,
                                max_length=max_len, truncation=True)

    def process(example: dict) -> dict:
        return {
            "query": enc(example["query"], q_max_len),
            "positives": [
                enc(_passage_text(p, separator), p_max_len)
                for p in example["positive_passages"]
            ],
            "negatives": [
                enc(_passage_text(p, separator), p_max_len)
                for p in example["negative_passages"]
            ],
        }

    return process


def make_query_preprocessor(tokenizer, q_max_len: int = 32):
    def process(example: dict) -> dict:
        return {
            "text_id": example.get("query_id", example.get("text_id")),
            "text": tokenizer.encode(
                example["query"], add_special_tokens=False,
                max_length=q_max_len, truncation=True,
            ),
        }

    return process


def make_corpus_preprocessor(tokenizer, p_max_len: int = 256,
                             separator: str = " "):
    def process(example: dict) -> dict:
        return {
            "text_id": example.get("docid", example.get("text_id")),
            "text": tokenizer.encode(
                _passage_text(example, separator), add_special_tokens=False,
                max_length=p_max_len, truncation=True,
            ),
        }

    return process
