"""Tokenization and the ``prepare-*`` verbs against dhr_tpu's.

A stub tokenizer (any object with ``encode(...)`` serves) stands in for an
HF one; both CLIs get it in place of ``transformers.AutoTokenizer``, and
their output files must be equal byte for byte.
"""

import csv
import json

import pytest

from dhr_tpu.cli import main as jcli
from dhr_tpu.data import tokenize as jtok
from dhr_tpu_torch.cli import main as tcli
from dhr_tpu_torch.data import tokenize as ttok


class StubTokenizer:
    """Word ids from a fixed vocabulary, hashing unknown words into
    [1000, 1997); honours ``max_length`` / ``truncation``."""

    vocab = {"the": 1996, "a": 1037, "of": 1997, "passage": 6019}

    def encode(self, text, add_special_tokens=True, max_length=None,
               truncation=False):
        ids = [self.vocab.get(w, 1000 + sum(map(ord, w)) % 997)
               for w in text.lower().split()]
        if add_special_tokens:
            ids = [101] + ids + [102]
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return ids


def _write_tsv(path, rows):
    with open(path, "w", newline="") as f:
        csv.writer(f, delimiter="\t").writerows(rows)


@pytest.fixture
def raw(tmp_path):
    words = ("the passage of a river runs through every quiet valley and "
             "town before it meets the sea").split()
    docs = [(str(i), " ".join(words[i % 7: i % 7 + 3 + i % 9]))
            for i in range(30)]
    _write_tsv(tmp_path / "collection.tsv", docs)
    with open(tmp_path / "corpus.jsonl", "w") as f:
        for i, t in docs:
            f.write(json.dumps({"id": i, "title": f"doc {i}", "text": t,
                                "url": f"u{i}"}) + "\n")
    _write_tsv(tmp_path / "queries.tsv",
               [(f"q{i}", " ".join(words[i:i + 4])) for i in range(8)])
    _write_tsv(tmp_path / "qrels.tsv",
               [(f"q{i}", "0", str(i), "1") for i in range(8)]
               + [("q9", "0", "3", "1"), ("q1", "0", "5", "0")])
    _write_tsv(tmp_path / "negatives.tsv",
               [(f"q{i}", str((i * 7 + k) % 30)) for i in range(8)
                for k in range(6)])
    return tmp_path


def _run_both(monkeypatch, argv_fn, out_name, tmp_path):
    for mod in (jcli, tcli):
        monkeypatch.setattr(mod, "_load_tokenizer",
                            lambda path: StubTokenizer())
    outs = []
    for name, mod in (("ref", jcli), ("port", tcli)):
        out = tmp_path / f"{name}_{out_name}"
        args = mod.build_parser().parse_args(argv_fn(str(out)))
        args.fn(args)
        outs.append(out.read_bytes())
    return outs


@pytest.mark.parametrize("source,schema", [
    ("collection.tsv", "msmarco-passage"),
    ("corpus.jsonl", "msmarco-doc"),
    ("corpus.jsonl", "msmarco-passage"),
])
def test_prepare_corpus_files_equal_reference(raw, monkeypatch, source,
                                              schema):
    ref, port = _run_both(monkeypatch, lambda out: [
        "prepare-corpus", "--input", str(raw / source), "--output", out,
        "--tokenizer", "stub", "--max-len", "6", "--schema", schema],
        "corpus.jsonl", raw)
    assert ref == port and ref.count(b"\n") == 30


@pytest.mark.parametrize("n_neg", [200, 3])
def test_prepare_train_files_equal_reference(raw, monkeypatch, n_neg):
    ref, port = _run_both(monkeypatch, lambda out: [
        "prepare-train", "--queries", str(raw / "queries.tsv"), "--qrels",
        str(raw / "qrels.tsv"), "--negatives", str(raw / "negatives.tsv"),
        "--output", out, "--tokenizer", "stub", "--q-max-len", "3",
        "--n-negatives", str(n_neg)], "train.jsonl", raw)
    assert ref == port
    rows = [json.loads(line) for line in port.decode().splitlines()]
    assert len(rows) == 8 and all(len(r["query"]) <= 3 for r in rows)
    assert all(len(r["negative_pids"]) <= n_neg for r in rows)


def test_tokenize_helpers_match_reference():
    tok = StubTokenizer()
    queries = [("q1", "the passage"), ("q2", "a river of stones")]
    assert list(ttok.tokenize_queries(queries, tok, 3)) == \
        list(jtok.tokenize_queries(queries, tok, 3))
    ex = {"query": "the sea", "query_id": "7",
          "positive_passages": [{"title": "t", "text": "a passage"}],
          "negative_passages": ["the valley", {"text": "of town"}]}
    for make in ("make_train_preprocessor", "make_query_preprocessor",
                 "make_corpus_preprocessor"):
        got = getattr(ttok, make)(tok)
        want = getattr(jtok, make)(tok)
        arg = ex if make != "make_corpus_preprocessor" else \
            {"docid": "d", "title": "x", "text": "the passage"}
        assert got(arg) == want(arg)
    groups = dict(queries=dict(queries), qrels={"q1": ["1"], "q2": ["2"]},
                  negatives={"q1": ["1", "3"], "q2": ["2"]})
    corpus = {"1": [5], "2": [6], "3": [7]}
    for as_pids in (True, False):
        assert list(ttok.build_train_groups(
            **groups, tokenizer=tok, as_pids=as_pids,
            corpus_texts=corpus)) == list(jtok.build_train_groups(
                **groups, tokenizer=tok, as_pids=as_pids,
                corpus_texts=corpus))


def test_prepare_verbs_import_transformers_lazily(monkeypatch):
    """The port's CLI reaches ``transformers`` only inside the prepare
    verbs' tokenizer loader."""
    import builtins

    real = builtins.__import__
    seen = []

    def spy(name, *a, **kw):
        if name.startswith("transformers"):
            seen.append(name)
            raise ImportError("no transformers here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", spy)
    with pytest.raises(ImportError, match="no transformers"):
        tcli._load_tokenizer("some/dir")
    assert seen == ["transformers"]
