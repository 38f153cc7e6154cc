"""The port's C++ host runtime against dhr_tpu's and against its own
pure-Python fallbacks.

Each of the five entry points runs three ways on the same seeded inputs:
the port's library, ``dhr_tpu``'s library, and the port's fallback (the
library forced off).  Integer outputs must be equal; BM25 weights of the
fallback (NumPy in f64, rounded to f32) within 1e-6 relative of the C++
path's (f64 too, rounded to f32).
"""

import json
import os

import numpy as np
import pytest

from dhr_tpu import native as jax_native
from dhr_tpu_torch import encode as tencode
from dhr_tpu_torch import native
from dhr_tpu_torch.data import examples


@pytest.fixture
def fallback(monkeypatch):
    """The port's runtime forced onto its Python fallbacks."""
    monkeypatch.setattr(native, "_load", lambda: None)


def _corpus_file(path, rng, n=40):
    rows = [{"text_id": f"doc{i}" if i % 3 else i,
             "text": rng.integers(0, 30000, rng.integers(0, 30)).tolist()}
            for i in range(n)]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return rows


def _csr(rng, n_docs, vocab, max_len=12):
    docs = [rng.integers(0, vocab, rng.integers(0, max_len)).tolist()
            for _ in range(n_docs)]
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=offsets[1:])
    tokens = np.asarray([t for d in docs for t in d], np.int32)
    return tokens, offsets


def test_builds_under_its_own_library_name():
    assert native.available()
    assert os.path.basename(native.so_path()) == "libdhr_torch_native.so"
    assert jax_native.available()
    assert native.so_path() != jax_native._SO
    # the two packages' libraries are separate objects in the process
    assert native._load() is not jax_native._load()


def test_so_path_prefers_the_checkout_build_dir(monkeypatch):
    parent = os.path.dirname(native._PKG)
    assert native._so_path() == os.path.join(parent, "build",
                                             "libdhr_torch_native.so")
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    cached = native._so_path()
    assert cached.endswith(os.path.join(".cache", "dhr_tpu_torch",
                                        "libdhr_torch_native.so"))


def test_fallback_reports_unavailable(fallback):
    assert not native.available()
    assert native.so_path() is None
    assert native.plan_packing_native([3, 4], 8, 2) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_load_tokenized_corpus_three_ways(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(seed)
    p = tmp_path / "c.jsonl"
    rows = _corpus_file(p, rng)
    got = native.load_tokenized_corpus_native(str(p))
    want = jax_native.load_tokenized_corpus_native(str(p))
    assert got[0] == want[0] == [str(r["text_id"]) for r in rows]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with monkeypatch.context() as m:
        m.setattr(native, "_load", lambda: None)
        py = native.load_tokenized_corpus_native(str(p))
    assert py[0] == got[0]
    np.testing.assert_array_equal(py[1], got[1])
    np.testing.assert_array_equal(py[2], got[2])


def test_load_tokenized_corpus_native_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.load_tokenized_corpus_native(str(tmp_path / "missing.jsonl"))


@pytest.mark.parametrize("seed,n_docs,vocab", [(0, 12, 30), (1, 60, 500),
                                               (2, 1, 5)])
def test_bm25_csr_three_ways(monkeypatch, seed, n_docs, vocab):
    rng = np.random.default_rng(seed)
    tokens, offsets = _csr(rng, n_docs, vocab)
    tokens[::7] = vocab + 3  # out-of-vocabulary ids are skipped
    got = native.bm25_csr(tokens, offsets, vocab)
    want = jax_native.bm25_csr(tokens, offsets, vocab)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with monkeypatch.context() as m:
        m.setattr(native, "_load", lambda: None)
        py = native.bm25_csr(tokens, offsets, vocab)
    for i in (0, 2, 3):
        np.testing.assert_array_equal(py[i], got[i])
    np.testing.assert_allclose(py[1], got[1], rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_densify_csr_three_ways(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    vocab, out_dim, omission = 38, 8, 6
    rows = []
    for _ in range(10):
        ids = np.sort(rng.choice(np.arange(vocab), 12, replace=False))
        w = (rng.integers(1, 4, 12) / 2).astype(np.float32)  # built ties
        rows.append((ids, w))
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r[0]) for r in rows], out=offsets[1:])
    tids = np.concatenate([r[0] for r in rows]).astype(np.int32)
    ws = np.concatenate([r[1] for r in rows])
    got = native.densify_csr(tids, ws, offsets, omission, out_dim, vocab)
    want = jax_native.densify_csr(tids, ws, offsets, omission, out_dim, vocab)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    with monkeypatch.context() as m:
        m.setattr(native, "_load", lambda: None)
        py = native.densify_csr(tids, ws, offsets, omission, out_dim, vocab)
    np.testing.assert_array_equal(py[0], got[0])
    np.testing.assert_array_equal(py[1], got[1])  # lowest fold on ties
    assert py[2] == got[2]


@pytest.mark.parametrize("S,B,K,k_out", [(3, 2, 4, 5), (1, 3, 6, 6),
                                         (4, 1, 2, 12)])
def test_merge_topk_shards_three_ways(monkeypatch, S, B, K, k_out):
    rng = np.random.default_rng(S * 100 + K)
    scores = rng.integers(0, 4, (S, B, K)).astype(np.float32)  # ties
    ids = rng.permutation(S * B * K).reshape(S, B, K).astype(np.int64)
    got = native.merge_topk_shards(scores, ids, k_out)
    want = jax_native.merge_topk_shards(scores, ids, k_out)
    with monkeypatch.context() as m:
        m.setattr(native, "_load", lambda: None)
        py = native.merge_topk_shards(scores, ids, k_out)
    for g, w, p in zip(got, want, py):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


PACKING_CASES = {
    "mixed": (np.random.default_rng(0).integers(1, 90, 500).tolist(), 64, 4),
    "one_length": ([70] * 17, 64, 4),
    "all_oversize": ([100, 100, 100], 64, 4),
    "empty": ([], 64, 4),
    "segment_cap": (np.random.default_rng(1).integers(1, 12, 64).tolist(),
                    64, 4),
    "zeros": ([0, 0, 5, 0], 8, 8),
}


@pytest.mark.parametrize("case", sorted(PACKING_CASES))
def test_plan_packing_three_ways(monkeypatch, case):
    lengths, row_len, segs = PACKING_CASES[case]
    items, offsets = native.plan_packing_native(lengths, row_len, segs)
    j_items, j_offsets = jax_native.plan_packing_native(lengths, row_len,
                                                        segs)
    np.testing.assert_array_equal(items, j_items)
    np.testing.assert_array_equal(offsets, j_offsets)
    got = tencode.plan_packing(lengths, row_len, segs)
    with monkeypatch.context() as m:
        m.setattr(native, "_load", lambda: None)
        want = tencode.plan_packing(lengths, row_len, segs)
    assert got == want
    assert all(type(i) is int for row in got for i in row)
    assert got == [items[offsets[r]:offsets[r + 1]].tolist()
                   for r in range(len(offsets) - 1)]


def test_load_tokenized_corpus_equals_the_python_reader(tmp_path, rng):
    """The port's reader with the runtime on returns what its json reader
    returns, over a glob of two files and over their directory."""
    d = tmp_path / "corpus"
    d.mkdir()
    _corpus_file(d / "a.jsonl", rng, 30)
    _corpus_file(d / "b.jsonl", rng, 25)
    for path in (str(d / "*.jsonl"), str(d)):
        assert native.available()
        got = examples.load_tokenized_corpus(path)
        want = examples.read_tokenized_corpus(path)
        assert got == want
        assert len(got[0]) == 55 and [0] in got[1]  # empty text -> [0]
