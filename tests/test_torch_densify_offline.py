"""The port's offline densification against dhr_tpu's.

Same seeded inputs through both packages: term dictionaries, BM25 weights
(bit-equal in Python; the C++ path within f32 rounding, 1e-6 relative),
the analyzer, the four front ends' omissions / dtypes / padded vocabs,
``densify_corpus`` and ``densify_query_rows`` byte for byte (values, folds,
docids, collisions) with both packages' C++ runtimes on and with both off,
the uniCOIL query encoder (f32, the models' bound: 1e-4 relative + 1e-5 of
the largest weight), and the ``densify`` verb's ``.npz`` against
``python -m dhr_tpu densify``'s, loaded by both packages.
"""

import json

import numpy as np
import pytest
import torch

from dhr_tpu import densify_offline as jdo
from dhr_tpu import native as jax_native
from dhr_tpu.cli.main import main as jax_main
from dhr_tpu.densify_offline.query import (
    make_unicoil_query_encoder as jax_unicoil,
)
from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.retrieval import PackedIndex as JaxPackedIndex
from dhr_tpu_torch import densify_offline as tdo
from dhr_tpu_torch import native
from dhr_tpu_torch.cli.main import main
from dhr_tpu_torch.models import BiEncoder, load_flax_params
from dhr_tpu_torch.ops import densify_sparse_rows
from dhr_tpu_torch.retrieval import PackedIndex
from tests.test_torch_models import batch, configs, flax_tree

MODELS = ("bm25", "deepimpact", "unicoil", "splade")
# raw vocabularies: whole-word models a dictionary's size, wordpiece BERT's
RAW_VOCAB = {"bm25": 5000, "deepimpact": 5000, "unicoil": 30522,
             "splade": 30522}


@pytest.fixture(params=["cpp", "python"])
def runtime(request, monkeypatch):
    """Both packages' C++ runtimes on, or both forced off."""
    if request.param == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    assert native.available() == jax_native.available() == (
        request.param == "cpp")
    return request.param


def _docs(rng, n=60, vocab=300):
    """Zipf-ish whole-word documents."""
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [list(rng.choice(words, size=rng.integers(3, 30), p=p))
            for _ in range(n)]


def _dictionaries(docs, reserve):
    out = []
    for mod in (tdo, jdo):
        d = mod.TermDictionary()
        for doc in docs:
            d.add_document(doc)
        d.build(reserve=reserve)
        out.append(d)
    return out


def _sparse_rows(rng, model, n=40):
    """(docid, {str(term id): weight}) rows as the JSONL carries them: ids
    below the omission included (dropped), weights on a 0.25 grid so slices
    see equal maxima (the lowest fold must win)."""
    vocab = RAW_VOCAB[model]
    rows = []
    for i in range(n):
        ids = rng.choice(vocab, size=int(rng.integers(0, 60)), replace=False)
        w = rng.integers(1, 9, len(ids)) / 4
        rows.append((f"d{i}", {str(int(t)): float(x) for t, x in zip(ids, w)}))
    return rows


def test_term_dictionary_matches_reference(rng):
    docs = _docs(rng)
    got, want = _dictionaries(docs, reserve=472)
    assert got._term2id == want._term2id
    assert got.df == want.df
    assert (got.num_docs, got.total_terms, got.vocab_size, got.avg_doc_len) \
        == (want.num_docs, want.total_terms, want.vocab_size,
            want.avg_doc_len)
    assert got.term_id("nope") is None


@pytest.mark.parametrize("k1,b", [(0.9, 0.4), (1.2, 0.75)])
def test_bm25_weights_match_reference(rng, k1, b):
    docs = _docs(rng)
    tdic, jdic = _dictionaries(docs, reserve=0)
    tv = tdo.BM25Vectorizer(tdic, k1=k1, b=b)
    jv = jdo.BM25Vectorizer(jdic, k1=k1, b=b)
    for doc in docs:
        assert tv.doc_vector(doc) == jv.doc_vector(doc)  # bit-equal
    q = docs[0][:4] + ["unseen"]
    assert tv.query_vector(q) == jv.query_vector(q)
    # the C++ pass over mapped ids gives the same weights, in id order
    offsets = np.zeros(len(docs) + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=offsets[1:])
    tokens = np.asarray([tdic.term_id(t) for d in docs for t in d], np.int32)
    tids, ws, off, df = native.bm25_csr(tokens, offsets, tdic.vocab_size,
                                        k1=k1, b=b)
    for i, doc in enumerate(docs):
        vec = tv.doc_vector(doc)
        sl = slice(off[i], off[i + 1])
        assert tids[sl].tolist() == sorted(vec)
        np.testing.assert_allclose(ws[sl], [vec[t] for t in sorted(vec)],
                                   rtol=1e-6)
    assert df.tolist() == [tdic.df[t] for t in sorted(tdic.df)]


def test_query_vectors_match_reference(rng):
    docs = _docs(rng)
    tdic, jdic = _dictionaries(docs, reserve=502)
    queries = [(f"q{i}", " ".join(docs[i][:5]) + " W1, unseen w2!")
               for i in range(6)]
    assert list(tdo.bm25_query_vectors(queries, tdo.BM25Vectorizer(tdic))) \
        == list(jdo.bm25_query_vectors(queries, jdo.BM25Vectorizer(jdic)))
    assert list(tdo.whitespace_tf_query_vectors(queries, tdic.term_id)) == \
        list(jdo.whitespace_tf_query_vectors(queries, jdic.term_id))
    raw = lambda text: {w: float(len(w)) for w in text.split()}  # noqa: E731
    assert list(tdo.encoder_query_vectors(queries, raw, tdic.term_id)) == \
        list(jdo.encoder_query_vectors(queries, raw, jdic.term_id))


def test_simple_analyzer_matches_reference():
    """The port splits with one regex; the reference walks characters with
    str.isalnum.  Unicode letters and digits, underscores, combining marks,
    a lowercase that grows the string (U+0130) and punctuation."""
    pool = list("abcXYZ019 _-.,!?'\t\n") + ["é", "İ", "ß", "Ω", "٣", "²",
                                            "½", "日本", "́", "ǅ"]
    rng = np.random.default_rng(0)
    texts = ["Hello, World! 42x", "", "___", "a_b c-d"]
    texts += ["".join(rng.choice(pool, size=rng.integers(0, 40)))
              for _ in range(300)]
    for t in texts:
        assert tdo.simple_analyzer(t) == jdo.simple_analyzer(t), repr(t)


@pytest.mark.parametrize("model", MODELS)
def test_front_end_table_matches_reference(model):
    t, j = tdo.DensifyConfig(model=model), jdo.DensifyConfig(model=model)
    assert (t.omission, t.index_dtype) == (j.omission, j.index_dtype)
    assert t.index_dtype == (np.int16 if model in ("bm25", "deepimpact")
                             else np.uint8)
    for out_dim in (8, 16, 768):
        t = tdo.DensifyConfig(model=model, out_dim=out_dim)
        j = jdo.DensifyConfig(model=model, out_dim=out_dim)
        for raw in range(t.omission + 1, t.omission + 3 * out_dim, 7):
            assert t.padded_vocab(raw) == j.padded_vocab(raw)
            assert (t.padded_vocab(raw) - t.omission) % out_dim == 0
    # 30522 - 570 = 39 * 768 exactly; whole-word omissions round up to 40
    assert tdo.DensifyConfig(model=model).padded_vocab(30522) == {
        "bm25": 31192, "deepimpact": 31222, "unicoil": 30522,
        "splade": 30522}[model]


def _assert_index_equal(got, want):
    assert got.values.dtype == want.values.dtype == np.float16
    assert got.indices.dtype == want.indices.dtype
    assert got.values.tobytes() == want.values.tobytes()
    assert got.indices.tobytes() == want.indices.tobytes()
    assert list(got.docids) == list(want.docids)
    assert got.lex_dim == want.lex_dim


@pytest.mark.parametrize("model", MODELS)
def test_densify_corpus_matches_reference(rng, runtime, model):
    rows = _sparse_rows(rng, model)
    cfg_t = tdo.DensifyConfig(model=model, out_dim=768)
    cfg_j = jdo.DensifyConfig(model=model, out_dim=768)
    got = tdo.densify_corpus(iter(rows), cfg_t, RAW_VOCAB[model],
                             batch_size=16)
    want = jdo.densify_corpus(iter(rows), cfg_j, RAW_VOCAB[model],
                              batch_size=16)
    _assert_index_equal(got, want)
    assert got.collisions == want.collisions > 0
    assert got.indices.dtype == cfg_t.index_dtype
    qv, qi, qids = tdo.densify_query_rows(iter(rows[:9]), cfg_t,
                                          RAW_VOCAB[model], batch_size=4)
    jqv, jqi, jqids = jdo.densify_query_rows(iter(rows[:9]), cfg_j,
                                             RAW_VOCAB[model], batch_size=4)
    assert qi.dtype == jqi.dtype == np.int16
    assert qv.tobytes() == jqv.tobytes() and qi.tobytes() == jqi.tobytes()
    assert qids == jqids


def test_densify_batch_paths_agree_with_the_row_twin(rng):
    """The C++ batch, the NumPy batch and the per-row twin give the same
    planes, ties to the lowest fold."""
    cfg = tdo.DensifyConfig(model="unicoil", out_dim=8)
    vocab = cfg.padded_vocab(700)
    rows = [{int(t): float(rng.integers(1, 4)) for t in
             rng.choice(np.arange(vocab), size=20, replace=False)}
            for _ in range(12)]
    cpp = tdo.densify_batch(rows, cfg, vocab)
    native_load = native._load
    native._load = lambda: None
    try:
        py = tdo.densify_batch(rows, cfg, vocab)
    finally:
        native._load = native_load
    for a, b in zip(cpp[:2], py[:2]):
        assert a.tobytes() == b.tobytes()
    assert cpp[2] == py[2]
    total = 0
    for i, row in enumerate(rows):
        v, ix, c = densify_sparse_rows(list(row), list(row.values()), 8, 570,
                                       vocab)
        total += c
        assert v.astype(np.float16).tobytes() == cpp[0][i].tobytes()
        assert (ix == cpp[1][i]).all()
    assert total == cpp[2]
    with pytest.raises(ValueError, match="padded_vocab"):
        tdo.densify_batch(rows, cfg, vocab + 1)


def test_densify_empty_streams():
    cfg = tdo.DensifyConfig(model="bm25", out_dim=4)
    index = tdo.densify_corpus(iter([]), cfg, 500)
    assert index.values.shape == (0, 4) and index.collisions == 0
    qv, qi, qids = tdo.densify_query_rows(iter([]), cfg, 500)
    assert qv.shape == qi.shape == (0, 4) and qi.dtype == np.int16
    assert qids == []


class Tok:
    def encode(self, text, add_special_tokens=False, max_length=None,
               truncation=True):
        return [100 + sum(map(ord, w)) % 900 for w in text.split()][
            :max_length]


def test_unicoil_query_encoder_matches_reference():
    torch.set_num_threads(1)
    jcfg, tcfg = configs(dict(model_type="agg", skip_mlm=True, agg_dim=48))
    ids, mask = batch(0)
    tree = flax_tree(jcfg, ids, mask, 0)
    want_enc = jax_unicoil(JaxBiEncoder(jcfg), tree, Tok(), cls_id=1)
    model = load_flax_params(BiEncoder(tcfg), tree)
    got_enc = tdo.make_unicoil_query_encoder(model, Tok(), cls_id=1,
                                             device="cpu")
    texts = ["hello world hello", "dense retrieval on a card", "x", ""]
    for text in texts:
        got, want = got_enc(text), want_enc(text)
        assert sorted(got) == sorted(want) and all(
            isinstance(k, int) and v > 0 for k, v in got.items())
        if want:
            w = np.asarray([want[k] for k in sorted(want)])
            np.testing.assert_allclose([got[k] for k in sorted(want)], w,
                                       rtol=1e-4, atol=1e-5 * np.abs(w).max())
    rows = list(tdo.encoder_query_vectors([("q0", texts[0])], got_enc))
    assert rows[0][0] == "q0" and rows[0][1] == got_enc(texts[0])


def _write_rows(path, rows):
    with open(path, "w") as f:
        for docid, vec in rows:
            f.write(json.dumps({"id": docid, "vector": vec}) + "\n")


@pytest.mark.parametrize("model", MODELS)
def test_densify_verb_matches_reference(tmp_path, rng, runtime, model):
    rows = _sparse_rows(rng, model, n=25)
    src = tmp_path / "vectors.jsonl"
    _write_rows(src, rows)
    outs = {}
    for name, cli in (("port", main), ("ref", jax_main)):
        out = str(tmp_path / f"{name}.npz")
        cli(["densify", "--input", str(src), "--output", out,
             "--weight-model", model, "--vocab-size", str(RAW_VOCAB[model]),
             "--batch-size", "8"])
        outs[name] = out
    with np.load(outs["port"], allow_pickle=False) as a, \
            np.load(outs["ref"], allow_pickle=False) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    port = PackedIndex.load(outs["port"])
    _assert_index_equal(port, JaxPackedIndex.load(outs["port"]))
    _assert_index_equal(port, PackedIndex.load(outs["ref"]))
    want = jdo.densify_corpus(iter(rows), jdo.DensifyConfig(model=model),
                              RAW_VOCAB[model])
    _assert_index_equal(port, want)
