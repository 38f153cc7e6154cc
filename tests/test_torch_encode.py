"""The port's encode path against dhr_tpu's: collation, bucketing, the
``Encoder`` and the ``encode`` verb, and the full-width planes.

The ``Encoder`` cases load one perturbed Flax tree into both packages; the
verb cases load one HF checkpoint written by ``dhr_tpu``'s export into both
CLIs.  f16 values agree within one f16 ulp plus the models' f32 bound (f32
rounding of a different summation order can cross a rounding boundary;
see ``assert_f16_within_one_ulp``), uint8 folds exactly except
where the two largest folds of a slice lie within 1e-6 of each other.
Searching the port's encoded shards with ``dhr_tpu`` gives the run that
searching the reference's shards gives (the on-disk ground rule).
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhr_tpu.cli.main import main as jax_main
from dhr_tpu.data import collate as jax_collate
from dhr_tpu.data import examples as jax_examples
from dhr_tpu.encode import EncodeConfig as JaxEncodeConfig
from dhr_tpu.encode import Encoder as JaxEncoder
from dhr_tpu.encode import bucketed_encode_batches as jax_bucketed
from dhr_tpu.encode import iter_batches as jax_iter_batches
from dhr_tpu.encode import plan_length_buckets as jax_plan
from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.train.checkpoint import export_hf_checkpoint
from dhr_tpu_torch.cli.main import main
from dhr_tpu_torch.data import collate, examples
from dhr_tpu_torch.encode import (
    EncodeConfig,
    Encoder,
    bucketed_encode_batches,
    iter_batches,
    make_query_encoder,
    plan_length_buckets,
)
from dhr_tpu_torch.models import (
    BiEncoder,
    EncoderConfig,
    RetrieverConfig,
    load_flax_params,
    random_flax_params,
)
from dhr_tpu_torch.models.hf_io import load_hf_state_dict
from dhr_tpu_torch.retrieval import PackedIndex
from tests.test_torch_hf_io import load_port_from_dir
from tests.test_torch_models import CASES, OUT, REMOVE, V, configs, flax_tree

N_DOCS, N_QUERIES = 37, 9


def assert_f16_within_one_ulp(got, want):
    """One f16 ulp, on top of the f32 bound of the models' parity
    (1e-5 of the largest magnitude): an entry far below the largest, e.g.
    2e-4 in a CLS vector of scale 3, carries that f32 error, which is more
    than its own ulp."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
    g, w = got.astype(np.float32), want.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))).astype(np.float32)
    f32_bound = 1e-5 * np.abs(w).max()
    assert (np.abs(g - w) <= ulp + f32_bound).all()


def near_ties(lexical, out_dim=OUT, remove=REMOVE, rel=1e-6):
    """(rows, out_dim) True where a slice's top two folds lie within
    ``rel`` of each other."""
    x = np.asarray(lexical, np.float32)[:, remove:]
    top2 = np.sort(x.reshape(x.shape[0], -1, out_dim), axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] <= rel * np.maximum(np.abs(top2[:, 1]),
                                                       1e-30)


def assert_folds_equal(got, want, lexical):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.uint8
    assert not ((got != want) & ~near_ties(lexical)).any()


def token_lists(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(REMOVE, V, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


# ------------------------------------------------------------ collation --


def test_collation_matches_reference():
    toks = token_lists(0, 6, 0, 30) + [[]]
    for max_len in (8, 24):
        for cls_id, sep_id in ((1, 2), (None, 2), (1, None), (None, None)):
            for t in toks:
                assert collate.wrap_specials(t, max_len, cls_id, sep_id) == \
                    jax_collate.wrap_specials(t, max_len, cls_id, sep_id)
            got = collate.pad_token_batch(toks, max_len, 0, cls_id, sep_id)
            want = jax_collate.pad_token_batch(toks, max_len, 0, cls_id,
                                               sep_id)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    got = collate.collate_encode(list("abcdefg"), toks, 30)
    want = jax_collate.collate_encode(list("abcdefg"), toks, 30)
    assert got["ids"] == want["ids"]
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])


def test_jsonl_readers_match_reference(tmp_path):
    rows = [{"text_id": i, "text": t}
            for i, t in enumerate(token_lists(1, 5, 0, 9))]
    path = str(tmp_path / "sub" / "corpus.jsonl")
    examples.write_jsonl(path, rows)
    assert list(examples.read_jsonl(path)) == rows
    (tmp_path / "sub" / "more.json").write_text(
        json.dumps({"text_id": "x", "text": [5]}) + "\n\n")
    for p in (path, str(tmp_path / "sub"), str(tmp_path / "sub" / "*")):
        assert examples.load_tokenized_corpus(p) == \
            jax_examples.load_tokenized_corpus(p)
    ids, texts = examples.load_tokenized_corpus(path)
    assert ids == [str(i) for i in range(5)] and all(texts)


def test_length_bucket_plans_match_reference():
    toks = token_lists(2, 50, 0, 140)
    lengths = [len(t) + 2 for t in toks]
    for bs, max_len in ((8, 128), (16, 32), (3, 512)):
        got_plan, got_order = plan_length_buckets(lengths, bs, max_len)
        want_plan, want_order = jax_plan(lengths, bs, max_len)
        np.testing.assert_array_equal(got_order, want_order)
        assert [(list(s), b) for s, b in got_plan] == \
            [(list(s), b) for s, b in want_plan]
    ids = [f"d{i}" for i in range(50)]
    got, got_order = bucketed_encode_batches(ids, toks, 8, 128, 1, 2)
    want, want_order = jax_bucketed(ids, toks, 8, 128, 1, 2)
    np.testing.assert_array_equal(got_order, want_order)
    for g, w in zip(got, want, strict=True):
        assert g["ids"] == w["ids"]
        np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
        np.testing.assert_array_equal(g["attention_mask"],
                                      w["attention_mask"])
    arrays = np.arange(20).reshape(10, 2), np.ones((10, 2))
    for g, w in zip(iter_batches(ids[:10], *arrays, 4),
                    jax_iter_batches(ids[:10], *arrays, 4), strict=True):
        assert g["ids"] == w["ids"]


# -------------------------------------------------------------- Encoder --


def encode_batches(seed, n, max_len, bs):
    toks = token_lists(seed, n, 1, max_len)
    ids = [f"x{seed}-{i}" for i in range(n)]
    return [collate.collate_encode(
        ids[s:s + bs],
        [collate.wrap_specials(t, max_len, 1, 2) for t in toks[s:s + bs]],
        max_len) for s in range(0, n, bs)]


@pytest.mark.parametrize("case", ["dhr_pooler", "dlr_pooler", "agg_full",
                                  "agg_semi", "agg_skip_mlm",
                                  "dense_mean_pooler", "dense_cls_pooler"])
def test_encoder_matches_reference(case):
    """Corpus and query planes of 21 items in batches of 8 (a ragged last
    batch), the reference padding it and the port not."""
    kw = CASES[case]
    jcfg, tcfg = configs(kw)
    batches = encode_batches(11, 21, 16, 8)
    tree = flax_tree(jcfg, batches[0]["input_ids"],
                     batches[0]["attention_mask"], 11)
    jenc = JaxEncoder(JaxBiEncoder(jcfg), tree, jcfg,
                      JaxEncodeConfig(batch_size=8, remove_dims=REMOVE))
    tenc = Encoder(load_flax_params(BiEncoder(tcfg), tree), tcfg,
                   EncodeConfig(batch_size=8, remove_dims=REMOVE),
                   device="cpu")
    want = jenc.encode_corpus(batches)
    got = tenc.encode_corpus(batches)
    assert isinstance(got, PackedIndex)
    assert got.lex_dim == want.lex_dim and list(got.docids) == list(
        want.docids)
    assert_f16_within_one_ulp(got.values, want.values)
    qv, qi, qids = tenc.encode_queries(batches)
    wqv, wqi, wqids = jenc.encode_queries(batches)
    assert qids == wqids
    assert_f16_within_one_ulp(qv, wqv)
    if want.indices is None:
        assert got.indices is None and qi is None
        return
    jb = [{"input_ids": jnp.asarray(b["input_ids"]),
           "attention_mask": jnp.asarray(b["attention_mask"])}
          for b in batches]
    lex = np.concatenate([np.asarray(JaxBiEncoder(jcfg).apply(
        {"params": tree}, passage=b)[1].lexical) for b in jb])
    assert_folds_equal(got.indices, want.indices, lex)
    assert_folds_equal(qi, wqi, lex)


def test_encoder_colbert_tokens_match_reference():
    jcfg, tcfg = configs(CASES["colbert"])
    batches = encode_batches(12, 10, 12, 4)
    tree = flax_tree(jcfg, batches[0]["input_ids"],
                     batches[0]["attention_mask"], 12)
    jenc = JaxEncoder(JaxBiEncoder(jcfg), tree, jcfg,
                      JaxEncodeConfig(batch_size=4))
    tenc = Encoder(load_flax_params(BiEncoder(tcfg), tree), tcfg,
                   EncodeConfig(batch_size=4), device="cpu")
    for role in ("query", "passage"):
        got, gids = tenc.encode_tokens(batches, role)
        want, wids = jenc.encode_tokens(batches, role)
        assert gids == wids and got.shape == (10, 12, 16)
        assert_f16_within_one_ulp(got, want)
    with pytest.raises(ValueError, match="encode_tokens"):
        tenc.encode_corpus(batches)


def test_encoder_rejects_out_of_vocabulary_ids():
    _, tcfg = configs(CASES["dhr_pooler"])
    enc = Encoder(BiEncoder(tcfg), tcfg, device="cpu")
    batch = encode_batches(13, 2, 8, 2)[0]
    batch["input_ids"][0, 3] = V
    with pytest.raises(ValueError, match="token ids"):
        enc.encode_corpus([batch])


def test_make_query_encoder_matches_the_batch_path():
    class Tok:  # any object with encode(...) serves as the tokenizer
        def encode(self, text, add_special_tokens=False, max_length=None,
                   truncation=True):
            return [REMOVE + (ord(c) % (V - REMOVE)) for c in text][
                :max_length]

    _, tcfg = configs(CASES["dhr_pooler"])
    model = load_flax_params(BiEncoder(tcfg), random_flax_params(
        tcfg, torch.Generator().manual_seed(0)))
    enc = Encoder(model, tcfg, EncodeConfig(batch_size=2,
                                            remove_dims=REMOVE), "cpu")
    queries = ["what is dhr", "x", "a longer query than the limit allows"]
    values, indices = make_query_encoder(enc, Tok(), 12, 1, 2)(queries)
    toks = [Tok().encode(q, max_length=12) for q in queries]
    want = enc.encode_queries([collate.collate_encode(
        ["0", "1", "2"], [collate.wrap_specials(t, 12, 1, 2) for t in toks],
        12)])
    np.testing.assert_array_equal(values, want[0])
    np.testing.assert_array_equal(indices, want[1])


def test_full_width_planes():
    """DistilBERT-base width (6 x 768, vocab 30522, the DHR head), B=2,
    L=16: 896 f16 values and 768 uint8 folds in [0, 39)."""
    cfg = RetrieverConfig(model_type="dhr", add_pooler=True,
                          encoder=EncoderConfig.distilbert_base())
    model = load_flax_params(BiEncoder(cfg), random_flax_params(
        cfg, torch.Generator().manual_seed(0)))
    enc = Encoder(model, cfg, device="cpu")
    batches = [collate.collate_encode(
        ["a", "b"], [[101, *t, 102] for t in ([2000] * 14, [5000, 7000])],
        16)]
    packed = enc.encode_corpus(batches)
    assert packed.values.shape == (2, 896) and packed.values.dtype == \
        np.float16
    assert packed.indices.shape == (2, 768) and packed.indices.dtype == \
        np.uint8
    assert packed.indices.max() < 39 and packed.lex_dim == 768
    assert np.isfinite(packed.values.astype(np.float32)).all()


# --------------------------------------------------------- the encode verb --


@pytest.fixture(scope="module")
def verb_world(tmp_path_factory):
    """An HF checkpoint (dhr, pooler) written by dhr_tpu, a 37-passage
    corpus and 9 queries of token ids without specials."""
    root = tmp_path_factory.mktemp("encode_verb")
    kw = CASES["dhr_pooler"]
    jcfg, _ = configs(kw)
    batches = encode_batches(14, 8, 12, 8)
    tree = flax_tree(jcfg, batches[0]["input_ids"],
                     batches[0]["attention_mask"], 14)
    ckpt = str(root / "ckpt")
    export_hf_checkpoint(ckpt, tree, jcfg)
    corpus, queries = str(root / "corpus.jsonl"), str(root / "queries.jsonl")
    examples.write_jsonl(corpus, [
        {"text_id": f"d{i}", "text": t}
        for i, t in enumerate(token_lists(15, N_DOCS, 0, 30))])
    examples.write_jsonl(queries, [
        {"text_id": f"q{i}", "text": t}
        for i, t in enumerate(token_lists(16, N_QUERIES, 1, 12))])
    common = ["--model", "dhr", "--model-name-or-path", ckpt,
              "--add-pooler", "--projection-dim", "128",
              "--dlr-out-dim", str(OUT), "--remove-dims", str(REMOVE),
              "--cls-token-id", "1", "--sep-token-id", "2",
              "--batch-size", "8", "--p-max-len", "24", "--q-max-len", "12"]
    return root, ckpt, corpus, queries, common, kw


def run_both_verbs(world, name, extra, is_query=False):
    root, _, corpus, queries, common, _ = world
    args = ["encode", *common, "--input", queries if is_query else corpus,
            *extra] + (["--encode-is-qry"] if is_query else [])
    ref, port = str(root / f"ref_{name}.npz"), str(root / f"port_{name}.npz")
    jax_main(args + ["--output", ref])
    main(args + ["--output", port, "--device", "cpu"])
    return ref, port


def port_lexical(world, path, max_len=24):
    """The port's f32 lexical rep of the verb's inputs, for near ties."""
    _, ckpt, _, _, _, kw = world
    model = load_port_from_dir(ckpt, kw)
    _, texts = examples.load_tokenized_corpus(path)
    b = collate.pad_token_batch(texts, max_len, 0, 1, 2)
    with torch.no_grad():
        return model.encoder_q(torch.from_numpy(b["input_ids"]),
                               torch.from_numpy(b["attention_mask"])
                               ).lexical.numpy()


@pytest.mark.parametrize("variant,extra", [
    ("plain", []),
    ("shard", ["--encode-num-shard", "3", "--encode-shard-index", "1"]),
    ("bucketed", ["--length-bucketing"]),
])
def test_encode_verb_corpus_matches_reference(verb_world, variant, extra):
    ref, port = run_both_verbs(verb_world, variant, extra)
    with np.load(ref) as w, np.load(port) as g:
        assert sorted(g.files) == sorted(w.files)
        assert_f16_within_one_ulp(g["values"], w["values"])
        assert int(g["lex_dim"]) == int(w["lex_dim"]) == OUT
        lex = port_lexical(verb_world, verb_world[2])
        if variant == "shard":
            lex = lex[np.array_split(np.arange(N_DOCS), 3)[1]]
        assert_folds_equal(g["indices"], w["indices"], lex)
        assert g["values"].shape[1] == OUT + 128
    want_ids = list(PackedIndex.load(ref).docids)
    assert list(PackedIndex.load(port).docids) == want_ids
    n = len(np.array_split(np.arange(N_DOCS), 3)[1]) if variant == \
        "shard" else N_DOCS
    assert len(want_ids) == n
    if variant == "bucketed":  # restored to input order
        assert want_ids == [f"d{i}" for i in range(N_DOCS)]


@pytest.mark.parametrize("variant,extra", [("plain", []),
                                           ("bucketed", ["--length-bucketing"])])
def test_encode_verb_queries_match_reference(verb_world, variant, extra):
    ref, port = run_both_verbs(verb_world, "q" + variant, extra, True)
    with np.load(ref) as w, np.load(port) as g:
        assert sorted(g.files) == sorted(w.files) == ["indices", "values"]
        assert_f16_within_one_ulp(g["values"], w["values"])
        assert_folds_equal(g["indices"], w["indices"], port_lexical(
            verb_world, verb_world[3], max_len=12))
    with open(ref + ".qids.json") as f, open(port + ".qids.json") as h:
        assert json.load(h) == json.load(f) == [
            f"q{i}" for i in range(N_QUERIES)]


def test_reference_search_over_port_shards_gives_the_same_run(verb_world):
    """Encode two corpus shards and the queries with each package, then
    index and search both with dhr_tpu: the same TREC run."""
    root = verb_world[0]
    runs = {}
    for who, runner, dev in (("ref", jax_main, []),
                             ("port", main, ["--device", "cpu"])):
        d = root / f"search_{who}"
        d.mkdir()
        *_, corpus, queries, common, _ = verb_world
        for i in range(2):
            runner(["encode", *common, "--input", corpus,
                    "--encode-num-shard", "2", "--encode-shard-index", str(i),
                    "--output", str(d / f"shard{i}.npz"), *dev])
        runner(["encode", *common, "--input", queries, "--encode-is-qry",
                "--output", str(d / "q.npz"), *dev])
        jax_main(["index", "--inputs", str(d / "shard*.npz"),
                  "--output", str(d / "index.npz")])
        jax_main(["search", "--index-path", str(d / "index.npz"),
                  "--query-path", str(d / "q.npz"), "--brute-force",
                  "--topk", "10", "--output", str(d / "run.trec")])
        runs[who] = (d / "run.trec").read_text()
    ranked = {who: {} for who in runs}
    for who, text in runs.items():
        for line in text.splitlines():
            q, _, doc, _, score, _ = line.split()
            ranked[who].setdefault(q, []).append((doc, float(score)))
    assert sorted(ranked["port"]) == sorted(ranked["ref"])
    for q, want in ranked["ref"].items():
        got = ranked["port"][q]
        ws = np.array([sc for _, sc in want])
        np.testing.assert_allclose([sc for _, sc in got], ws, rtol=1e-4)
        # the same document at every rank whose score is not tied (within
        # the f16 rounding of the values) with a neighbour's
        gap = np.abs(np.diff(ws)) > 1e-4 * np.abs(ws[1:])
        untied = np.r_[gap[:1], gap[1:] & gap[:-1], gap[-1:]]
        assert [d for (d, _), u in zip(got, untied) if u] == \
            [d for (d, _), u in zip(want, untied) if u]


def test_encode_verb_rejects_what_is_not_ported(verb_world, tmp_path):
    *_, corpus, _, common, _ = verb_world
    base = ["encode", *common, "--input", corpus, "--device", "cpu",
            "--output", str(tmp_path / "x.npz")]
    # token packing is ported; what it does not combine with fails by name
    for flag in (["--pack", "--encode-is-qry"],
                 ["--pack", "--pack-segments", "4", "--length-bucketing"]):
        with pytest.raises(SystemExit, match="--pack"):
            main(base + flag)
    cfg = tmp_path / "pack.json"
    cfg.write_text(json.dumps({"pack": True, "length_bucketing": True}))
    with pytest.raises(SystemExit, match="exclusive"):
        main(base + ["--config", str(cfg)])
    with pytest.raises(SystemExit, match="out of range"):
        main(base + ["--cls-token-id", str(V)])
    assert not os.path.exists(tmp_path / "x.npz")


def test_encode_verb_refuses_an_encoder_only_checkpoint(verb_world,
                                                         tmp_path):
    """A DHR model needs the MLM head: both CLIs refuse a checkpoint that
    lacks it, before writing anything."""
    _, ckpt, corpus, _, common, _ = verb_world
    enc_only = tmp_path / "enc_only"
    enc_only.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in
                load_hf_state_dict(ckpt).items()
                if not k.startswith("vocab_")},
               enc_only / "pytorch_model.bin")
    shutil.copy(os.path.join(ckpt, "config.json"), enc_only)
    args = ["encode", *common, "--input", corpus,
            "--output", str(tmp_path / "x.npz")]
    args[args.index(ckpt)] = str(enc_only)
    for runner, dev in ((jax_main, []), (main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="MLM-headed"):
            runner(args + dev)
    assert not os.path.exists(tmp_path / "x.npz")
