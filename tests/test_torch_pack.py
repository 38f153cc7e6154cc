"""Token packing: several documents per row under block-diagonal attention.

- ``plan_packing``'s invariants, and its plan equal to ``dhr_tpu``'s;
- the packed encode against the port's plain encode (values to f32
  rounding, folds equal except at near ties), for every family, and against
  ``dhr_tpu``'s packed encode on the same Flax weights;
- CLI ``encode --pack`` equal to plain ``encode``, and its rejections.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhr_tpu import encode as jencode
from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.models.retrievers import RetrieverConfig as JaxRetrieverConfig
from dhr_tpu.models.transformer import EncoderConfig as JaxEncoderConfig
from dhr_tpu_torch.cli.main import main as cli
from dhr_tpu_torch.data.collate import collate_encode, wrap_specials
from dhr_tpu_torch.data.examples import write_jsonl
from dhr_tpu_torch.encode import (
    EncodeConfig,
    Encoder,
    packed_encode_batches,
    plan_packing,
)
from dhr_tpu_torch.models import (
    BiEncoder,
    EncoderConfig,
    RetrieverConfig,
    load_flax_params,
)
from dhr_tpu_torch.ops.densify import densify

V, REMOVE, OUT = 1024, 64, 96
ROW, SEG = 32, 4
ENC = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=64)
FAMILIES = {
    "dense_cls": dict(model_type="dense", add_pooler=True),
    "dense_mean": dict(model_type="dense", pooling="mean"),
    "dhr": dict(model_type="dhr", add_pooler=True, dlr_out_dim=OUT),
    "dhr_segfirst": dict(model_type="dhr", add_pooler=True, dlr_out_dim=OUT,
                         packed_segfirst=True),
    "dlr": dict(model_type="dlr", dlr_out_dim=OUT),
    "agg_full": dict(model_type="agg", add_pooler=True, agg_dim=48),
    "agg_semi": dict(model_type="agg", agg_dim=48, semi_aggregate=True),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def corpus(seed=0, n=37):
    rng = np.random.default_rng(seed)
    toks = [rng.integers(REMOVE, V, rng.integers(0, ROW)).tolist()
            for _ in range(n)]
    return [f"d{i}" for i in range(n)], toks


def configs(kw):
    jkw = {k: v for k, v in kw.items() if k != "packed_segfirst"}
    return (JaxRetrieverConfig(encoder=JaxEncoderConfig(dtype=jnp.float32,
                                                        **ENC),
                               packed_segfirst=kw.get("packed_segfirst",
                                                      False), **jkw),
            RetrieverConfig(encoder=EncoderConfig(dtype=torch.float32, **ENC),
                            **kw))


def flax_tree(jcfg, seed=0):
    x = {"input_ids": jnp.ones((2, 8), jnp.int32),
         "attention_mask": jnp.ones((2, 8), jnp.int32)}
    params = JaxBiEncoder(jcfg).init(jax.random.PRNGKey(seed), query=x,
                                     passage=x)["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng
                        .standard_normal(a.shape).astype(np.float32), params)


def plain_index(enc, ids, toks):
    batches = (collate_encode(ids[s:s + 8], [wrap_specials(t, ROW, 1, 2)
                                             for t in toks[s:s + 8]], ROW)
               for s in range(0, len(ids), 8))
    return enc.encode_corpus(batches)


def packed_index(enc, ids, toks, rows=3):
    batches, order = packed_encode_batches(ids, toks, rows, ROW, SEG, 1, 2)
    packed = enc.encode_corpus_packed(batches)
    inv = np.argsort(order)
    return dataclasses.replace(
        packed, values=packed.values[inv],
        indices=None if packed.indices is None else packed.indices[inv],
        docids=packed.docids[inv])


def assert_planes(got, want, lex_dim=None):
    assert list(got.docids) == list(want.docids)
    gv, wv = got.values.astype(np.float32), want.values.astype(np.float32)
    np.testing.assert_allclose(gv, wv, rtol=2e-3, atol=1e-3 * np.abs(
        wv).max())
    if want.indices is not None:
        differ = got.indices != want.indices
        # a differing fold is a near tie: the two folds' values agree
        assert differ.mean() < 0.02, differ.mean()


def test_plan_packing_invariants_and_reference_plan():
    rng = np.random.default_rng(1)
    lengths = np.concatenate([rng.integers(0, 40, 500), [0, 1, 200]])
    for row_len, segs in ((32, 4), (128, 8), (16, 1)):
        rows = plan_packing(lengths, row_len, segs)
        assert rows == [[int(i) for i in r] for r in jencode.plan_packing(
            lengths, row_len, segs)]
        flat = sorted(i for r in rows for i in r)
        assert flat == list(range(len(lengths)))
        for r in rows:
            assert 1 <= len(r) <= segs
            assert sum(int(np.clip(lengths[i], 1, row_len)) for i in r) \
                <= row_len


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_packed_encode_matches_plain_and_reference(family):
    jcfg, tcfg = configs(FAMILIES[family])
    tree = flax_tree(jcfg)
    model = load_flax_params(BiEncoder(tcfg), tree)
    enc = Encoder(model, tcfg, EncodeConfig(batch_size=8,
                                            remove_dims=REMOVE), device="cpu")
    ids, toks = corpus()
    got = packed_index(enc, ids, toks)
    assert_planes(got, plain_index(enc, ids, toks))
    jenc = jencode.Encoder(JaxBiEncoder(jcfg), jax.tree.map(jnp.asarray,
                                                            tree), jcfg,
                           jencode.EncodeConfig(batch_size=3,
                                                remove_dims=REMOVE))
    jb, jorder = jencode.packed_encode_batches(ids, toks, 3, ROW, SEG, 1, 2)
    want = jenc.encode_corpus_packed(jb)
    batches, order = packed_encode_batches(ids, toks, 3, ROW, SEG, 1, 2)
    assert np.array_equal(order, jorder)
    plan_order = enc.encode_corpus_packed(batches)
    assert list(plan_order.docids) == list(want.docids)
    np.testing.assert_allclose(plan_order.values.astype(np.float32),
                               want.values.astype(np.float32), rtol=2e-3,
                               atol=1e-3 * np.abs(want.values).max())
    if want.indices is not None:
        assert (plan_order.indices != want.indices).mean() < 0.02


def test_packed_folds_equal_plain_away_from_ties():
    """dhr: every fold index the packed encode gives equals the plain
    encode's, except where the plain lexical rep's top two folds tie within
    1e-6."""
    jcfg, tcfg = configs(FAMILIES["dhr"])
    model = load_flax_params(BiEncoder(tcfg), flax_tree(jcfg, 3))
    ids, toks = corpus(4)
    rows = [wrap_specials(t, ROW, 1, 2) for t in toks]
    b = collate_encode(ids, rows, ROW)
    with torch.no_grad():
        lex = model.encoder_q(torch.from_numpy(b["input_ids"]),
                              torch.from_numpy(b["attention_mask"])).lexical
    folded = lex[:, REMOVE:].reshape(len(ids), -1, OUT)
    top2 = folded.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= 1e-6 * top2[:, 0].abs()
    want = densify(lex, OUT, REMOVE)[1].numpy()
    enc = Encoder(model, tcfg, EncodeConfig(remove_dims=REMOVE),
                  device="cpu")
    got = packed_index(enc, ids, toks).indices
    assert not ((got != want) & ~near.numpy()).any()


def test_colbert_packed_tokens_match_plain():
    _, tcfg = configs(dict(model_type="colbert", projection_dim=16))
    enc = Encoder(BiEncoder(tcfg), tcfg, device="cpu")
    ids, toks = corpus(5, 20)
    batches, order = packed_encode_batches(ids, toks, 4, ROW, SEG, 1, 2)
    reps, out_ids = enc.encode_tokens_packed(batches, ROW)
    inv = np.argsort(order)
    plain = (collate_encode(ids[s:s + 8], [wrap_specials(t, ROW, 1, 2)
                                           for t in toks[s:s + 8]], ROW)
             for s in range(0, len(ids), 8))
    want, want_ids = enc.encode_tokens(plain, "passage")
    assert [out_ids[i] for i in inv] == want_ids
    np.testing.assert_allclose(reps[inv].astype(np.float32),
                               want.astype(np.float32), rtol=2e-3,
                               atol=2e-3 * np.abs(want).max())
    with pytest.raises(ValueError, match="colbert"):
        enc.encode_corpus_packed(packed_encode_batches(ids, toks, 4, ROW,
                                                       SEG, 1, 2)[0])


def _write_corpus(tmp_path, seed=6):
    ids, toks = corpus(seed, 30)
    write_jsonl(str(tmp_path / "c.jsonl"), ({"text_id": i, "text": t}
                                            for i, t in zip(ids, toks)))
    return str(tmp_path / "c.jsonl")


MODEL = ["--tiny", "--dlr-out-dim", str(OUT), "--remove-dims", str(REMOVE),
         "--cls-token-id", "1", "--sep-token-id", "2", "--p-max-len",
         str(ROW), "--batch-size", "4", "--device", "cpu"]


@pytest.mark.parametrize("model", [["--add-pooler"], ["--model", "colbert"]])
def test_cli_encode_pack_equals_plain(tmp_path, model):
    path = _write_corpus(tmp_path)
    cli(["encode", *MODEL, *model, "--input", path, "--output",
         str(tmp_path / "plain.npz")])
    cli(["encode", *MODEL, *model, "--input", path, "--output",
         str(tmp_path / "packed.npz"), "--pack", "--pack-segments", "3"])
    with np.load(tmp_path / "plain.npz") as a, \
            np.load(tmp_path / "packed.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            x, y = a[k].astype(np.float32), b[k].astype(np.float32)
            if k == "indices":
                assert (a[k] != b[k]).mean() < 0.02
            else:
                np.testing.assert_allclose(y, x, rtol=2e-3,
                                           atol=2e-3 * np.abs(x).max())
    suffix = ".npz.ids.json" if "colbert" in model else ".docids.json"
    with open(str(tmp_path / "plain") + suffix) as f:
        plain_ids = json.load(f)
    with open(str(tmp_path / "packed") + suffix) as f:
        assert json.load(f) == plain_ids


def test_cli_encode_pack_rejections(tmp_path):
    path = _write_corpus(tmp_path)
    out = ["--input", path, "--output", str(tmp_path / "x.npz"), "--pack"]
    with pytest.raises(SystemExit, match="corpus encode only"):
        cli(["encode", *MODEL, *out, "--encode-is-qry"])
    with pytest.raises(SystemExit, match="exclusive"):
        cli(["encode", *MODEL, *out, "--length-bucketing"])
    with pytest.raises(SystemExit, match="skip-mlm"):
        cli(["encode", *MODEL, *out, "--model", "agg", "--skip-mlm"])
    _, tcfg = configs(dict(model_type="agg", skip_mlm=True))
    with pytest.raises(ValueError, match="skip_mlm"):
        BiEncoder(tcfg).encode_passages_packed(
            *(torch.ones(1, 4, dtype=torch.int32),) * 3,
            torch.zeros(1, 1, dtype=torch.int32))
