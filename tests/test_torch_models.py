"""The port's models against dhr_tpu's on the same Flax params.

Each case builds one numpy batch (pads included) from a seed, initializes
the reference's ``BiEncoder`` with Flax, perturbs every parameter (so
biases, LayerNorm scales and the MLM bias are not at their init values),
runs the reference eagerly and the port with the same tree loaded through
``load_flax_params``, and compares every ``Reps`` field.

Tolerances (f32): ``|got - want| <= 1e-4 * |want| + 1e-5 * max|want|`` per
field, i.e. rounding from a different summation order.  Fold indices of
the densified lexical rep are exact, except where the reference's top two
folds lie within 1e-6 of each other.  bf16: the max difference within 5%
of the field's largest magnitude and the relative L2 error within 2%
(bf16 keeps 8 bits; the two stacks round their products and bias adds at
different points).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.models.retrievers import RetrieverConfig as JaxRetrieverConfig
from dhr_tpu.models.transformer import EncoderConfig as JaxEncoderConfig
from dhr_tpu.models.transformer import EncoderWithMLM as JaxEncoderWithMLM
from dhr_tpu_torch.models import (
    BiEncoder,
    EncoderConfig,
    EncoderWithMLM,
    RetrieverConfig,
    load_flax_params,
    random_flax_params,
)
from dhr_tpu_torch.models.transformer import compute_copy
from dhr_tpu_torch.ops.densify import densify

V, REMOVE, OUT = 1024, 64, 96  # (V - REMOVE) % OUT == 0: 10 folds
B, L = 4, 12
FIELDS = ("dense", "lexical", "semantic", "token", "token_cls")

CASES = {
    "dense_cls": dict(model_type="dense"),
    "dense_cls_pooler": dict(model_type="dense", add_pooler=True),
    "dense_mean_pooler": dict(model_type="dense", pooling="mean",
                              add_pooler=True),
    "dhr_pooler": dict(model_type="dhr", add_pooler=True, dlr_out_dim=OUT),
    "dhr_no_pooler": dict(model_type="dhr", dlr_out_dim=OUT),
    "dlr_pooler": dict(model_type="dlr", add_pooler=True, dlr_out_dim=OUT),
    "dlr_no_pooler": dict(model_type="dlr", dlr_out_dim=OUT),
    "agg_full": dict(model_type="agg", add_pooler=True, agg_dim=48),
    "agg_semi": dict(model_type="agg", add_pooler=True, agg_dim=48,
                     semi_aggregate=True),
    "agg_skip_mlm": dict(model_type="agg", add_pooler=True, skip_mlm=True),
    "colbert": dict(model_type="colbert", projection_dim=16),
    "dhr_untied": dict(model_type="dhr", add_pooler=True, dlr_out_dim=OUT,
                       untie_encoder=True),
}


def batch(seed, b=B, length=L, vocab=V):
    """Token ids in [REMOVE, vocab) after a [CLS] of 1, rows of lengths
    length, length - 4, 3, ... and pads (id 0, mask 0)."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(length - 4 * np.arange(b), 3)
    mask = (np.arange(length)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.integers(REMOVE, vocab, (b, length)), 0)
    ids[:, 0] = 1
    return ids.astype(np.int32), mask


def flax_tree(jcfg, ids, mask, seed):
    """Flax init, every leaf perturbed by N(0, 0.05), as numpy."""
    jb = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}
    params = JaxBiEncoder(jcfg).init(jax.random.PRNGKey(seed), query=jb,
                                     passage=jb)["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng
                        .standard_normal(a.shape).astype(np.float32), params)


def configs(kw, jdtype=jnp.float32, tdtype=torch.float32, **enc):
    jcfg = JaxRetrieverConfig(
        encoder=JaxEncoderConfig.tiny(vocab_size=V, dtype=jdtype, **enc),
        **kw)
    tcfg = RetrieverConfig(
        encoder=EncoderConfig.tiny(vocab_size=V, dtype=tdtype, **enc), **kw)
    return jcfg, tcfg


def run_both(jcfg, tcfg, seed=0):
    ids, mask = batch(seed)
    tree = flax_tree(jcfg, ids, mask, seed)
    jb = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}
    want = JaxBiEncoder(jcfg).apply({"params": tree}, query=jb, passage=jb)
    model = load_flax_params(BiEncoder(tcfg), tree)
    tb = {"input_ids": torch.from_numpy(ids),
          "attention_mask": torch.from_numpy(mask)}
    with torch.no_grad():
        got = model(query=tb, passage=tb)
    return got, want, tree


def assert_close_f32(name, got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=name)


def assert_folds_equal(lex_got, lex_want, out_dim, remove):
    """Densified fold indices equal, except where the reference's top two
    folds are within 1e-6 of each other."""
    _, got = densify(lex_got, out_dim, remove)
    want_lex = np.asarray(lex_want, np.float32)
    folded = want_lex[:, remove:].reshape(want_lex.shape[0], -1, out_dim)
    want = folded.argmax(axis=1)
    top2 = np.sort(folded, axis=1)[:, -2:]
    near_tie = top2[:, 1] - top2[:, 0] <= 1e-6 * np.maximum(
        np.abs(top2[:, 1]), 1e-30)
    differ = got.numpy() != want
    assert not (differ & ~near_tie).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reps_match_reference_f32(case):
    kw = CASES[case]
    jcfg, tcfg = configs(kw)
    (tq, tp), (jq, jp), _ = run_both(jcfg, tcfg)
    for side, got, want in (("query", tq, jq), ("passage", tp, jp)):
        for f in FIELDS:
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f"{case} {side} {f}"
            if w is not None:
                assert g.dtype == torch.float32
                assert_close_f32(f"{case} {side} {f}", g, w)
        if kw["model_type"] in ("dhr", "dlr"):
            assert_folds_equal(got.lexical, want.lexical, OUT, REMOVE)


def test_bert_layout_with_token_types_matches_reference():
    jcfg, tcfg = configs(dict(model_type="dhr", add_pooler=True,
                              dlr_out_dim=OUT), type_vocab_size=2)
    (tq, _), (jq, _), tree = run_both(jcfg, tcfg, seed=3)
    assert "token_type" in tree["encoder_q"]["backbone"]["encoder"][
        "embeddings"]
    assert_close_f32("lexical", tq.lexical, jq.lexical)
    assert_close_f32("semantic", tq.semantic, jq.semantic)


def test_hidden_states_and_logits_match_reference():
    """The backbone alone: hidden states and MLM logits at every position,
    pad rows included (the mask covers keys only)."""
    jcfg, tcfg = configs(dict(model_type="dhr"))
    ids, mask = batch(1)
    tree = flax_tree(jcfg, ids, mask, 1)["encoder_q"]["backbone"]
    jh, jl = JaxEncoderWithMLM(jcfg.encoder).apply(
        {"params": tree}, jnp.asarray(ids), jnp.asarray(mask))
    model = load_flax_params(EncoderWithMLM(tcfg.encoder), tree)
    with torch.no_grad():
        th, tl = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)


def test_untied_query_and_passage_towers_differ():
    jcfg, tcfg = configs(CASES["dhr_untied"])
    (tq, tp), _, tree = run_both(jcfg, tcfg)
    assert set(tree) == {"encoder_q", "encoder_p"}
    assert not torch.allclose(tq.lexical, tp.lexical)


def test_skip_mlm_scatters_pad_positions_into_bucket_zero():
    """agg skip-MLM: pad positions (id 0) scatter their term weights into
    vocabulary bucket 0, as the reference does (no mask in the scatter)."""
    jcfg, tcfg = configs(CASES["agg_skip_mlm"])
    (_, tp), (_, jp), _ = run_both(jcfg, tcfg)
    assert_close_f32("bucket 0", tp.lexical[:, :1], jp.lexical[:, :1])
    assert float(tp.lexical[1:, 0].abs().max()) > 0


def test_bf16_dhr_within_stated_tolerance():
    jcfg, tcfg = configs(CASES["dhr_pooler"], jnp.bfloat16, torch.bfloat16)
    (tq, tp), (jq, jp), _ = run_both(jcfg, tcfg, seed=2)
    for got, want in ((tq, jq), (tp, jp)):
        for f in ("lexical", "semantic"):
            g = getattr(got, f).float().numpy()
            w = np.asarray(getattr(want, f), np.float32)
            scale = np.abs(w).max()
            assert np.abs(g - w).max() <= 0.05 * scale, f
            assert np.linalg.norm(g - w) <= 0.02 * np.linalg.norm(w), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compute_copy_gives_the_same_reps(dtype):
    """Pre-cast weights (the Encoder's copy) compute exactly what the f32
    parameters cast in each call compute."""
    _, tcfg = configs(CASES["dhr_pooler"], tdtype=dtype)
    model = BiEncoder(tcfg)
    load_flax_params(model, random_flax_params(
        tcfg, torch.Generator().manual_seed(0)))
    fast = compute_copy(model, dtype, torch.device("cpu"))
    ids, mask = (torch.from_numpy(a) for a in batch(4))
    with torch.no_grad():
        want = model.encoder_q(ids, mask)
        got = fast.encoder_q(ids, mask)
    assert torch.equal(got.lexical, want.lexical)
    assert torch.equal(got.semantic, want.semantic)
    assert model.encoder_q.pooler.linear.weight.dtype == torch.float32


@pytest.mark.parametrize("case", sorted(CASES))
def test_random_flax_params_have_the_reference_layout(case):
    """The random tree the port draws has the reference's Flax tree
    structure, shapes and dtype, for every model family."""
    jcfg, tcfg = configs(CASES[case])
    ids, mask = batch(0)
    want = jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype)),
                        flax_tree(jcfg, ids, mask, 0))
    got = jax.tree.map(lambda a: (a.shape, a.dtype), random_flax_params(
        tcfg, torch.Generator().manual_seed(0)))
    assert got == want


def test_config_rules_match_reference():
    for kw in CASES.values():
        j = JaxRetrieverConfig(**kw)
        t = RetrieverConfig(**kw)
        assert (t.needs_mlm, t.combine_cls) == (j.needs_mlm, j.combine_cls)
    with pytest.raises(ValueError):
        RetrieverConfig(model_type="splade")
    for name in ("distilbert_base", "bert_base"):
        j, t = getattr(JaxEncoderConfig, name)(), getattr(EncoderConfig,
                                                          name)()
        jd = {k: v for k, v in dataclasses.asdict(j).items()
              if k not in ("dtype", "remat")}
        td = {k: v for k, v in dataclasses.asdict(t).items() if k != "dtype"}
        assert jd == td and t.dtype == torch.bfloat16


def test_rows_longer_than_the_position_table_raise():
    """The reference's gather clamps such positions silently; the port's
    would index past the table, so it refuses them by name."""
    _, tcfg = configs(CASES["dhr_pooler"])
    model = BiEncoder(tcfg)
    ids = torch.ones(1, tcfg.encoder.max_position_embeddings + 1,
                     dtype=torch.int32)
    with pytest.raises(ValueError, match="positions"):
        model.encoder_q(ids, torch.ones_like(ids))
