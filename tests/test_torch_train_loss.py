"""The port's training losses against dhr_tpu's, on the same numpy reps.

Every loss of ``dhr_tpu.train.loss`` for every family, one-hot and with
teacher scores, is computed by both packages from reps drawn with numpy
from a seed.  Values agree to 1e-6 relative (f32 sums in another order);
gradients with respect to the reps to 1e-5 of each rep's gradient scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhr_tpu.models.retrievers import Reps as JaxReps
from dhr_tpu.train import loss as jl
from dhr_tpu_torch.encode import collate_packed, plan_packing
from dhr_tpu_torch.models.retrievers import Reps
from dhr_tpu_torch.train import loss as tl

V, REMOVE, OUT = 1024, 64, 96  # 10 folds
B, N_PSG = 3, 4
P = B * N_PSG


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def lexical(rng, n, zero_frac=0.3):
    """Nonnegative vocabulary-space reps with exact zeros, as the max over
    masked positions gives them."""
    x = rng.random((n, V)).astype(np.float32) ** 4
    x[rng.random((n, V)) < zero_frac] = 0.0
    return x


def reps_pair(seed, family):
    rng = np.random.default_rng(seed)
    if family == "colbert":
        def tok(n, L):
            t = rng.standard_normal((n, L, 8)).astype(np.float32)
            t[:, L - 2:] = 0.0  # padded rows are zero vectors
            return t
        q, p = tok(B, 6), tok(P, 9)
        f = {"q": dict(token=q[:, 1:], token_cls=q[:, :1]),
             "p": dict(token=p[:, 1:], token_cls=p[:, :1])}
    elif family == "dense":
        f = {"q": dict(dense=rng.standard_normal((B, 16), np.float32)),
             "p": dict(dense=rng.standard_normal((P, 16), np.float32))}
    else:
        f = {"q": dict(lexical=lexical(rng, B),
                       semantic=rng.standard_normal((B, 8), np.float32)),
             "p": dict(lexical=lexical(rng, P),
                       semantic=rng.standard_normal((P, 8), np.float32))}
    return f


def as_reps(fields, grad=False):
    t = {k: torch.tensor(v, requires_grad=grad) for k, v in fields.items()}
    return Reps(**t), JaxReps(**{k: jnp.asarray(v) for k, v in
                                 fields.items()})


def teacher(seed):
    return np.random.default_rng(seed + 7).standard_normal(
        (B, N_PSG)).astype(np.float32)


def listwise_teacher(seed):
    return np.random.default_rng(seed + 8).standard_normal(
        (B, P)).astype(np.float32)


def test_score_matrices():
    f = reps_pair(0, "dhr")
    (tq, jq), (tp, jp) = as_reps(f["q"]), as_reps(f["p"])
    close(tl.listwise_ip(tq.semantic, tp.semantic),
          jl.listwise_ip(jq.semantic, jp.semantic))
    close(tl.listwise_gip(tq.lexical, tp.lexical, OUT, REMOVE),
          jl.listwise_gip(jq.lexical, jp.lexical, OUT, REMOVE))
    c = reps_pair(1, "colbert")
    (tq, jq), (tp, jp) = as_reps(c["q"]), as_reps(c["p"])
    close(tl.listwise_maxsim(tq.token, tp.token),
          jl.listwise_maxsim(jq.token, jp.token))
    close(tl.pairwise_maxsim(tq.token, tp.token[:B]),
          jl.pairwise_maxsim(jq.token, jp.token[:B]))
    close(tl.colbert_teacher_scores(tq, tp),
          jl.colbert_teacher_scores(jq, jp))


@pytest.mark.parametrize("n", [1, 4])
def test_kl_and_teacher_layout(n):
    rng = np.random.default_rng(n)
    s = rng.standard_normal((B, B * n)).astype(np.float32) * 3
    t = rng.standard_normal((B, B * n)).astype(np.float32)
    assert tl.positive_columns(B, n).tolist() == \
        np.asarray(jl.positive_columns(B, n)).tolist()
    close(tl.kl_onehot(torch.from_numpy(s), n), jl.kl_onehot(jnp.asarray(s),
                                                             n))
    for temp in (1.0, 0.25):
        close(tl.kl_vs_teacher(torch.from_numpy(s), torch.from_numpy(t),
                               temp),
              jl.kl_vs_teacher(jnp.asarray(s), jnp.asarray(t), temp))
    tb = rng.standard_normal((B, n)).astype(np.float32)
    close(tl.expand_teacher_margins(torch.from_numpy(tb), B * n),
          jl.expand_teacher_margins(jnp.asarray(tb), B * n))
    close(tl.dense_contrastive_loss(torch.from_numpy(s[:, :2]),
                                    torch.from_numpy(t[:, :2]), 1, 2.0),
          jl.dense_contrastive_loss(jnp.asarray(s[:, :2]),
                                    jnp.asarray(t[:, :2]), 1, 2.0))


LOSS_CASES = {
    "dhr_gip": ("dhr", dict(dlr_out_dim=OUT, remove_dims=REMOVE)),
    "dhr_ip": ("dhr", dict(dlr_out_dim=None)),
    "dlr": ("dhr", dict(dlr_out_dim=OUT, remove_dims=REMOVE,
                        combine_cls=False)),
    "agg_full": ("agg", dict(agg_dim=48)),
    "agg_semi": ("agg", dict(agg_dim=48, semi_aggregate=True)),
    "agg_no_semantic": ("agg", dict(agg_dim=48)),
    "colbert": ("colbert", {}),
}


def _loss_fns(case):
    fam, kw = LOSS_CASES[case]
    if fam == "dhr":
        return tl.dhr_loss, jl.dhr_loss, kw
    if fam == "agg":
        return tl.agg_loss, jl.agg_loss, kw
    return tl.colbert_loss, jl.colbert_loss, kw


@pytest.mark.parametrize("with_teacher", [False, True])
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_family_losses_and_rep_gradients(case, with_teacher):
    fam = LOSS_CASES[case][0]
    f = reps_pair(3, "dhr" if fam in ("dhr", "agg") else fam)
    if case == "agg_no_semantic":
        f["q"].pop("semantic")
        f["p"].pop("semantic")
    t_fn, j_fn, kw = _loss_fns(case)
    kw = dict(kw, temperature=0.5, loss_scale=2.0)
    t_teacher = j_teacher = None
    if with_teacher:
        ts = teacher(3) if fam == "colbert" else listwise_teacher(3)
        t_teacher, j_teacher = torch.from_numpy(ts), jnp.asarray(ts)
    (tq, _), (tp, _) = as_reps(f["q"], True), as_reps(f["p"], True)
    t_loss, t_scores = t_fn(tq, tp, N_PSG, teacher_scores=t_teacher, **kw)

    def j_loss(qf, pf):
        return j_fn(JaxReps(**qf), JaxReps(**pf), N_PSG,
                    teacher_scores=j_teacher, **kw)

    jq = {k: jnp.asarray(v) for k, v in f["q"].items()}
    jp = {k: jnp.asarray(v) for k, v in f["p"].items()}
    (j_val, j_scores), (gq, gp) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jq, jp)
    close(t_loss, j_val)
    close(t_scores, j_scores)
    t_loss.backward()
    for side, grads in ((tq, gq), (tp, gp)):
        for k, g in grads.items():
            close(getattr(side, k).grad, g, rtol=1e-5)


def _packed_layout(seed, n_passages=P, p_len=12, segments=4):
    """A collate_train_packed-like layout for ``n_passages`` passages of
    random length: (segment_ids, position_ids, seg_start, slot_pos)."""
    rng = np.random.default_rng(seed)
    toks = [rng.integers(100, 200, rng.integers(1, p_len - 1)).tolist()
            for _ in range(n_passages)]
    rows = plan_packing([len(t) + 2 for t in toks], p_len, segments)
    packed = collate_packed(rows, list(range(n_passages)), toks, len(rows),
                            p_len, segments, 1, 2)
    slot_pos = np.zeros(n_passages, np.int32)
    for r, row in enumerate(rows):
        for s, item in enumerate(row):
            slot_pos[item] = r * segments + s
    return packed, slot_pos


@pytest.mark.parametrize("with_teacher", [False, True])
def test_colbert_packed_loss(with_teacher):
    packed, slot_pos = _packed_layout(5)
    rng = np.random.default_rng(6)
    seg = packed["segment_ids"]
    tok = rng.standard_normal((*seg.shape, 8)).astype(np.float32)
    tok *= (seg > 0)[..., None]
    f = reps_pair(6, "colbert")["q"]
    ts = teacher(6) if with_teacher else None
    args = [packed["segment_ids"], packed["position_ids"],
            packed["seg_start"], slot_pos]
    t_loss, t_scores = tl.colbert_loss_packed(
        Reps(**{k: torch.from_numpy(v) for k, v in f.items()}),
        torch.from_numpy(tok), *map(torch.from_numpy, args), N_PSG, 12,
        teacher_scores=None if ts is None else torch.from_numpy(ts),
        temperature=0.5)
    j_loss, j_scores = jl.colbert_loss_packed(
        JaxReps(**{k: jnp.asarray(v) for k, v in f.items()}),
        jnp.asarray(tok), *map(jnp.asarray, args), N_PSG, 12,
        teacher_scores=None if ts is None else jnp.asarray(ts),
        temperature=0.5)
    close(t_loss, j_loss)
    close(t_scores, j_scores)


@pytest.mark.parametrize("with_teacher", [False, True])
@pytest.mark.parametrize("family", ["dhr", "agg"])
def test_packed_dhr_and_agg_losses(family, with_teacher):
    """The packed forms take per-passage reduced planes; from the same
    planes they give the reference's loss."""
    f = reps_pair(8, "dhr")
    (tq, jq), _ = as_reps(f["q"]), None
    rng = np.random.default_rng(9)
    ts = listwise_teacher(8) if with_teacher else None
    tt = None if ts is None else torch.from_numpy(ts)
    jt = None if ts is None else jnp.asarray(ts)
    sem = f["p"]["semantic"]
    if family == "dhr":
        pv = rng.random((P, OUT)).astype(np.float32)
        pi = rng.integers(0, 10, (P, OUT)).astype(np.int32)
        got = tl.dhr_loss_packed(tq, *map(torch.from_numpy, (pv, pi, sem)),
                                 N_PSG, dlr_out_dim=OUT, remove_dims=REMOVE,
                                 teacher_scores=tt)
        want = jl.dhr_loss_packed(jq, *map(jnp.asarray, (pv, pi, sem)),
                                  N_PSG, dlr_out_dim=OUT, remove_dims=REMOVE,
                                  teacher_scores=jt)
    else:
        ptok = rng.standard_normal((P, 48)).astype(np.float32)
        got = tl.agg_loss_packed(tq, torch.from_numpy(ptok),
                                 torch.from_numpy(sem), N_PSG, agg_dim=48,
                                 teacher_scores=tt)
        want = jl.agg_loss_packed(jq, jnp.asarray(ptok), jnp.asarray(sem),
                                  N_PSG, agg_dim=48, teacher_scores=jt)
    close(got[0], want[0])
    close(got[1], want[1])


def _margin_kd_want(case, f, margins, temp, scale):
    """The margin-KD loss from the reference's own pieces: its score
    matrices, each component's KL against ``expand_teacher_margins`` of
    the margins at that component's temperature (what its ColBERT loss
    does with margins), in its temperature splits 1 / 3/4 / 1/4."""
    fam, kw = LOSS_CASES[case]
    q = {k: jnp.asarray(v) for k, v in f["q"].items()}
    p = {k: jnp.asarray(v) for k, v in f["p"].items()}
    sem = (jl.listwise_ip(q["semantic"], p["semantic"])
           if "semantic" in q else None)
    if fam == "dhr":
        lex = (jl.listwise_gip(q["lexical"], p["lexical"], OUT, REMOVE)
               if kw["dlr_out_dim"] else jl.listwise_ip(q["lexical"],
                                                        p["lexical"]))
        scores = lex + (0.0 if kw.get("combine_cls") is False else 1.0) * sem
    else:
        from dhr_tpu.ops.aggregate import aggregate as jagg

        full = not kw.get("semi_aggregate", False)
        lex = jl.listwise_ip(jagg(q["lexical"], 48, full=full),
                             jagg(p["lexical"], 48, full=full))
        scores = lex if sem is None else lex + sem

    def kl(x, t):
        return jl.kl_vs_teacher(x, jl.expand_teacher_margins(
            jnp.asarray(margins) * t, P), 1.0)

    loss = kl(scores, temp) + 0.5 * kl(lex, temp / 4)
    if sem is not None:
        loss = loss + 0.5 * kl(sem, temp * 3 / 4)
    return loss * scale, scores


@pytest.mark.parametrize("case", sorted(c for c in LOSS_CASES
                                        if c != "colbert"))
def test_margin_kd_of_dhr_and_agg(case):
    """Margin-KD scores (B, n) from ``bin_pairs``: the reference's DHR and
    Aggretriever losses broadcast them against the (B, B*n) score matrix
    and fail; the port places them on the block diagonal at each
    temperature, as the ColBERT loss does, and gives the loss built from
    the reference's own pieces."""
    f = reps_pair(11, "dhr")
    if case == "agg_no_semantic":
        f["q"].pop("semantic")
        f["p"].pop("semantic")
    t_fn, j_fn, kw = _loss_fns(case)
    kw = dict(kw, temperature=0.5, loss_scale=2.0)
    margins = teacher(11)
    margins[:, 0] = 0.0  # the positive's margin, as the collator writes it
    with pytest.raises((TypeError, ValueError)):
        j_fn(*(JaxReps(**{k: jnp.asarray(v) for k, v in f[s].items()})
               for s in ("q", "p")), N_PSG,
             teacher_scores=jnp.asarray(margins), **kw)
    (tq, _), (tp, _) = as_reps(f["q"]), as_reps(f["p"])
    got, scores = t_fn(tq, tp, N_PSG, teacher_scores=torch.from_numpy(
        margins), **kw)
    want, want_scores = _margin_kd_want(case, f, margins, 0.5, 2.0)
    close(got, want)
    close(scores, want_scores)
