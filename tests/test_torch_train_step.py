"""The port's train steps against dhr_tpu's, on the same weights and batches.

Tiny width (2 layers, hidden 64, vocab 1,024), dropout 0 wherever values
are compared.  The reference's step gradients come out of its own
``make_train_step`` / ``make_packed_train_step`` through an optax
transformation that keeps the gradient tree as its state.  Attention-key
biases are left out of every gradient and parameter comparison: their
gradient is zero up to float noise (softmax is shift-invariant).

- the plain step for dhr, dlr, dense, agg and colbert: loss to 1e-5
  relative, gradients to 1e-4 of each tensor's scale;
- the packed step against the reference's packed step and the port's plain
  step;
- grad-cache against the plain step, and with dropout on, pass 2's reps
  equal pass 1's;
- the in-graph TCT teacher;
- an 8-step AdamW trajectory against the reference's ``run_training``:
  loss relative difference < 1e-4, parameters within 5% of their movement.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dhr_tpu.data import SamplingConfig as JaxSamplingConfig
from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.models.retrievers import RetrieverConfig as JaxRetrieverConfig
from dhr_tpu.models.transformer import EncoderConfig as JaxEncoderConfig
from dhr_tpu.train import LossConfig as JaxLossConfig
from dhr_tpu.train import OptimizerConfig as JaxOptimizerConfig
from dhr_tpu.train.driver import RunConfig as JaxRunConfig
from dhr_tpu.train.driver import run_training as jax_run_training
from dhr_tpu.train.state import TrainState as JaxTrainState
from dhr_tpu.train.step import make_packed_train_step as jax_packed_step
from dhr_tpu.train.step import make_train_step as jax_train_step
from dhr_tpu_torch.data import SamplingConfig
from dhr_tpu_torch.data.collate import collate_train, collate_train_packed
from dhr_tpu_torch.encode import plan_packing
from dhr_tpu_torch.models import (
    BiEncoder,
    EncoderConfig,
    RetrieverConfig,
    load_flax_params,
)
from dhr_tpu_torch.models.flax_params import flax_to_state_dict
from dhr_tpu_torch.models.transformer import dropout
from dhr_tpu_torch.train import step as tstep
from dhr_tpu_torch.train.driver import RunConfig, run_training
from dhr_tpu_torch.train.optimizer import OptimizerConfig
from dhr_tpu_torch.train.step import LossConfig

V, REMOVE, OUT = 1024, 64, 96
Q_LEN, P_LEN, N_PSG, B = 8, 16, 4, 2
ENC = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=64,
           hidden_dropout=0.0, attention_dropout=0.0)
FAMILIES = {
    "dhr": dict(model_type="dhr", add_pooler=True, dlr_out_dim=OUT),
    "dlr": dict(model_type="dlr", dlr_out_dim=OUT),
    "dense": dict(model_type="dense", add_pooler=True, pooling="mean"),
    "agg": dict(model_type="agg", add_pooler=True, agg_dim=48),
    "colbert": dict(model_type="colbert", projection_dim=16),
}
KEY_BIAS = "attention.key.bias"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(kw, **enc):
    e = dict(ENC, **enc)
    return (JaxRetrieverConfig(encoder=JaxEncoderConfig(dtype=jnp.float32,
                                                        **e), **kw),
            RetrieverConfig(encoder=EncoderConfig(dtype=torch.float32, **e),
                            **kw))


def flax_tree(jcfg, seed=0):
    """Flax init, every leaf perturbed by N(0, 0.05), as numpy."""
    x = {"input_ids": jnp.ones((2, 8), jnp.int32),
         "attention_mask": jnp.ones((2, 8), jnp.int32)}
    params = JaxBiEncoder(jcfg).init(jax.random.PRNGKey(seed), query=x,
                                     passage=x)["params"]
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng
                        .standard_normal(a.shape).astype(np.float32), params)


def examples(seed, n_queries=B, teacher=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_queries):
        q = rng.integers(REMOVE, V, rng.integers(3, Q_LEN - 1)).tolist()
        ps = [rng.integers(REMOVE, V, rng.integers(2, P_LEN // 2)).tolist()
              for _ in range(N_PSG)]
        s = (-rng.random(N_PSG - 1)).tolist() if teacher else None
        out.append((q, ps, s))
    return out


def plain_batch(seed, **kw):
    return collate_train(examples(seed, **kw), Q_LEN, P_LEN, cls_id=1,
                         sep_id=2)


def packed_batch(seed, **kw):
    ex = examples(seed, **kw)
    rows = plan_packing([len(p) + 2 for _, ps, _ in ex for p in ps], P_LEN, 4)
    return collate_train_packed(ex, Q_LEN, P_LEN, len(rows), 4, cls_id=1,
                                sep_id=2)


def _capture():
    """An optax transformation whose state is the last gradient tree."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return jax.tree.map(jnp.zeros_like, updates), updates

    return optax.GradientTransformation(init, update)


def jax_loss_and_grads(step_builder, jcfg, tree, batch, **kw):
    """(loss, {port name: grad}) of one reference step."""
    model = JaxBiEncoder(jcfg)
    step = step_builder(model, jcfg, JaxLossConfig(n_passages=N_PSG,
                                                   remove_dims=REMOVE), **kw)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, tree),
                                 _capture())
    jb = jax.tree.map(jnp.asarray, batch)
    new, metrics = jax.jit(step)(state, jb, jax.random.PRNGKey(0))
    grads = jax.tree.map(np.asarray, new.opt_state)
    return float(metrics["loss"]), flax_to_state_dict(grads)


def port_loss_and_grads(model, loss_fn):
    model.zero_grad(set_to_none=True)
    model.train()
    loss, _ = loss_fn()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def assert_grads(got, want, tol=1e-4, name=""):
    assert set(got) <= set(want)
    for key, w in want.items():
        if KEY_BIAS in key:
            continue
        g = got.get(key, torch.zeros_like(w))
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol * scale + 1e-9, f"{name} {key}: {err} vs {scale}"


def port_model(tcfg, tree):
    return load_flax_params(BiEncoder(tcfg), tree)


def tensors(batch):
    return tstep.to_device(batch, "cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_step_loss_and_grads_match_reference(family):
    jcfg, tcfg = configs(FAMILIES[family])
    tree = flax_tree(jcfg)
    batch = plain_batch(1)
    want_loss, want = jax_loss_and_grads(jax_train_step, jcfg, tree, batch)
    model = port_model(tcfg, tree)
    loss_cfg = LossConfig(n_passages=N_PSG, remove_dims=REMOVE)
    got_loss, got = port_loss_and_grads(model, lambda: tstep.plain_loss(
        model, tcfg, loss_cfg, tensors(batch)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert_grads(got, want, name=family)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_packed_step_matches_reference_and_plain(family):
    jcfg, tcfg = configs(FAMILIES[family])
    tree = flax_tree(jcfg, 2)
    seed = 3
    pbatch = packed_batch(seed)
    assert pbatch["packed_passage"]["input_ids"].shape[0] < B * N_PSG
    want_loss, want = jax_loss_and_grads(jax_packed_step, jcfg, tree, pbatch)
    model = port_model(tcfg, tree)
    loss_cfg = LossConfig(n_passages=N_PSG, remove_dims=REMOVE)
    got_loss, got = port_loss_and_grads(model, lambda: tstep.packed_loss(
        model, tcfg, loss_cfg, tensors(pbatch)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert_grads(got, want, name=f"{family} vs reference")
    plain_loss, plain = port_loss_and_grads(model, lambda: tstep.plain_loss(
        model, tcfg, loss_cfg, tensors(plain_batch(seed))))
    np.testing.assert_allclose(got_loss, plain_loss, rtol=1e-5)
    assert_grads(got, plain, name=f"{family} vs plain")


def test_packed_step_rejections():
    loss_cfg = LossConfig(n_passages=N_PSG)
    _, skip = configs(dict(model_type="agg", skip_mlm=True))
    with pytest.raises(ValueError, match="skip_mlm"):
        tstep.make_packed_train_step(None, skip, loss_cfg)
    _, dhr = configs(FAMILIES["dhr"])
    with pytest.raises(ValueError, match="TCT"):
        tstep.make_packed_train_step(
            None, dhr, dataclasses.replace(loss_cfg, use_tct_teacher=True))
    with pytest.raises(ValueError, match="dlr_out_dim"):
        tstep.make_packed_train_step(
            None, dataclasses.replace(dhr, dlr_out_dim=None), loss_cfg)
    model = BiEncoder(dhr)
    with pytest.raises(ValueError, match="colbert"):
        model.encode_tokens_packed(*(torch.ones(1, 4, dtype=torch.int32),)
                                   * 3)
    _, colbert = configs(FAMILIES["colbert"])
    with pytest.raises(ValueError, match="not colbert"):
        BiEncoder(colbert).encode_passages_packed(
            *(torch.ones(1, 4, dtype=torch.int32),) * 3,
            torch.zeros(1, 1, dtype=torch.int32))


@pytest.mark.parametrize("family", ["dhr", "dense", "colbert", "agg"])
def test_grad_cache_matches_plain_step(family):
    _, tcfg = configs(FAMILIES[family])
    jcfg, _ = configs(FAMILIES[family])
    tree = flax_tree(jcfg, 4)
    model = port_model(tcfg, tree)
    loss_cfg = LossConfig(n_passages=N_PSG, remove_dims=REMOVE)
    batch = tensors(plain_batch(5))
    want_loss, want = port_loss_and_grads(model, lambda: tstep.plain_loss(
        model, tcfg, loss_cfg, batch))
    model.zero_grad(set_to_none=True)
    model.train()
    loss = tstep.grad_cache_backward(model, tcfg, loss_cfg, batch, seed=0,
                                     step=0, q_chunks=2, p_chunks=4)
    got = {n: p.grad for n, p in model.named_parameters()
           if p.grad is not None}
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert_grads(got, want, name=family)


@pytest.mark.parametrize("q_chunks,p_chunks", [(3, 4), (2, 3)])
def test_grad_cache_refuses_chunks_that_do_not_divide_the_batch(q_chunks,
                                                                p_chunks):
    """2 queries x 4 passages: 3 query chunks, or 3 passage chunks of 8
    rows, are refused before anything is encoded, not trained on in
    part."""
    jcfg, tcfg = configs(FAMILIES["dhr"])
    model = port_model(tcfg, flax_tree(jcfg, 4))
    with pytest.raises(ValueError, match="equal chunks"):
        tstep.grad_cache_backward(
            model, tcfg, LossConfig(n_passages=N_PSG, remove_dims=REMOVE),
            tensors(plain_batch(5)), seed=0, step=0, q_chunks=q_chunks,
            p_chunks=p_chunks)
    assert all(p.grad is None for p in model.parameters())


def test_plain_step_marks_its_phases_in_order():
    """``make_train_step`` calls ``on_phase`` after each part, around the
    same loss and update as ``plain_loss`` then ``apply_gradients``."""
    from dhr_tpu_torch.train.state import TrainState

    jcfg, tcfg = configs(FAMILIES["dhr"])
    tree = flax_tree(jcfg, 11)
    loss_cfg = LossConfig(n_passages=N_PSG, remove_dims=REMOVE)
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    batch = plain_batch(12)
    marks = []
    model = port_model(tcfg, tree)
    state = TrainState.create(model, opt)
    loss = tstep.make_train_step(model, tcfg, loss_cfg,
                                 on_phase=marks.append)(state, batch, 0)
    assert marks == ["ready", "forward", "loss", "backward", "optimizer"]
    ref = port_model(tcfg, tree)
    ref_state = TrainState.create(ref, opt)
    want, _ = port_loss_and_grads(ref, lambda: tstep.plain_loss(
        ref, tcfg, loss_cfg, tensors(batch)))
    ref_state.apply_gradients()
    assert float(loss) == want and state.step == ref_state.step == 1
    for (n, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), n


def test_grad_cache_pass_two_reuses_pass_one_dropout(monkeypatch):
    """With dropout on, every chunk's re-encode (pass 2) gives exactly the
    reps of its no-grad encode (pass 1)."""
    _, tcfg = configs(FAMILIES["dhr"], hidden_dropout=0.3,
                      attention_dropout=0.3)
    model = port_model(tcfg, flax_tree(configs(FAMILIES["dhr"])[0], 6))
    seen = []
    real = tstep._encode

    def record(model, chunk, is_query, gen):
        r = real(model, chunk, is_query, gen)
        seen.append((is_query, torch.is_grad_enabled(),
                     {f: getattr(r, f).detach().clone()
                      for f in tstep.REP_FIELDS
                      if getattr(r, f) is not None}))
        return r

    monkeypatch.setattr(tstep, "_encode", record)
    model.train()
    tstep.grad_cache_backward(model, tcfg, LossConfig(n_passages=N_PSG,
                                                      remove_dims=REMOVE),
                              tensors(plain_batch(7)), seed=3, step=5,
                              q_chunks=2, p_chunks=4)
    first = [s for s in seen if not s[1]]
    second = [s for s in seen if s[1]]
    assert len(first) == len(second) == 6
    for (_, _, a), (_, _, b) in zip(first, second):
        for f in a:
            assert torch.equal(a[f], b[f]), f
    # and dropout did act: another step's masks give other reps
    with torch.no_grad():
        other = real(model, tensors(plain_batch(7))["query"], True,
                     tstep.generator(3, 6, 0, 0))
    assert not torch.equal(other.lexical[:1], first[0][2]["lexical"])


def _teacher(seed):
    jcfg, tcfg = configs(dict(model_type="colbert", add_pooler=True))
    tree = flax_tree(jcfg, seed)
    return jcfg, tree, port_model(tcfg, tree).eval()


def test_tct_teacher_in_plain_and_grad_cache_steps():
    jcfg, tcfg = configs(FAMILIES["dhr"])
    tree = flax_tree(jcfg, 8)
    t_jcfg, t_tree, teacher = _teacher(9)
    batch = plain_batch(10)
    t_model = JaxBiEncoder(t_jcfg)

    def teacher_apply(query, passage):
        return t_model.apply({"params": jax.tree.map(jnp.asarray, t_tree)},
                             query=query, passage=passage,
                             deterministic=True)

    model = JaxBiEncoder(jcfg)
    jstep = jax_train_step(model, jcfg, JaxLossConfig(
        n_passages=N_PSG, remove_dims=REMOVE, use_tct_teacher=True),
        teacher_apply=teacher_apply)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, tree), _capture())
    _, metrics = jstep(state, jax.tree.map(jnp.asarray, batch),
                       jax.random.PRNGKey(0))
    port = port_model(tcfg, tree)
    loss_cfg = LossConfig(n_passages=N_PSG, remove_dims=REMOVE,
                          use_tct_teacher=True)
    tb = tensors(batch)
    loss, plain = port_loss_and_grads(port, lambda: tstep.plain_loss(
        port, tcfg, loss_cfg, tb, teacher=teacher))
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)
    no_tct, _ = port_loss_and_grads(port, lambda: tstep.plain_loss(
        port, tcfg, dataclasses.replace(loss_cfg, use_tct_teacher=False),
        tb, teacher=teacher))
    assert abs(no_tct - loss) > 1e-3
    port.zero_grad(set_to_none=True)
    gc_loss = tstep.grad_cache_backward(port, tcfg, loss_cfg, tb, 0, 0, 2, 4,
                                        teacher=teacher)
    np.testing.assert_allclose(float(gc_loss), loss, rtol=1e-5)
    assert_grads({n: p.grad for n, p in port.named_parameters()
                  if p.grad is not None}, plain, name="tct grad-cache")
    assert all(p.grad is None for p in teacher.parameters())


def test_dropout_acts_in_training_mode_only_and_follows_its_generator():
    x = torch.ones(4096)
    a = dropout(x, 0.25, True, torch.Generator().manual_seed(1))
    b = dropout(x, 0.25, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert 0.2 < float((a == 0).float().mean()) < 0.3
    assert torch.equal(dropout(x, 0.25, False, None), x)
    _, tcfg = configs(FAMILIES["dhr"], hidden_dropout=0.1,
                      attention_dropout=0.1)
    model = BiEncoder(tcfg)
    batch = tensors(plain_batch(11))["query"]
    with torch.no_grad():
        model.eval()
        e1 = model.encoder("query")(**batch)
        e2 = model.encoder("query")(**batch, gen=torch.Generator()
                                    .manual_seed(0))
        model.train()
        t1 = model.encoder("query")(**batch, gen=torch.Generator()
                                    .manual_seed(0))
        t2 = model.encoder("query")(**batch, gen=torch.Generator()
                                    .manual_seed(0))
    assert torch.equal(e1.lexical, e2.lexical)
    assert torch.equal(t1.lexical, t2.lexical)
    assert not torch.equal(t1.lexical, e1.lexical)


def _groups(n=32, seed=12):
    rng = np.random.default_rng(seed)
    return [{"query": rng.integers(REMOVE, V, 5).tolist(),
             "positives": [rng.integers(REMOVE, V, 9).tolist()],
             "negatives": [rng.integers(REMOVE, V, rng.integers(6, 11))
                           .tolist() for _ in range(5)]}
            for _ in range(n)]


def _losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def test_adamw_trajectory_matches_reference_run_training(tmp_path):
    jcfg, tcfg = configs(FAMILIES["dhr"])
    tree = flax_tree(jcfg, 13)
    groups = _groups()
    opt = dict(learning_rate=2e-3, warmup_steps=2, total_steps=8,
               freeze_word_embeddings=True)
    run = dict(batch_size=4, log_steps=1, save_steps=100, seed=5)
    samp = dict(n_passages=N_PSG, q_max_len=Q_LEN, p_max_len=P_LEN, seed=5,
                cls_id=1, sep_id=2)
    jstate = jax_run_training(
        jcfg, JaxLossConfig(n_passages=N_PSG, remove_dims=REMOVE),
        JaxOptimizerConfig(**opt),
        JaxRunConfig(**run, rng_impl="threefry2x32",
                     metrics_path=str(tmp_path / "j.jsonl")),
        groups, JaxSamplingConfig(**samp), init_params=tree,
        devices=jax.devices()[:1])
    state = run_training(
        tcfg, LossConfig(n_passages=N_PSG, remove_dims=REMOVE),
        OptimizerConfig(**opt),
        RunConfig(**run, metrics_path=str(tmp_path / "t.jsonl")),
        groups, SamplingConfig(**samp), model=port_model(tcfg, tree),
        device="cpu")
    assert state.step == 8
    got, want = _losses(tmp_path / "t.jsonl"), _losses(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 8
    rel = np.abs(np.subtract(got, want)) / np.abs(want)
    assert rel.max() < 1e-4, rel
    init = flax_to_state_dict(tree)
    final = flax_to_state_dict(jax.tree.map(np.asarray, jax.device_get(
        jstate.params)))
    moved = 0
    for name, p in state.model.named_parameters():
        if KEY_BIAS in name:
            continue
        movement = float((final[name] - init[name]).abs().max())
        err = float((p.detach() - final[name]).abs().max())
        if movement == 0.0:  # frozen or unused: both unchanged
            assert err == 0.0, name
            continue
        moved += 1
        assert err <= 0.05 * movement, (name, err, movement)
    assert moved > 20
