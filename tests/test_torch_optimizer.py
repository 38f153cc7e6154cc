"""The port's AdamW against dhr_tpu's optax optimizer.

- the learning-rate schedule for steps 0..30, warmup 0 and 5;
- the decayed and frozen parameter sets against ``decay_mask`` /
  ``frozen_word_embedding_mask``, mapped by name;
- AdamW updates from fixed gradient trees against ``make_optimizer``'s,
  parameters to 1e-6 relative and each update to 1e-4 of its scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.models.retrievers import RetrieverConfig as JaxRetrieverConfig
from dhr_tpu.models.transformer import EncoderConfig as JaxEncoderConfig
from dhr_tpu.train import optimizer as jopt
from dhr_tpu_torch.models import (
    BiEncoder,
    EncoderConfig,
    RetrieverConfig,
    load_flax_params,
)
from dhr_tpu_torch.models.flax_params import flax_to_state_dict
from dhr_tpu_torch.train import optimizer as topt
from dhr_tpu_torch.train.state import TrainState

ENC = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position_embeddings=64,
           hidden_dropout=0.0, attention_dropout=0.0)
FAMILIES = {
    "dhr": dict(model_type="dhr", add_pooler=True, dlr_out_dim=96),
    "dense": dict(model_type="dense", add_pooler=True),
    "colbert": dict(model_type="colbert", projection_dim=16),
    "dhr_untied_bert": dict(model_type="dhr", dlr_out_dim=96,
                            untie_encoder=True),
}


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
    x = {"input_ids": jnp.ones((2, 8), jnp.int32),
         "attention_mask": jnp.ones((2, 8), jnp.int32)}
    params = JaxBiEncoder(jcfg).init(jax.random.PRNGKey(seed), query=x,
                                     passage=x)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng
                        .standard_normal(a.shape).astype(np.float32), params)


def flat_paths(tree):
    """{'a/b/c': leaf} of a nested dict tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    return out


@pytest.mark.parametrize("warmup", [0, 5])
def test_schedule_matches_optax(warmup):
    cfg = topt.OptimizerConfig(learning_rate=7e-6, warmup_steps=warmup,
                               total_steps=20)
    want = jopt.linear_warmup_decay(jopt.OptimizerConfig(
        learning_rate=7e-6, warmup_steps=warmup, total_steps=20))
    got = topt.linear_warmup_decay(cfg)
    for t in range(31):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-6,
                                   atol=1e-13, err_msg=str(t))
    if warmup:
        assert got(0) == 0.0
    assert got(30) == 0.0


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_decay_and_frozen_masks_match_by_name(case):
    kw = FAMILIES[case]
    enc = {"type_vocab_size": 2} if "bert" in case else {}
    jcfg, tcfg = configs(kw, **enc)
    tree = flax_tree(jcfg)
    model = BiEncoder(tcfg)
    names = dict(model.named_parameters())
    paths = {topt.flax_path(n): n for n in names}
    want_decay = flat_paths(jopt.decay_mask(tree))
    want_frozen = flat_paths(jopt.frozen_word_embedding_mask(tree))
    assert set(paths) == set(want_decay)
    got_decay = topt.decay_mask(model)
    got_frozen = topt.frozen_word_embedding_mask(model)
    for path, name in paths.items():
        assert got_decay[name] == bool(want_decay[path]), path
        assert got_frozen[name] == bool(want_frozen[path]), path
    assert any(got_frozen.values()) and any(got_decay.values())
    assert not all(got_decay.values())


@pytest.mark.parametrize("freeze,clip", [(False, None), (True, 0.5)])
def test_adamw_updates_match_optax(freeze, clip):
    jcfg, tcfg = configs(FAMILIES["dhr"])
    tree = flax_tree(jcfg, 1)
    cfg = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10,
               weight_decay=0.1, max_grad_norm=clip,
               freeze_word_embeddings=freeze)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**cfg), tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(jparams)
    model = load_flax_params(BiEncoder(tcfg), tree)
    state = TrainState.create(model, topt.OptimizerConfig(**cfg))
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                             .astype(np.float32) * 0.01, tree)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in flax_to_state_dict(grads).items():
            p = dict(model.named_parameters())[name]
            if p.requires_grad:
                p.grad = g.clone()
        state.apply_gradients()
        want = flax_to_state_dict(jax.tree.map(np.asarray, jparams))
        for name, p in model.named_parameters():
            got = p.detach().numpy()
            np.testing.assert_allclose(got, want[name].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
            upd, upd_want = got - before[name].numpy(), \
                want[name].numpy() - before[name].numpy()
            scale = max(float(np.abs(upd_want).max()), 1e-12)
            assert np.abs(upd - upd_want).max() <= 1e-4 * scale + 2e-7, name
            if freeze and "word" in topt.flax_path(name):
                assert not p.requires_grad and np.array_equal(
                    got, before[name].numpy())
    assert state.step == 3


def test_warmup_first_update_is_a_no_op():
    _, tcfg = configs(FAMILIES["dense"])
    model = BiEncoder(tcfg)
    state = TrainState.create(model, topt.OptimizerConfig(
        learning_rate=1e-3, warmup_steps=2, total_steps=10))
    before = [p.detach().clone() for p in model.parameters()]
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    state.apply_gradients()
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    state.apply_gradients()
    assert not all(torch.equal(a, b)
                   for a, b in zip(before, model.parameters()))


def test_clip_is_global_and_leaves_small_norms():
    a = torch.nn.Parameter(torch.zeros(3))
    b = torch.nn.Parameter(torch.zeros(4))
    a.grad, b.grad = torch.full((3,), 3.0), torch.full((4,), 4.0)
    norm = topt.clip_grad_norm([a, b], 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(27 + 64), rtol=1e-6)
    np.testing.assert_allclose(
        float(torch.cat([a.grad, b.grad]).norm()), 1.0, rtol=1e-6)
    before = a.grad.clone()
    topt.clip_grad_norm([a, b], 10.0)
    assert torch.equal(a.grad, before)
