"""The plain references against hand-worked tiny cases."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import benchmarks.tests.portbench_util  # noqa: F401  (the checkout's root)
from benchmarks.reference.dhr_model import Math, densify, dhr_reps, encoder
from benchmarks.reference.gip import gip_all_rows, topk_rows
from benchmarks.reference.train import (decayed, densify_grad, dhr_loss,
                                        leaf_gap, lr_at, train_steps)


def test_gip_by_hand():
    # 2 lexical dims + 1 CLS dim, 3 rows; scales 0.5, 1, 2
    v = torch.tensor([[2, 4, 1], [2, -4, 3], [0, 4, -1]], dtype=torch.int8)
    f = torch.tensor([[1, 0], [2, 0], [1, 5]], dtype=torch.int8)
    scales = torch.tensor([0.5, 1.0, 2.0])
    qv = torch.tensor([[1.0, 2.0, 3.0]])
    qf = torch.tensor([[1, 0]], dtype=torch.int32)
    # row 0: 1*(2*.5) + 2*(4*1) + 3*(1*2) = 1 + 8 + 6 = 15
    # row 1: fold 2 != 1 -> 0; 2*(-4) = -8; 3*(3*2) = 18 -> 10
    # row 2: 1*0 + fold 5 != 0 -> 0; 3*(-1*2) = -6 -> -6
    s = gip_all_rows(qv, qf, v, f, scales, lex=2, block_rows=2)
    assert s.tolist() == [[15.0, 10.0, -6.0]]
    vals, rows = topk_rows(s, 2)
    assert rows.tolist() == [[0, 1]] and vals.tolist() == [[15.0, 10.0]]
    low = gip_all_rows(qv, qf, v, f, scales, lex=2, precision="bf16")
    assert low.tolist() == [[15.0, 10.0, -6.0]]   # exact in bf16 too


def test_densify_by_hand():
    # vocab 2 + 2 x 3: remove 2, out_dim 3, folds k = 2
    lex = torch.tensor([[9.0, 9.0, 1.0, 5.0, 2.0, 1.0, 4.0, 3.0]])
    vals, folds = densify(lex, 3, 2)
    assert vals.tolist() == [[1.0, 5.0, 3.0]]
    assert folds.tolist() == [[0, 0, 1]]           # ties to the first fold
    v2, f2 = densify_grad(lex, 3, 2)
    assert v2.tolist() == vals.tolist() and f2.tolist() == folds.tolist()


def _tiny_dims(layers=1):
    return {"layers": layers, "hidden": 4, "heads": 2, "ffn": 8, "vocab": 8,
            "positions": 6, "types": 0, "proj": 2, "eps": 1e-12,
            "init": 0.02}


def _zero_weights(d):
    from benchmarks.gen.weights import shapes

    W = {n: torch.zeros(s) for n, s in shapes(d)}
    for n in W:
        if n.endswith(("ln.w", "ln1.w", "ln2.w")):
            W[n] = torch.ones_like(W[n])
    return W


def test_encoder_with_zero_layers_is_layer_norms():
    """With every projection zero a layer is LayerNorm(LayerNorm(x)), and
    the hidden states are the normalized embeddings."""
    d = _tiny_dims()
    W = _zero_weights(d)
    W["emb.word"] = torch.arange(32, dtype=torch.float32).view(8, 4) % 5
    W["emb.pos"] = torch.ones(6, 4)
    ids = torch.tensor([[1, 2, 3]])
    mask = torch.ones(1, 3, dtype=torch.long)
    h = encoder(W, d, ids, mask, Math())
    x = W["emb.word"][ids] + 1.0
    want = F.layer_norm(x, (4,), eps=1e-12)
    assert torch.allclose(h, want, atol=1e-5)


def test_dhr_head_by_hand():
    """Zero layers and head: uniform MLM softmax 1/V; the term weight is its
    bias; the lexical rep is bias / V at every vocab entry; the CLS rep is
    the projection's bias."""
    d = _tiny_dims()
    W = _zero_weights(d)
    W["tw.b"] = torch.tensor([0.5])
    W["pool.b"] = torch.tensor([1.0, -2.0])
    ids = torch.tensor([[1, 2, 3], [4, 5, 0]])
    mask = torch.tensor([[1, 1, 1], [1, 1, 0]])
    lex, sem = dhr_reps(W, d, ids, mask, Math())
    assert torch.allclose(lex, torch.full((2, 8), 0.5 / 8))
    assert sem.tolist() == [[1.0, -2.0], [1.0, -2.0]]


def test_fp8_control_rounds_products():
    m = Math("fp8")
    a = torch.tensor([[1.0, 1.0 / 3.0]])
    b = torch.tensor([[1.0], [1.0]])
    assert m.mm(a, b).item() != (a @ b).item()
    assert abs(m.mm(a, b).item() - 4.0 / 3.0) < 0.05


def test_schedule_and_decay_mask():
    opt = {"learning_rate": 1.0, "warmup_steps": 2, "total_steps": 6}
    assert [lr_at(opt, t) for t in range(7)] == [0.0, 0.5, 1.0, 0.75, 0.5,
                                                0.25, 0.0]
    assert decayed("l0.q.w") and decayed("emb.pos") and decayed("pool.w")
    assert not decayed("l0.ln1.w") and not decayed("emb.ln.w")
    assert not decayed("l0.q.b") and not decayed("mlm.bias")


def test_loss_by_hand():
    """One query, two passages, zero model: equal scores, loss ln 2."""
    d = _tiny_dims()
    W = _zero_weights(d)
    head = {"dlr_out_dim": 3, "remove_dims": 2}
    batch = {"q_ids": torch.tensor([[1, 2]]), "q_mask": torch.ones(1, 2),
             "p_ids": torch.tensor([[1, 2], [3, 4]]),
             "p_mask": torch.ones(2, 2)}
    loss = dhr_loss(W, d, head, batch, 2, Math())
    assert math.isclose(float(loss), math.log(2.0), rel_tol=1e-6)


def test_adamw_first_step_by_hand():
    """One step: the update is lr * sign(g) (Adam's first step, eps aside)
    less the decay, and the first gradient is the clipped one."""
    d = _tiny_dims()
    from benchmarks.gen.weights import make_weights

    cfg = {"model": {"num_hidden_layers": 1, "hidden_size": 4,
                     "num_attention_heads": 2, "intermediate_size": 8,
                     "vocab_size": 8, "max_position_embeddings": 6,
                     "layer_norm_eps": 1e-12, "initializer_range": 0.5},
           "head": {"projection_dim": 2}}
    W = make_weights(cfg, 3, "cpu")
    head = {"dlr_out_dim": 3, "remove_dims": 2}
    batch = {"q_ids": torch.tensor([[1, 2, 3]]), "q_mask": torch.ones(1, 3),
             "p_ids": torch.tensor([[1, 2, 3], [3, 4, 5]]),
             "p_mask": torch.ones(2, 3)}
    opt = {"learning_rate": 1e-3, "warmup_steps": 0, "total_steps": 10,
           "weight_decay": 0.1, "b1": 0.9, "b2": 0.999, "eps": 1e-12,
           "max_grad_norm": 1e-3, "freeze_word_embeddings": True}
    losses, first, after = train_steps(W, d, head, opt, [batch], 2)
    total = math.sqrt(sum(float(g.square().sum()) for g in first.values()))
    assert math.isclose(total, 1e-3, rel_tol=1e-4)   # clipped to the max
    assert "emb.word" not in first
    assert torch.equal(after["emb.word"], W["emb.word"])
    g, w0 = first["pool.w"], W["pool.w"]
    want = w0 * (1 - 1e-3 * 0.1) - 1e-3 * torch.sign(g)
    assert torch.allclose(after["pool.w"], want, atol=1e-7)
    assert leaf_gap(first, first) == 0.0


def test_dropout_by_hand():
    """An element is kept where its draw reaches p and then scaled by 1 /
    (1 - p); the draws are the generator's next, in the tensor's shape."""
    from benchmarks.reference.dhr_model import Dropout
    from benchmarks.reference.train import step_generator

    x = torch.full((2, 3), 0.9)
    drop = Dropout(0.5, 0.25, step_generator(5, 2, "cpu"))
    draw = torch.rand((2, 3), generator=step_generator(5, 2, "cpu"))
    got = drop(x, 0.5)
    assert torch.equal(got, torch.where(draw >= 0.5, torch.tensor(1.8), 0.0))
    assert torch.equal(drop(x, 0.0), x)
    assert step_generator(5, 2, "cpu").initial_seed() \
        != step_generator(5, 3, "cpu").initial_seed()
