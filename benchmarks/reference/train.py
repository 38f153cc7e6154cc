"""Train steps of the tied DHR bi-encoder in plain PyTorch: the in-batch
listwise loss over densified GIP plus CLS scores, autograd, global-norm
clipping and AdamW, in f32 (or the fp8 control's products).

The loss of a batch of ``B`` queries with ``n`` passages each (the positive
first) is the softmax cross-entropy of each query's scores over all ``B *
n`` passages at its positive's column, averaged over the queries.  A
query-passage score is ``sum_j [qf_j == pf_j] qv_j pv_j + qs . ps``, the
densified lexical reps' GIP (the max over folds carries the gradient, the
fold choice none) plus the CLS reps' inner product.

Dropout follows the stream that the configuration's train step states:
step ``t``'s masks come from one generator on the batch's device, seeded
from ``(seed, t)`` through numpy's ``SeedSequence`` (two 32-bit words
``a, b`` give the seed ``a << 31 | b >> 1``), drawn at each site as
:class:`~benchmarks.reference.dhr_model.Dropout` says, queries before
passages.  Both sides draw the same masks from the seed; neither reads the
other's.

AdamW is torch's (and optax's) decoupled form: ``p *= 1 - lr * wd`` where
decayed, ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr /
(1 - b1^t) * m / (sqrt(v / (1 - b2^t)) + eps)``; the learning rate follows
a linear warmup then a linear decay to ``total_steps``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.reference.dhr_model import Dropout, Math, dhr_reps


def decayed(name: str) -> bool:
    """Weight decay applies to matrices and embeddings, not to LayerNorm
    parameters or biases."""
    return name.endswith(".w") and ".ln" not in name \
        and not name.startswith("emb.ln") or name in ("emb.pos", "emb.type")


def lr_at(opt: dict, t: int) -> float:
    warm = opt["warmup_steps"]
    lr = opt["learning_rate"]
    if t < warm:
        return lr * t / max(warm, 1)
    decay = max(opt["total_steps"] - warm, 1)
    return lr * (1.0 - min(t - warm, decay) / decay)


def step_generator(seed: int, t: int, device) -> torch.Generator:
    """Step ``t``'s dropout generator for the run seeded ``seed``."""
    a, b = np.random.SeedSequence([seed, t]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(a) << 31 | int(b) >> 1)
    return g


def densify_grad(lexical: torch.Tensor, out_dim: int, remove_dims: int):
    B, V = lexical.shape
    k = (V - remove_dims) // out_dim
    folded = lexical[:, remove_dims:remove_dims + k * out_dim].reshape(
        B, k, out_dim)
    values = folded.amax(dim=1)
    folds = (folded.detach() == values.detach()[:, None, :]).int().argmax(1)
    return values, folds


def dhr_loss(P: dict, d: dict, head: dict, batch: dict, n_passages: int,
             m: Math, drop: Dropout | None = None) -> torch.Tensor:
    ql, qs = dhr_reps(P, d, batch["q_ids"], batch["q_mask"], m, drop)
    pl, ps = dhr_reps(P, d, batch["p_ids"], batch["p_mask"], m, drop)
    out, rm = head["dlr_out_dim"], head["remove_dims"]
    qv, qf = densify_grad(ql, out, rm)
    pv, pf = densify_grad(pl, out, rm)
    gate = qf[:, None, :] == pf[None, :, :]
    lex = torch.where(gate, qv[:, None, :] * pv[None, :, :], 0.0).sum(-1)
    scores = lex + m.mm(qs, ps.T)
    labels = torch.arange(scores.shape[0], device=scores.device) * n_passages
    return F.cross_entropy(scores, labels)


def train_steps(W0: dict, d: dict, head: dict, opt: dict, batches: list,
                n_passages: int, precision: str = "f32",
                dropout: tuple[float, float, int] | None = None):
    """Steps from ``W0`` over ``batches``: ``(losses, first clipped
    gradient by name, parameters after the last step)``.  The word
    embedding table stays frozen.  ``dropout``: ``(hidden rate, attention
    rate, seed)`` of the steps' dropout stream (None: no dropout)."""
    m = Math(precision)
    P = {k: v.detach().clone() for k, v in W0.items()}
    trained = [k for k in P if not (opt["freeze_word_embeddings"]
                                    and k == "emb.word")]
    for k in trained:
        P[k].requires_grad_(True)
    mom = {k: torch.zeros_like(P[k]) for k in trained}
    vel = {k: torch.zeros_like(P[k]) for k in trained}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first = [], None
    for t, batch in enumerate(batches):
        drop = None
        if dropout is not None:
            hidden, attention, seed = dropout
            drop = Dropout(hidden, attention, step_generator(
                seed, t, batch["q_ids"].device))
        loss = dhr_loss(P, d, head, batch, n_passages, m, drop)
        grads = torch.autograd.grad(loss, [P[k] for k in trained])
        losses.append(float(loss.detach()))
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads))
        clip = opt.get("max_grad_norm")
        scale = 1.0 if not clip or norm < clip else clip / norm
        grads = [g * scale for g in grads]
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(trained, grads)}
        lr = lr_at(opt, t)
        n = t + 1
        with torch.no_grad():
            for k, g in zip(trained, grads):
                p = P[k]
                if decayed(k):
                    p.mul_(1.0 - lr * wd)
                mom[k].mul_(b1).add_(g, alpha=1 - b1)
                vel[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vel[k].sqrt() / math.sqrt(1 - b2 ** n)).add_(eps)
                p.addcdiv_(mom[k], denom, value=-lr / (1 - b1 ** n))
        del grads, loss
    return losses, first, {k: P[k].detach() for k in P}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the norms of two sets of tensors: the
    distance of the norms over the larger of the reference leaf's norm and
    the median leaf's norm."""
    names = [k for k in ref if keep is None or keep(k)]
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in names}
    med = sorted(rn.values())[len(rn) // 2]
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names)
