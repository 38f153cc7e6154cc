"""Training the dual encoder: the plain train step (``make_train_step``) fed
by the port's ``TrainLoader`` thread, step after step, as
``train/driver.py`` runs it (losses read once per log interval, no
checkpoint in the window).

Set-up makes the weights on the device from the seed and hands them to the
port's ``BiEncoder``, draws the train groups (a query, one positive and
``n_passages - 1`` negatives, every passage distinct), builds the
``TrainState`` and runs the first three steps through the window's own
call and feed.  They are the warm-up and the steps the reference follows:
the program's loss of each, its first gradient as AdamW holds it after
step 1 (``exp_avg / (1 - b1)``) and its parameters after step 3 are kept
on the host.  The window then trains on with the same state.

Dropout is on, at the configuration's rates.  The port draws step ``t``'s
masks from a generator seeded from ``(seed, t)``; the reference draws the
same masks from the same seed by that stated rule (``reference.train``),
so the two steps differ by rounding alone.

Correctness, against three f32 reference steps from the benchmark's
weights on the same groups (``reference.train``):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the program's and
  the reference's first gradient, over the larger of the reference leaf's
  norm and the median leaf's;
- ``change_gap``: the same of each leaf's change over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone);
- ``batch_mismatch``: the rows of the three steps' batches, as the loader
  fed them, whose tokens are not those the groups give by the stated
  sampling order, row for row (an exact comparison).
"""

from __future__ import annotations

import random
import time

import numpy as np

CHECKED_STEPS = 3


def make_groups(tr: dict, seed: int, vocab: int):
    """``(groups, q_lens, p_lens)``: inline train groups whose passages are
    all distinct draws."""
    from benchmarks.gen.tokens import rng, token_lists

    n, k = int(tr["groups"]), int(tr["n_passages"])
    r = rng(seed, 0x78A1)
    q, q_lens = token_lists(tr["query_tokens"], n, r, vocab)
    p, p_lens = token_lists(tr["passage_tokens"], n * k, r, vocab)
    groups = [{"query": q[i], "positives": [p[i * k]],
               "negatives": p[i * k + 1:(i + 1) * k]} for i in range(n)]
    return groups, q_lens, p_lens.reshape(n, k)


def loader_seed(seed: int) -> int:
    return int(seed) % (1 << 31)


def dropout_stream(cfg: dict, lseed: int) -> tuple[float, float, int]:
    """The reference's ``(hidden rate, attention rate, seed)``: the
    configuration's rates and the seed the window's step is called with."""
    m = cfg["model"]
    return (float(m["hidden_dropout_prob"]),
            float(m["attention_probs_dropout_prob"]), lseed)


def run(ctx):
    torch = ctx.torch
    dev = ctx.device
    from benchmarks import roofline
    from benchmarks.gen.weights import make_weights, model_dims
    from benchmarks.harness import import_program, repeat
    from benchmarks.port_model import (port_bi_encoder, port_names,
                                       retriever_config)

    cfg, tr = ctx.config, ctx.traffic
    tcfg, m = cfg["train"], cfg["model"]
    torch.ones(1, device=dev)
    ctx.setup_part("cuda_start")

    weights = make_weights(cfg, ctx.seed, dev)
    ctx.setup_part("weight_generation")
    rcfg = retriever_config(cfg, tcfg["compute_dtype"])
    model = port_bi_encoder(cfg, weights, rcfg, dev)
    ctx.setup_part("model_load")

    groups, q_lens, p_lens = make_groups(tr, ctx.seed, m["vocab_size"])
    ctx.setup_part("traffic_generation")

    sampling = import_program("dhr_tpu_torch.data.sampling")
    loader_mod = import_program("dhr_tpu_torch.data.loader")
    step_mod = import_program("dhr_tpu_torch.train.step")
    state_mod = import_program("dhr_tpu_torch.train.state")
    optim = import_program("dhr_tpu_torch.train.optimizer")
    B, k = int(tcfg["batch_size"]), int(tcfg["n_passages"])
    lseed = loader_seed(ctx.seed)
    loader = loader_mod.TrainLoader(
        groups, sampling.SamplingConfig(
            n_passages=k, q_max_len=int(tcfg["q_max_len"]),
            p_max_len=int(tcfg["p_max_len"]), seed=lseed,
            cls_id=m["cls_token_id"], sep_id=m["sep_token_id"]),
        batch_size=B)
    opt = optim.OptimizerConfig(
        learning_rate=tcfg["learning_rate"],
        warmup_steps=tcfg["warmup_steps"], total_steps=tcfg["total_steps"],
        weight_decay=tcfg["weight_decay"], b1=tcfg["b1"], b2=tcfg["b2"],
        eps=tcfg["eps"], max_grad_norm=tcfg["max_grad_norm"],
        freeze_word_embeddings=tcfg["freeze_word_embeddings"])
    state = state_mod.TrainState.create(model, opt)
    step_fn = step_mod.make_train_step(
        model, rcfg, step_mod.LossConfig(
            n_passages=k, remove_dims=int(cfg["head"]["remove_dims"])))

    def feed():
        epoch = 0
        while True:
            yield from loader.epoch(epoch)
            epoch += 1

    batches = feed()
    names = {v: kk for kk, v in port_names(cfg).items()}
    params = dict(model.named_parameters())
    losses, first_grad, fed = [], None, []
    for t in range(CHECKED_STEPS):
        batch = next(batches)
        fed.append({side: {k: np.array(batch[side][k]) for k in
                           ("input_ids", "attention_mask")}
                    for side in ("query", "passage")})
        losses.append(step_fn(state, batch, lseed))
        if t == 0:
            b1 = opt.b1
            first_grad = {
                ours: (state.optimizer.state[params[port]]["exp_avg"]
                       / (1 - b1)).to("cpu", copy=True)
                for ours, port in names.items()
                if params[port] in state.optimizer.state}
    after = {ours: params[port].detach().to("cpu", copy=True)
             for ours, port in names.items()}
    prog_losses = [float(x) for x in losses]
    ctx.setup_part("warmup_and_checked_steps")

    host_ms, wait_ms, masks = [], [], []
    steps, losses = 0, []
    log_steps = int(tr["log_steps"])
    with ctx.window() as t0:
        while True:
            w0 = time.perf_counter()
            batch = next(batches)
            h0 = time.perf_counter()
            losses.append(step_fn(state, batch, lseed))
            host_ms.append((time.perf_counter() - h0) * 1e3)
            wait_ms.append((h0 - w0) * 1e3)
            masks.append((batch["query"]["attention_mask"],
                          batch["passage"]["attention_mask"]))
            steps += 1
            if steps % log_steps == 0:
                torch.stack(losses).float().cpu()   # the driver's one read
                losses.clear()
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        if losses:
            torch.stack(losses).float().cpu()
    ctx.work["window_calls"] = steps
    ctx.traced(repeat(lambda: step_fn(state, next(batches), lseed)))
    ctx.read_peak()
    batches.close()
    d = model_dims(cfg)
    ctx.work["flops"] = sum(roofline.train_step_flops(
        qm.sum(axis=1), pm.sum(axis=1), d) for qm, pm in masks)
    ctx.work["host_ms"] = host_ms
    ctx.work["wait_ms"] = wait_ms
    print(f"# window host_ms_mean {sum(host_ms) / len(host_ms)!r} "
          f"wait_ms_mean {sum(wait_ms) / len(wait_ms)!r} "
          f"wait_ms_max {max(wait_ms)!r}", file=ctx.out)
    del state, step_fn, model, params
    ctx.free()

    ctx.compare("batch_mismatch", fed_mismatch(ctx, groups, lseed, fed))
    gaps = reference_gaps(ctx, weights, d, groups, prog_losses, first_grad,
                          after, lseed)
    for name, v in gaps.items():
        ctx.compare(name, v)
    done = steps * B * k
    return {"e2e": {"train_pps": done / ctx.window_s},
            "attempted": done, "failed": 0}


def control(ctx, fault: str | None = None) -> None:
    """The control: three reference steps with fp8 products, one step
    below the configuration's bf16, put in the program's place and compared
    as the program's steps are.  ``fault``: instead, the f32 reference
    with a fault planted (``half_batch``: the loss over the first half of
    the queries and their passages; ``token_altered``: the first token of
    each query and passage changed where the batch is made)."""
    from benchmarks.gen.weights import make_weights, model_dims
    from benchmarks.reference.train import train_steps

    cfg, tcfg = ctx.config, ctx.config["train"]
    weights = make_weights(cfg, ctx.seed, ctx.device)
    d = model_dims(cfg)
    groups, _, _ = make_groups(ctx.traffic, ctx.seed,
                               cfg["model"]["vocab_size"])
    lseed = loader_seed(ctx.seed)
    batches = checked_batches(ctx, groups, lseed)
    n = int(tcfg["n_passages"])
    if fault == "half_batch":
        h = int(tcfg["batch_size"]) // 2
        batches = [{k: v[:h] if k.startswith("q") else v[:h * n]
                    for k, v in b.items()} for b in batches]
    elif fault == "token_altered":
        for b in batches:
            for k in ("q_ids", "p_ids"):
                b[k][:, 1] = (b[k][:, 1] + 1) % 1000 + 1000
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    losses, first, after = train_steps(
        weights, d, cfg["head"], tcfg, batches, n,
        "fp8" if fault is None else "f32", dropout_stream(cfg, lseed))
    gaps = reference_gaps(ctx, weights, d, groups, losses,
                          {k: v.cpu() for k, v in first.items()},
                          {k: v.cpu() for k, v in after.items()}, lseed)
    for name, v in gaps.items():
        ctx.compare(name, v)


def group_passages(groups, item: int, lseed: int, epoch: int = 0) -> list:
    """Group ``item``'s passages in the order a train batch holds them, by
    the sampling rule of the reference trainer (Tevatron's, which the
    loader states): the positive at ``(item + seed + epoch)`` modulo their
    count, then ``n_passages - 1`` negatives from the list shuffled by
    ``random.Random(item + seed)``, taken from ``epoch * (n_passages - 1)``
    on, cyclically.  The order matters once dropout draws a mask per row."""
    g = groups[item]
    pos = g["positives"][(item + lseed + epoch) % len(g["positives"])]
    pool = list(g["negatives"])
    random.Random(item + lseed).shuffle(pool)
    n = len(pool)
    off = epoch * n % n
    return [pos, *(pool * 2)[off:off + n]]


def batch_items(groups, lseed: int, B: int, steps: int) -> list[list[int]]:
    """The groups of epoch 0's first ``steps`` batches: a permutation drawn
    with ``np.random.default_rng(seed + epoch)``, ``B`` groups a step."""
    order = np.random.default_rng(lseed).permutation(len(groups))
    return [[int(i) for i in order[b * B:(b + 1) * B]] for b in range(steps)]


def checked_batches(ctx, groups, lseed: int, steps: int = CHECKED_STEPS):
    """The first ``steps`` batches of epoch 0, worked out again from the
    groups (:func:`batch_items`, :func:`group_passages`), padded to the
    configuration's lengths."""
    from benchmarks.drivers.encode_corpus import collate

    torch = ctx.torch
    tcfg, m = ctx.config["train"], ctx.config["model"]
    out = []
    for items in batch_items(groups, lseed, int(tcfg["batch_size"]), steps):
        q = [groups[i]["query"] for i in items]
        p = [x for i in items for x in group_passages(groups, i, lseed)]
        qi, qm = collate(q, m["cls_token_id"], m["sep_token_id"],
                         int(tcfg["q_max_len"]))
        pi, pm = collate(p, m["cls_token_id"], m["sep_token_id"],
                         int(tcfg["p_max_len"]))
        out.append({k: torch.as_tensor(v, device=ctx.device) for k, v in
                    (("q_ids", qi), ("q_mask", qm), ("p_ids", pi),
                     ("p_mask", pm))})
    return out


def fed_mismatch(ctx, groups, lseed: int, fed: list) -> int:
    """Rows of the checked steps' batches, as the loader fed them, whose
    tokens differ from those :func:`checked_batches` works out, row for row
    ([CLS] and [SEP] around each, pads left out)."""
    m = ctx.config["model"]
    B = int(ctx.config["train"]["batch_size"])

    def rows(side):
        return [tuple(int(x) for x in ids[mask > 0])
                for ids, mask in zip(side["input_ids"],
                                     side["attention_mask"])]

    def wrap(t):
        return (m["cls_token_id"], *map(int, t), m["sep_token_id"])

    bad = 0
    for items, got in zip(batch_items(groups, lseed, B, len(fed)), fed):
        want_q = [wrap(groups[i]["query"]) for i in items]
        want_p = [wrap(x) for i in items
                  for x in group_passages(groups, i, lseed)]
        q, p = rows(got["query"]), rows(got["passage"])
        bad += sum(a != b for a, b in zip(q, want_q))
        bad += sum(a != b for a, b in zip(p, want_p))
        bad += abs(len(q) - len(want_q)) + abs(len(p) - len(want_p))
    return bad


def reference_gaps(ctx, weights, d, groups, prog_losses, first_grad, after,
                   lseed: int, precision: str = "f32") -> dict:
    """The three compared numbers of the program's checked steps against
    the reference's (``precision="fp8"``: the control's)."""
    torch = ctx.torch
    from benchmarks.reference import no_tf32
    from benchmarks.reference.train import leaf_gap, train_steps

    no_tf32()
    tcfg = ctx.config["train"]
    batches = checked_batches(ctx, groups, lseed, len(prog_losses))
    ref_losses, ref_first, ref_after = train_steps(
        weights, d, ctx.config["head"], tcfg, batches,
        int(tcfg["n_passages"]), precision,
        dropout_stream(ctx.config, lseed))
    ref_first = {k: v.cpu() for k, v in ref_first.items()}
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog_losses, ref_losses))
    if set(first_grad) != set(ref_first):
        return {"loss_gap": loss_gap, "grad_gap": float("inf"),
                "change_gap": float("inf")}
    grad_gap = leaf_gap(first_grad, ref_first)
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref_first.items()}
    med = sorted(norms.values())[len(norms) // 2]
    moved = [k for k in ref_first if norms[k] >= 1e-3 * med]
    w0 = {k: weights[k].cpu() for k in moved}
    change_gap = leaf_gap({k: after[k] - w0[k] for k in moved},
                          {k: ref_after[k].cpu() - w0[k] for k in moved})
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
