"""Synthetic DHR-shaped corpora and queries with trained-rep statistics.

A frozen copy of ``dhr_tpu_torch/retrieval/synth.py``, kept with the
benchmark so that the traffic a cell searches cannot move with the program.
Its generative model is that of ``dhr_tpu/retrieval/synth.py``, with the
same :class:`SynthConfig` defaults (Zipf dim popularity and fold usage,
latent topics that co-activate dims and agree on the dominant fold, a
right-skewed value profile, topic-centred CLS tails), drawn with
``torch.Generator`` on the target device.  A query has ~30-46 dims above
``theta=0.3`` (mean ~38); a passage ~140 materially active dims.

Draws cannot reproduce ``jax.random`` streams, so parity with ``dhr_tpu``
is statistical.  Determinism: the world (dim popularity, topic sets,
centroids) is a function of ``seed``; each chunk of rows is a function of
``(seed, stream, chunk)``, so the quantizing pass of
:func:`synth_index_planes` regenerates exactly the chunk its amax pass saw,
and corpus (stream 0) and queries (stream >= 1) share one world.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmarks.gen.quantize import quantize_with_scales, scales_from_absmax

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    """Knobs for the synthetic DHR-rep world (defaults as ``dhr_tpu``)."""

    lex_dim: int = 768
    cls_dim: int = 128
    n_folds: int = 39
    n_topics: int = 1024
    topic_dims: int = 96
    dim_zipf: float = 0.7
    fold_zipf: float = 1.0
    topic_zipf: float = 0.8
    fold_topic_agree: float = 0.8
    p_topical_act: float = 0.55
    p_background: float = 90.0
    p_val_base: float = 0.08
    p_val_scale: float = 0.35
    q_topical_act: float = 0.45
    q_background: float = 6.0
    q_val_base: float = 0.22
    q_val_scale: float = 0.28
    noise_scale: float = 0.012
    cls_topic_w: float = 0.9
    cls_noise_w: float = 0.45


@dataclasses.dataclass
class World:
    """Structure shared by the corpus and the queries of one seed."""

    w_dim: torch.Tensor      # (D,) Zipf popularity, mean 1, permuted
    active_td: torch.Tensor  # (topics, D) bool characteristic dims
    emb: torch.Tensor        # (topics, C) CLS topic centroids
    rot: torch.Tensor        # (D,) per-dim fold rotation
    fold_cdf: torch.Tensor   # (F,)
    topic_cdf: torch.Tensor  # (topics,)


def _generator(device: torch.device, *words: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(words)).generate_state(1,
                                                                  np.uint64)[0])
    g = torch.Generator(device=device)
    g.manual_seed(seed & ((1 << 63) - 1))
    return g


def _hash_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's stateless integer hash, in int64 masked to 32 bits."""
    h = ((a.long() * 2654435761) & _U32) ^ ((b.long() * 40503 + 0x9E3779B9)
                                            & _U32)
    h = ((h ^ (h >> 15)) * 0x85EBCA6B) & _U32
    return h ^ (h >> 13)


def _zipf_cdf(n: int, offset: float, s: float, device) -> torch.Tensor:
    w = (torch.arange(n, dtype=torch.float32, device=device) + offset) ** (-s)
    return torch.cumsum(w / w.sum(), dim=0)


def make_world(cfg: SynthConfig, seed: int, device) -> World:
    g = _generator(device, seed, 0x57A1D)
    D = cfg.lex_dim
    ranks = torch.arange(D, dtype=torch.float32, device=device)
    w = (ranks + 8.0) ** (-cfg.dim_zipf)
    w = (w / w.mean())[torch.randperm(D, generator=g, device=device)]
    p_td = torch.clamp(cfg.topic_dims * w / D, 0.0, 0.95)
    active_td = torch.rand(cfg.n_topics, D, generator=g,
                           device=device) < p_td[None, :]
    emb = torch.randn(cfg.n_topics, cfg.cls_dim, generator=g, device=device)
    emb = emb / math.sqrt(cfg.cls_dim)
    rot = _hash_u32(torch.arange(D, device=device),
                    torch.zeros((), dtype=torch.long, device=device))
    rot = (rot % cfg.n_folds).int()
    return World(w, active_td, emb, rot,
                 _zipf_cdf(cfg.n_folds, 1.0, cfg.fold_zipf, device),
                 _zipf_cdf(cfg.n_topics, 1.0, cfg.topic_zipf, device))


def _chunk_reps(cfg: SynthConfig, world: World, g: torch.Generator, n: int,
                role: str):
    """One chunk of n rows: (values (n, D+C) f32, folds (n, D) int8,
    topics (n,) int64)."""
    if role == "query":
        topical_act, background = cfg.q_topical_act, cfg.q_background
        val_base, val_scale = cfg.q_val_base, cfg.q_val_scale
    else:
        topical_act, background = cfg.p_topical_act, cfg.p_background
        val_base, val_scale = cfg.p_val_base, cfg.p_val_scale
    dev = world.w_dim.device
    D, Fo = cfg.lex_dim, cfg.n_folds

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    z = torch.searchsorted(world.topic_cdf, rand(n)).clamp_(max=cfg.n_topics - 1)
    t_act = world.active_td[z]                          # (n, D)
    active = t_act & (rand(n, D) < topical_act)
    p_bg = torch.clamp(background * world.w_dim / D, 0.0, 1.0)
    active |= rand(n, D) < p_bg[None, :]
    e = -torch.log(rand(n, D).clamp_(min=1e-12))
    lex = torch.where(active, val_base + val_scale * e, cfg.noise_scale * e)
    del active, e

    rank = torch.searchsorted(world.fold_cdf, rand(n, D),
                              out_int32=True).clamp_(max=Fo - 1)
    fold_bg = (rank + world.rot[None, :]) % Fo
    del rank
    dom = _hash_u32(z[:, None], torch.arange(D, device=dev)[None, :]) % Fo
    agree = rand(n, D) < cfg.fold_topic_agree
    folds = torch.where(t_act & agree, dom, fold_bg).to(torch.int8)
    del dom, fold_bg, agree, t_act

    noise = torch.randn(n, cfg.cls_dim, generator=g, device=dev)
    cls = (cfg.cls_topic_w * world.emb[z]
           + cfg.cls_noise_w * noise / math.sqrt(cfg.cls_dim))
    return torch.cat([lex, cls], dim=1), folds, z


def synth_reps(seed: int, n: int, cfg: SynthConfig = SynthConfig(),
               role: str = "passage", stream: int = 1, device="cuda"):
    """n DHR-shaped reps in one draw (queries, small sets).

    Returns ``(values (n, lex+cls) f32, folds (n, lex) int8, topics (n,))``
    on ``device``.
    """
    dev = torch.device(device)
    world = make_world(cfg, seed, dev)
    return _chunk_reps(cfg, world, _generator(dev, seed, stream, 0), n, role)


def synth_index_planes(seed: int, n: int, cfg: SynthConfig = SynthConfig(),
                       chunk_rows: int = 1 << 18, device="cuda",
                       rows: tuple[int, int] | None = None,
                       reduce_amax=None):
    """Corpus planes, generated in row chunks and int8-quantized.

    Two passes over regenerated chunks — per-dim amax, then quantize — so
    the f32 value plane never exists whole.  Any ``n`` works (the last
    chunk is short).  Returns ``(v_i8 (n, D+C), folds (n, D) int8,
    scales (D+C,) f32, topics (n,) int64)``, the arrays
    ``DeviceIndex.from_arrays`` takes.

    ``rows=(start, stop)``: only those rows of the same corpus (rows past
    ``n`` are zero pad rows, topic -1), e.g. one rank's shard; chunk ``i``
    is drawn from its own stream, so the rows equal the whole corpus's.
    The scales still come from every row: the amax pass scans every chunk,
    or, given ``reduce_amax`` (a MAX all-reduce over ranks whose ranges
    cover the corpus), only the chunks the range touches.
    """
    dev = torch.device(device)
    world = make_world(cfg, seed, dev)
    D = cfg.lex_dim + cfg.cls_dim
    start, stop = (0, n) if rows is None else rows
    starts = range(0, n, chunk_rows)

    def chunk(i, c0):
        return _chunk_reps(cfg, world, _generator(dev, seed, 0, i),
                           min(chunk_rows, n - c0), "passage")

    def touched(c0):
        return c0 < min(stop, n) and c0 + chunk_rows > start

    amax = torch.zeros(D, device=dev)
    for i, c0 in enumerate(starts):
        if reduce_amax is None or touched(c0):
            values, _, _ = chunk(i, c0)
            amax = torch.maximum(amax, values.abs().amax(dim=0))
    if reduce_amax is not None:
        amax = reduce_amax(amax)
    scales = scales_from_absmax(amax)

    m = stop - start
    v_i8 = torch.zeros(m, D, dtype=torch.int8, device=dev)
    folds = torch.zeros(m, cfg.lex_dim, dtype=torch.int8, device=dev)
    topics = torch.full((m,), -1, dtype=torch.long, device=dev)
    for i, c0 in enumerate(starts):
        if not touched(c0):
            continue
        values, f, z = chunk(i, c0)
        lo, hi = max(c0, start), min(c0 + values.shape[0], stop)
        src, dst = slice(lo - c0, hi - c0), slice(lo - start, hi - start)
        v_i8[dst] = quantize_with_scales(values[src], scales)
        folds[dst] = f[src]
        topics[dst] = z[src]
    return v_i8, folds, scales, topics
