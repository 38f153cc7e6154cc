"""Training example sampling: negative rotation, TASB clusters, KD bins.

Port of ``dhr_tpu/data/sampling.py``, whose rules follow the reference
``tevatron/data.py``:

- positive selection: ``positives[(item_seed + epoch) % len]``
  (data.py:64-67); ``item_seed = item + global_seed`` (the reference's
  ``hash(item + seed)`` — identity for ints).
- negative rotation (data.py:70-82): fewer negatives than needed -> sample
  with replacement; otherwise shuffle with the per-item seed, tile x2, take a
  window at offset ``epoch * negative_size % len``.
- TASB topic-aware batch sampling (data.py:205-215): per *batch* (seeded by
  the global step) draw 24 clusters; each example draws one cluster then one
  query index from it.
- KD bin-pair sampling (data.py:170-198): draw a bin set, then per negative a
  (pos_idx, neg_idx, margin) pair; teacher score for the positive column is 0
  and each negative's is ``-margin`` (collated with the 0 prepended,
  data.py:318-321).
"""

from __future__ import annotations

import random
from dataclasses import dataclass


def truncate(tokens: list[int], max_len: int) -> list[int]:
    return tokens[:max_len] if len(tokens) > max_len else tokens


@dataclass(frozen=True)
class SamplingConfig:
    n_passages: int = 8
    q_max_len: int = 32
    p_max_len: int = 128
    positive_no_shuffle: bool = False
    negative_no_shuffle: bool = False
    seed: int = 42
    # special tokens re-added at collation (the interchange corpora store
    # token ids without them); None disables (tiny-vocab tests)
    cls_id: int | None = None
    sep_id: int | None = None


def select_passages(
    positives: list, negatives: list, item: int, epoch: int,
    cfg: SamplingConfig, rng: random.Random,
) -> tuple[object, list]:
    """Pick (positive, [negatives...]) with the reference's rotation rule."""
    item_seed = item + cfg.seed
    if cfg.positive_no_shuffle:
        pos = positives[0]
    else:
        pos = positives[(item_seed + epoch) % len(positives)]
    negative_size = cfg.n_passages - 1
    if negative_size <= 0:
        return pos, []
    if len(negatives) < negative_size:
        negs = rng.choices(negatives, k=negative_size)
    elif cfg.negative_no_shuffle:
        negs = negatives[:negative_size]
    else:
        offset = epoch * negative_size % len(negatives)
        pool = list(negatives)
        random.Random(item_seed).shuffle(pool)
        pool = pool * 2
        negs = pool[offset: offset + negative_size]
    return pos, negs


def sample_train_example(
    group: dict, item: int, epoch: int, cfg: SamplingConfig,
    rng: random.Random, corpus=None,
) -> tuple[list[int], list[list[int]], list[float] | None]:
    """One (query, passages, teacher_scores) example.

    Handles both inline-text groups (``positives``/``negatives``) and
    pid-resolved groups (``positive_pids``/``negative_pids`` + corpus).
    """
    query = truncate(group["query"], cfg.q_max_len)
    inline = "positives" in group
    positives = group["positives"] if inline else group["positive_pids"]
    negatives = group["negatives"] if inline else group["negative_pids"]
    pos, negs = select_passages(positives, negatives, item, epoch, cfg, rng)

    def text(x):
        t = x if inline else corpus.text_by_pid(x)
        return truncate(t, cfg.p_max_len)

    return query, [text(pos)] + [text(n) for n in negs], None


def sample_kd_example(
    group: dict, cfg: SamplingConfig, rng: random.Random, corpus,
) -> tuple[list[int], list[list[int]], list[float]]:
    """Margin-KD example from score-binned pairs (reference data.py:170-198)."""
    query = truncate(group["query"], cfg.q_max_len)
    bins = rng.choices(group["bin_pairs"], k=1)[0]
    negative_size = cfg.n_passages - 1
    pairs = []
    for _ in range(negative_size):
        b = rng.choices(bins, k=1)[0]
        pairs.append(rng.choices(b, k=1)[0])
    pos_pid = group["positive_pids"][int(pairs[0][0])]
    passages = [truncate(corpus.text_by_pid(pos_pid), cfg.p_max_len)]
    scores = []
    for pair in pairs:
        neg_pid = group["negative_pids"][int(pair[1])]
        passages.append(truncate(corpus.text_by_pid(neg_pid), cfg.p_max_len))
        scores.append(-float(pair[2]))
    return query, passages, scores


class TASBSampler:
    """Topic-aware balanced batch sampler.

    ``clusters`` is a list of ``{"qidx": [train indices...]}``.  For each
    batch, 24 clusters are drawn with a step-seeded RNG so the whole batch
    shares topics; each example then draws its cluster and query with its
    item-seeded RNG (reference data.py:205-215).
    """

    def __init__(self, clusters: list[dict], seed: int = 42,
                 clusters_per_batch: int = 24):
        self.clusters = clusters
        self.seed = seed
        self.clusters_per_batch = clusters_per_batch

    def batch_indices(self, global_step: int, batch_size: int) -> list[int]:
        step_rng = random.Random(global_step)
        cluster_list = step_rng.choices(
            self.clusters, k=self.clusters_per_batch
        )
        out = []
        for i in range(batch_size):
            item_rng = random.Random(global_step * batch_size + i + self.seed)
            cluster = item_rng.choices(cluster_list, k=1)[0]
            out.append(item_rng.choices(cluster["qidx"])[0])
        return out
