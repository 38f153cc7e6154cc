"""Train batch iteration with background prefetch.

Port of ``dhr_tpu/data/loader.py``: a thread builds fixed-shape numpy
batches ahead of the train loop, so host collation overlaps device compute.
Given the same groups and seed it yields the reference loader's batches,
byte for byte.
"""

from __future__ import annotations

import queue
import random
import threading
from collections.abc import Iterator

import numpy as np

from dhr_tpu_torch.data.collate import collate_train, collate_train_packed
from dhr_tpu_torch.data.sampling import (
    SamplingConfig,
    TASBSampler,
    sample_kd_example,
    sample_train_example,
)


class TrainLoader:
    """Epoch-based loader over train groups.

    ``kd=True`` draws margin-KD examples from ``bin_pairs`` (the batch then
    carries ``teacher_scores``); ``tasb`` supplies a :class:`TASBSampler` for
    topic-aware batches instead of permutation order.
    """

    def __init__(
        self,
        groups: list[dict],
        cfg: SamplingConfig,
        batch_size: int,
        corpus=None,
        kd: bool = False,
        tasb: TASBSampler | None = None,
        pad_id: int = 0,
        drop_last: bool = True,
        prefetch: int = 4,
        pack_passages: bool = False,
        pack_segments: int = 4,
        pack_rows: int | None = None,
        pack_rows_multiple: int = 1,
    ):
        self.groups = groups
        self.cfg = cfg
        self.batch_size = batch_size
        self.corpus = corpus
        self.kd = kd
        self.tasb = tasb
        self.pad_id = pad_id
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.global_step = 0
        # token-packed passage tower: pack_rows None = auto-size from the
        # first batch's plan (+12.5% headroom, rounded up to
        # pack_rows_multiple)
        self.pack_passages = pack_passages
        self.pack_segments = pack_segments
        self.pack_rows = pack_rows
        self.pack_rows_multiple = max(1, pack_rows_multiple)

    def steps_per_epoch(self) -> int:
        n = len(self.groups) // self.batch_size
        if not self.drop_last and len(self.groups) % self.batch_size:
            n += 1
        return n

    def _make_example(self, item: int, epoch: int, rng: random.Random):
        group = self.groups[item]
        if self.kd:
            return sample_kd_example(group, self.cfg, rng, self.corpus)
        return sample_train_example(
            group, item, epoch, self.cfg, rng, self.corpus
        )

    def _batch_rng(self, epoch: int, b: int) -> random.Random:
        # per-(epoch, batch-position) seeding — NOT a stream advancing
        # across the epoch — so a mid-epoch resume (``skip``) reproduces
        # the uninterrupted run's draws exactly without replaying skipped
        # batches' rng consumption
        return random.Random((self.cfg.seed + epoch) * 1_000_000_007 + b)

    def _epoch_batches(self, epoch: int, skip: int = 0) -> Iterator[dict]:
        spe = self.steps_per_epoch()
        if self.tasb is not None:
            for b in range(skip, spe):
                step = epoch * spe + b
                items = self.tasb.batch_indices(step, self.batch_size)
                yield self._collate(items, epoch, self._batch_rng(epoch, b))
                self.global_step = step + 1
        else:
            order = np.random.default_rng(self.cfg.seed + epoch).permutation(
                len(self.groups)
            )
            for b, start in enumerate(range(0, len(order), self.batch_size)):
                items = order[start: start + self.batch_size].tolist()
                if len(items) < self.batch_size and self.drop_last:
                    break
                if b < skip:
                    continue
                yield self._collate(items, epoch, self._batch_rng(epoch, b))
                self.global_step = epoch * spe + b + 1

    def _collate(self, items, epoch, rng):
        examples = [self._make_example(i, epoch, rng) for i in items]
        if self.pack_passages:
            if self.pack_rows is None:
                self.pack_rows = self._auto_pack_rows()
            return collate_train_packed(
                examples, self.cfg.q_max_len, self.cfg.p_max_len,
                self.pack_rows, self.pack_segments, self.pad_id,
                cls_id=self.cfg.cls_id, sep_id=self.cfg.sep_id,
            )
        return collate_train(
            examples, self.cfg.q_max_len, self.cfg.p_max_len, self.pad_id,
            cls_id=self.cfg.cls_id, sep_id=self.cfg.sep_id,
        )

    def _auto_pack_rows(self) -> int:
        """Plan-derived packed row budget (+12.5% headroom).

        Always derived from epoch-0 batch-0 — NOT from whatever batch is
        collated first — so a resumed run (``skip`` > 0) packs to exactly
        the shapes the uninterrupted run would, keeping the exact-trajectory
        resume guarantee under packing.
        """
        from dhr_tpu_torch.encode import plan_packing

        if self.tasb is not None:
            items = self.tasb.batch_indices(0, self.batch_size)
        else:
            items = np.random.default_rng(self.cfg.seed).permutation(
                len(self.groups)
            )[: self.batch_size].tolist()
        # ONE advancing rng across the batch's examples, exactly like
        # _collate — a per-example reseed would sample different passages
        # than the real batch 0 wherever rng.choices is hit
        rng = self._batch_rng(0, 0)
        examples = [self._make_example(i, 0, rng) for i in items]
        specials = (self.cfg.cls_id is not None) + (self.cfg.sep_id is not None)
        passages = [p for _, ps, _ in examples for p in ps]
        planned = len(plan_packing(
            [len(t) + specials for t in passages],
            self.cfg.p_max_len, self.pack_segments,
        ))
        m = self.pack_rows_multiple
        rows = -(-int(planned * 1.125) // m) * m
        return min(rows, -(-len(passages) // m) * m)

    def epoch(self, epoch: int, skip: int = 0) -> Iterator[dict]:
        """Iterate one epoch with background prefetch.

        ``skip`` drops the first ``skip`` batches (already consumed before
        a resume) while yielding the exact batches the uninterrupted run
        would produce from that position (HF Trainer's
        ``ignore_data_skip=False`` behavior, which the reference inherits).
        """
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for batch in self._epoch_batches(epoch, skip):
                    q.put(batch)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
