"""Corpus and query encoding: the model, densify / aggregate and packing on
the device, the packed planes back to the host.

Port of ``dhr_tpu/encode.py``.  Per batch, on the device: the
transformer, the family's head, then the planes an index stores,

- dense:   values (B, D) f16
- agg:     values (B, agg_dim [+ projection_dim]) f16
- dhr/dlr: values (B, dlr_out_dim [+ projection_dim]) f16 ‖ fold indices
  (B, dlr_out_dim) uint8
- colbert: token reps (B, L, Dp) f16 (``encode_tokens``)

and only those planes are copied back, while the next batch computes.  The
container is :class:`dhr_tpu_torch.retrieval.index.PackedIndex`, the
on-disk format the reference writes.  Batches are not padded to
``batch_size`` (the reference pads them for one compiled shape); the
outputs are the same.

Data-parallel (``Encoder(mesh=)``, one process per rank): every rank is
given the same batches; each batch is zero-padded to a multiple of the
rank count, each rank encodes its rows (plain or packed), and the planes
are all-gathered in batch order with the pad rows dropped, so every rank
returns the one-process ``PackedIndex``.

Token packing (:func:`plan_packing`, :func:`collate_packed`,
:func:`packed_encode_batches`) puts several documents in one row under
block-diagonal attention, so pad work drops to the row-fill slack;
:meth:`Encoder.encode_corpus_packed` and :meth:`Encoder.encode_tokens_packed`
encode such batches.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterable

import numpy as np
import torch

from dhr_tpu_torch.device import resolve_device
from dhr_tpu_torch.models.retrievers import BiEncoder, Reps, RetrieverConfig
from dhr_tpu_torch.models.transformer import compute_copy
from dhr_tpu_torch.ops.aggregate import aggregate, merge_reps
from dhr_tpu_torch.ops.densify import densify
from dhr_tpu_torch.retrieval.index import PackedIndex
from dhr_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    batch_size: int = 32
    remove_dims: int = 570


class Encoder:
    """Batched corpus / query encoder for one model on one device.

    ``device`` defaults to the GPU (raising without one).  The model:

    - on the BERT-family encoder, the encoder keeps its own copy of
      ``model`` there, with the linear and embedding weights cast to the
      compute dtype once (``compute_copy``);
    - on the decoder backbone built in its compute dtype
      (``DecoderConfig.param_dtype == dtype``, RMSNorm weights in f32),
      the encoder takes ``model`` itself, without a copy: a model that
      already lies on ``device`` keeps its storage, one elsewhere is
      moved there in place (a copy of DeepSeek-V2-Lite's 31 GB would not
      fit beside it).  A decoder with f32 parameters is copied as the
      encoder is.  The encoder then names each batch's real tokens to
      the model (``real_rows``), from the mask it collated on the host,
      so that the MoE layers route those alone.

    ``mesh``: encode data-parallel over its ranks (see the module
    docstring).
    """

    def __init__(self, model: BiEncoder, cfg: RetrieverConfig,
                 encode_cfg: EncodeConfig = EncodeConfig(),
                 device: str | torch.device | None = None, mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.encode_cfg = encode_cfg
        if cfg.causal and cfg.encoder.param_dtype == cfg.encoder.dtype:
            self.model = model.to(self.device).eval()
        else:
            self.model = compute_copy(model, cfg.encoder.dtype,
                                      self.device).eval()
        self._group = self._shard = None
        if mesh is not None and mesh.size() > 1:
            from dhr_tpu_torch.parallel.mesh import (
                axes_group, row_axes, shard_coords)

            axes = row_axes(mesh, mesh.mesh_dim_names[-1])
            self._group = axes_group(mesh, axes)
            self._shard = shard_coords(mesh, axes)

    def _local(self, arrays):
        """This rank's rows of a batch's row arrays, zero-padded to a
        multiple of the rank count; unsharded, the arrays."""
        if self._group is None:
            return arrays
        from dhr_tpu_torch.parallel.mesh import (
            local_rows, pad_rows_to_multiple)

        index, count = self._shard
        return [local_rows(pad_rows_to_multiple(np.asarray(a), count)[0],
                           index, count) for a in arrays]

    def _gathered(self, t, rows: int):
        """Every rank's ``t`` in rank order, the first ``rows`` kept (the
        pad rows dropped); unsharded, ``t``."""
        if self._group is None or t is None:
            return t
        from dhr_tpu_torch.parallel.collectives import all_gather_cat

        return all_gather_cat(t, self._group, dim=0)[:rows]

    @property
    def lex_dim(self) -> int:
        cfg = self.cfg
        if cfg.model_type in ("dhr", "dlr"):
            return cfg.dlr_out_dim
        if cfg.model_type == "agg":
            return cfg.agg_dim
        return -1  # dense: the whole vector is "lexical" for the index

    def planes(self, reps: Reps):
        """The stored planes of one batch: ``(values f16, fold indices
        uint8 or None)``, on the device."""
        cfg = self.cfg
        if cfg.model_type == "dense":
            return reps.dense.half(), None
        if cfg.model_type == "agg":
            tok = aggregate(reps.lexical, cfg.agg_dim,
                            full=not cfg.semi_aggregate)
            if reps.semantic is not None:
                tok = merge_reps(tok, reps.semantic)
            return tok.half(), None
        if cfg.model_type in ("dhr", "dlr"):
            vals, idxs = densify(reps.lexical, cfg.dlr_out_dim,
                                 self.encode_cfg.remove_dims)
            if reps.semantic is not None and cfg.combine_cls:
                vals = torch.cat([vals, reps.semantic.to(vals.dtype)], -1)
            return vals.half(), idxs.to(torch.uint8)
        # colbert: the padded token reps, [CLS] first, masked rows zero
        return torch.cat([reps.token_cls, reps.token], dim=1).half(), None

    def encode_batch(self, input_ids, attention_mask, role: str):
        """One batch (numpy or tensors) -> its planes on the device."""
        ids = np.asarray(input_ids)
        V = self.cfg.encoder.vocab_size
        if ids.size and (ids.min() < 0 or ids.max() >= V):
            raise ValueError(f"token ids must lie in [0, {V}); got "
                             f"[{ids.min()}, {ids.max()}]")
        dev = self.device
        n = ids.shape[0]
        ids, mask = self._local([ids, np.asarray(attention_mask)])
        rows = None
        if self.cfg.causal:
            rows = torch.as_tensor(np.flatnonzero(np.asarray(mask))).to(
                dev, non_blocking=True)
        ids = torch.as_tensor(ids).to(dev, non_blocking=True)
        mask = torch.as_tensor(np.asarray(mask)).to(dev, non_blocking=True)
        with torch.inference_mode():
            reps = self.model.encoder(role)(ids, mask,
                                            is_query=role == "query",
                                            real_rows=rows)
            vals, idxs = self.planes(reps)
            return self._gathered(vals, n), self._gathered(idxs, n)

    def packed_planes(self, batch: dict):
        """One packed batch -> its per-slot planes ``(values f16 (B*S, D),
        fold indices uint8 or None)`` on the device."""
        cfg = self.cfg
        dev = self.device
        keys = ("input_ids", "segment_ids", "position_ids", "seg_start")
        rows = np.shape(batch["seg_start"])
        t = {k: torch.as_tensor(np.asarray(a)).to(dev, non_blocking=True)
             for k, a in zip(keys, self._local([batch[k] for k in keys]))}
        with torch.inference_mode():
            vals, idxs, semantic = self.model.encode_passages_packed(
                t["input_ids"], t["segment_ids"], t["position_ids"],
                t["seg_start"], cfg.dlr_out_dim, self.encode_cfg.remove_dims)
            if cfg.model_type == "agg" and semantic is not None:
                vals = merge_reps(vals, semantic)
            elif (cfg.model_type in ("dhr", "dlr") and semantic is not None
                  and cfg.combine_cls):
                vals = torch.cat([vals, semantic.to(vals.dtype)], -1)
            vals = vals.reshape(-1, vals.shape[-1]).half()
            if idxs is not None:
                idxs = idxs.reshape(-1, idxs.shape[-1]).to(torch.uint8)
            slots = rows[0] * rows[1]
            return self._gathered(vals, slots), self._gathered(idxs, slots)

    def _copy_back(self, tensors):
        """Start copying ``tensors`` (None kept) to the host; returns
        ``(event or None, host tensors)``: the event marks the copies done
        on the card (the end event of the ``encode.copy_back`` device
        span)."""
        with span("encode.copy_back", device=True) as copies:
            host = [None if t is None else t.to("cpu", non_blocking=True)
                    for t in tensors]
        return (copies.end_event if self.device.type == "cuda" else None,
                host)

    def encode_corpus_packed(self, batches: Iterable[dict]) -> PackedIndex:
        """Encode token-packed batches from :func:`packed_encode_batches`:
        one row per document in plan order (empty slots are dropped)."""
        if self.cfg.model_type not in ("dense", "dhr", "dlr", "agg"):
            raise ValueError(
                "packed plane encode supports dense/dhr/dlr/agg, not "
                f"{self.cfg.model_type}"
                + (" — colbert packs via encode_tokens_packed()"
                   if self.cfg.model_type == "colbert" else ""))

        def packed(batch):
            planes = self.packed_planes(batch)
            valid = np.zeros(np.shape(batch["seg_start"]), bool)
            for r, sids in enumerate(batch["slot_ids"]):
                valid[r, :len(sids)] = True
            return (planes, valid.reshape(-1),
                    [i for sids in batch["slot_ids"] for i in sids])

        return self._index(*self._run_batches(batches, packed))

    def encode_tokens_packed(self, batches: Iterable[dict], out_len: int):
        """ColBERT reps from token-packed batches: ``(reps (N, out_len, D)
        f16, ids)`` in plan order; each document is one contiguous slice
        of its row, zero-padded to ``out_len``."""
        if self.cfg.model_type != "colbert":
            raise ValueError("packed token encode is colbert-only, not "
                             f"{self.cfg.model_type}")
        reps_out, ids_out = [], []
        dev = self.device

        for batch in batches:
            keys = ("input_ids", "segment_ids", "position_ids")
            t = [torch.as_tensor(np.asarray(a)).to(dev)
                 for a in self._local([batch[k] for k in keys])]
            with torch.inference_mode():
                reps = self._gathered(
                    self.model.encode_tokens_packed(*t).half(),
                    len(batch["input_ids"])).cpu()
            reps = reps.numpy()
            segment_ids = np.asarray(batch["segment_ids"])
            seg_start = np.asarray(batch["seg_start"])
            slot_ids = batch["slot_ids"]
            out = np.zeros((sum(len(s) for s in slot_ids), out_len,
                            reps.shape[-1]), np.float16)
            d = 0
            for r, sids in enumerate(slot_ids):
                seg_len = np.bincount(segment_ids[r], minlength=len(sids) + 1)
                for s, sid in enumerate(sids):
                    start = int(seg_start[r, s])
                    n = min(int(seg_len[s + 1]), out_len)
                    out[d, :n] = reps[r, start:start + n]
                    ids_out.append(sid)
                    d += 1
            reps_out.append(out)
        return np.concatenate(reps_out, axis=0), ids_out

    def _run_batches(self, batches: Iterable[dict], planes_of: Callable):
        """``(values, indices or None, ids)`` of all batches, where
        ``planes_of(batch)`` queues a batch's planes and returns ``(planes,
        rows kept or None for all, ids)``.  Each batch's planes start
        copying back before the next batch is queued and are read after
        it, so the device does not wait on the host.  Spans of the
        recorder (``utils.profiling``): ``encode.issue`` (a batch queued),
        ``encode.copy_back`` (its copies, on the device), ``encode.wait``
        (the host waiting for the copies) and ``encode.collect`` (the
        planes joined)."""
        values_out, indices_out, ids_out = [], [], []
        pending = None

        def drain(pending):
            keep, (done, (vals, idxs)) = pending
            if done is not None:
                with span("encode.wait"):
                    done.synchronize()
            keep = slice(None) if keep is None else keep
            values_out.append(vals.numpy()[keep])
            if idxs is not None:
                indices_out.append(idxs.numpy()[keep])

        for batch in batches:
            with span("encode.issue"):
                planes, keep, ids = planes_of(batch)
            planes = self._copy_back(planes)
            if pending is not None:
                drain(pending)
            pending = (keep, planes)
            ids_out.extend(ids)
        if pending is not None:
            drain(pending)
        with span("encode.collect"):
            values = np.concatenate(values_out, axis=0)
            indices = (np.concatenate(indices_out, axis=0) if indices_out
                       else None)
        return values, indices, ids_out

    def _plain(self, role: str) -> Callable:
        """``planes_of`` of ``{ids, input_ids, attention_mask}`` batches."""
        return lambda batch: (self.encode_batch(
            batch["input_ids"], batch["attention_mask"], role), None,
            batch["ids"])

    def _index(self, values, indices, ids) -> PackedIndex:
        lex = self.lex_dim if self.lex_dim > 0 else values.shape[1]
        return PackedIndex(
            values=values,
            indices=indices,
            docids=np.asarray([str(i) for i in ids], dtype=object),
            lex_dim=lex,
        )

    def encode_corpus(self, batches: Iterable[dict]) -> PackedIndex:
        """Encode ``{ids, input_ids, attention_mask}`` batches of passages."""
        if self.cfg.model_type == "colbert":
            raise ValueError(
                "colbert emits (N, L, D) token reps, not packed planes; use "
                "encode_tokens()")
        return self._index(*self._run_batches(batches,
                                              self._plain("passage")))

    def encode_queries(self, batches: Iterable[dict]):
        """``(values, indices or None, qids)`` (the reference's query
        pickle)."""
        if self.cfg.model_type == "colbert":
            raise ValueError(
                "colbert emits (N, L, D) token reps, not packed planes; use "
                "encode_tokens()")
        return self._run_batches(batches, self._plain("query"))

    def encode_tokens(self, batches: Iterable[dict], role: str):
        """ColBERT token reps: ``(reps (N, L, D) f16, ids)``, padded to the
        batches' length with masked rows zeroed."""
        reps, _, ids = self._run_batches(batches, self._plain(role))
        return reps, ids


def iter_batches(ids, input_ids, attention_mask, batch_size: int):
    """Slice pre-tokenized arrays into encode batches."""
    n = len(ids)
    for start in range(0, n, batch_size):
        sl = slice(start, min(start + batch_size, n))
        yield {
            "ids": ids[sl],
            "input_ids": input_ids[sl],
            "attention_mask": attention_mask[sl],
        }


# The padded lengths bucketed batches may use: a small menu bounds the
# number of distinct batch shapes while wasting < 33% pad work in a bucket.
LENGTH_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)


def plan_length_buckets(
    lengths, batch_size: int, max_len: int,
    allowed: tuple[int, ...] = LENGTH_BUCKETS,
):
    """Group items into batches padded to per-batch bucket lengths.

    Sorting by length and padding each batch to the smallest allowed
    bucket >= its longest member cuts encode work by about the corpus's
    mean/max length ratio; masked positions keep the reps the same.

    Returns ``(plan, order)``: ``plan`` is a list of ``(indices,
    bucket_len)`` batches over the ORIGINAL item indices; ``order`` is all
    indices in plan order (outputs restore to input order via
    ``np.argsort(order)``).
    """
    lengths = np.minimum(np.asarray(lengths, np.int64), max_len)
    menu = sorted({b for b in allowed if b < max_len} | {max_len})
    order = np.argsort(lengths, kind="stable")
    plan = []
    for start in range(0, len(order), batch_size):
        sel = order[start:start + batch_size]
        need = int(lengths[sel].max(initial=1))
        blen = next(b for b in menu if b >= need)
        plan.append((sel, blen))
    return plan, order


def bucketed_encode_batches(
    ids, toks, batch_size: int, max_len: int,
    cls_id: int | None, sep_id: int | None,
):
    """Length-bucketed encode batches over pre-tokenized texts (no
    specials): each item's length is ``len(t) + 2`` (the [CLS]/[SEP]
    budget), and each batch wraps and pads to its bucket length, so the
    reps equal the pad-to-``max_len`` path's.

    Returns ``(batches, order)``: a generator of ``collate_encode`` batches
    and the item order they cover.  The plan and each batch's collation
    are ``encode.buckets`` spans of the recorder (``utils.profiling``).
    """
    from dhr_tpu_torch.data.collate import collate_encode, wrap_specials

    with span("encode.buckets"):
        plan, order = plan_length_buckets(
            [len(t) + 2 for t in toks], batch_size, max_len
        )

    def gen():
        for sel, blen in plan:
            with span("encode.buckets"):
                batch = collate_encode(
                    [ids[i] for i in sel],
                    [wrap_specials(toks[i], blen, cls_id, sep_id)
                     for i in sel],
                    blen,
                )
            yield batch

    return gen(), order


def plan_packing(lengths, row_len: int, max_segments: int):
    """First-fit-decreasing token packing over a length histogram.

    Groups documents into rows of ``row_len`` tokens with at most
    ``max_segments`` documents a row: open a row, repeatedly add the longest
    remaining document that still fits.  Returns rows, each a list of
    ORIGINAL item indices in slot order; every item appears once.  Lengths
    are planned within [1, row_len]: an empty item still takes one token
    (``wrap_specials`` emits ``[0]``), a longer one gets a row of its own
    and is truncated at collation, like the plain path's cut.  The C++
    runtime's twin (:func:`dhr_tpu_torch.native.plan_packing_native`, the
    same plan item for item) runs when it is built.
    """
    import bisect

    from dhr_tpu_torch import native

    planned = native.plan_packing_native(lengths, row_len, max_segments)
    if planned is not None:
        items, offsets = planned
        return [items[offsets[r]:offsets[r + 1]].tolist()
                for r in range(len(offsets) - 1)]
    lengths = np.clip(np.asarray(lengths, np.int64), 1, row_len)
    by_len: dict[int, list[int]] = {}
    for i, n in enumerate(lengths.tolist()):
        by_len.setdefault(n, []).append(i)
    heads = {n: 0 for n in by_len}  # FIFO per length: input order kept
    avail = sorted(by_len)  # distinct lengths with items left, ascending
    rows = []
    while avail:
        cap = row_len
        row = []
        while len(row) < max_segments:
            j = bisect.bisect_right(avail, cap) - 1
            if j < 0:
                break
            n = avail[j]
            q = by_len[n]
            row.append(q[heads[n]])
            heads[n] += 1
            if heads[n] == len(q):
                avail.pop(j)
            cap -= n
        rows.append(row)
    return rows


def collate_packed(rows, ids, toks, batch_rows: int, row_len: int,
                   max_segments: int, cls_id: int | None,
                   sep_id: int | None) -> dict:
    """One packed batch from planner rows, fixed ``(batch_rows, row_len)``
    and ``(batch_rows, max_segments)`` shapes: ``input_ids``,
    ``segment_ids`` (1..S, 0 = pad), ``position_ids`` (restarting at 0 per
    segment), ``seg_start`` (each slot's first position) and ``slot_ids``
    (the document ids in each row's slots).  Rows past ``len(rows)`` stay
    padded."""
    from dhr_tpu_torch.data.collate import wrap_specials

    input_ids = np.zeros((batch_rows, row_len), np.int32)
    segment_ids = np.zeros((batch_rows, row_len), np.int32)
    position_ids = np.zeros((batch_rows, row_len), np.int32)
    seg_start = np.zeros((batch_rows, max_segments), np.int32)
    slot_ids = []
    for r, row in enumerate(rows):
        off = 0
        sids = []
        for s, item in enumerate(row):
            t = wrap_specials(toks[item], row_len - off, cls_id, sep_id)
            n = len(t)
            input_ids[r, off:off + n] = t
            segment_ids[r, off:off + n] = s + 1
            position_ids[r, off:off + n] = np.arange(n)
            seg_start[r, s] = off
            sids.append(ids[item])
            off += n
        slot_ids.append(sids)
    while len(slot_ids) < batch_rows:
        slot_ids.append([])
    return {"input_ids": input_ids, "segment_ids": segment_ids,
            "position_ids": position_ids, "seg_start": seg_start,
            "slot_ids": slot_ids}


def packed_encode_batches(ids, toks, batch_rows: int, row_len: int,
                          max_segments: int, cls_id: int | None,
                          sep_id: int | None):
    """Token-packed encode batches over pre-tokenized texts (no specials;
    each item planned at ``len(t) + 2``).  Returns ``(batches, order)``
    like :func:`bucketed_encode_batches`: a generator of
    :func:`collate_packed` batches and the document order they emit."""
    rows = plan_packing([len(t) + 2 for t in toks], row_len, max_segments)
    order = np.asarray([i for row in rows for i in row])

    def gen():
        for start in range(0, len(rows), batch_rows):
            yield collate_packed(rows[start:start + batch_rows], ids, toks,
                                 batch_rows, row_len, max_segments, cls_id,
                                 sep_id)

    return gen(), order


def make_query_encoder(encoder: Encoder, tokenizer, q_max_len: int,
                       cls_id: int | None, sep_id: int | None):
    """Raw query strings -> ``(values, indices or None)``.  Any object with
    ``encode(text, add_special_tokens=False, max_length=..., truncation=
    True)`` serves as the tokenizer."""
    from dhr_tpu_torch.data.collate import collate_encode, wrap_specials

    bs = encoder.encode_cfg.batch_size

    def encode(queries: list[str]):
        toks = [
            tokenizer.encode(q, add_special_tokens=False,
                             max_length=q_max_len, truncation=True)
            for q in queries
        ]
        wrapped = [wrap_specials(t, q_max_len, cls_id, sep_id) for t in toks]

        def batches():
            for start in range(0, len(wrapped), bs):
                chunk = wrapped[start: start + bs]
                yield collate_encode(
                    [str(start + j) for j in range(len(chunk))],
                    chunk, q_max_len,
                )

        values, indices, _ = encoder.encode_queries(batches())
        return values, indices

    return encode
