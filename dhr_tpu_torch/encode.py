"""Corpus and query encoding: the model, densify / aggregate and packing on
the device, the packed planes back to the host.

Port of the plain-row path of ``dhr_tpu/encode.py`` (token packing is not
ported yet).  Per batch, on the device: the transformer, the family's head,
then the planes an index stores,

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
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

import numpy as np
import torch

from dhr_tpu_torch.device import resolve_device
from dhr_tpu_torch.models.retrievers import BiEncoder, Reps, RetrieverConfig
from dhr_tpu_torch.models.transformer import compute_copy
from dhr_tpu_torch.ops.aggregate import aggregate, merge_reps
from dhr_tpu_torch.ops.densify import densify
from dhr_tpu_torch.retrieval.index import PackedIndex


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    batch_size: int = 32
    remove_dims: int = 570


class Encoder:
    """Batched corpus / query encoder for one model on one device.

    ``device`` defaults to the GPU (raising without one); the encoder keeps
    its own copy of ``model`` there, with the linear and embedding weights
    cast to the compute dtype once.
    """

    def __init__(self, model: BiEncoder, cfg: RetrieverConfig,
                 encode_cfg: EncodeConfig = EncodeConfig(),
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.encode_cfg = encode_cfg
        self.model = compute_copy(model, cfg.encoder.dtype,
                                  self.device).eval()

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
        ids = torch.as_tensor(ids).to(dev, non_blocking=True)
        mask = torch.as_tensor(np.asarray(attention_mask)).to(
            dev, non_blocking=True)
        with torch.inference_mode():
            reps = self.model.encoder(role)(ids, mask,
                                            is_query=role == "query")
            return self.planes(reps)

    def _run_batches(self, role: str, batches: Iterable[dict]):
        """``(values, indices or None, ids)`` of all batches.  Each batch's
        planes start copying back before the next batch is queued and are
        read after it, so the device does not wait on the host."""
        values_out, indices_out, ids_out = [], [], []
        pending = None

        def drain(pending):
            done, vals, idxs = pending
            if done is not None:
                done.synchronize()
            values_out.append(vals.numpy())
            if idxs is not None:
                indices_out.append(idxs.numpy())

        for batch in batches:
            vals, idxs = self.encode_batch(batch["input_ids"],
                                           batch["attention_mask"], role)
            vals = vals.to("cpu", non_blocking=True)
            idxs = None if idxs is None else idxs.to("cpu", non_blocking=True)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            if pending is not None:
                drain(pending)
            pending = (done, vals, idxs)
            ids_out.extend(batch["ids"])
        if pending is not None:
            drain(pending)
        values = np.concatenate(values_out, axis=0)
        indices = np.concatenate(indices_out, axis=0) if indices_out else None
        return values, indices, ids_out

    def encode_corpus(self, batches: Iterable[dict]) -> PackedIndex:
        """Encode ``{ids, input_ids, attention_mask}`` batches of passages."""
        if self.cfg.model_type == "colbert":
            raise ValueError(
                "colbert emits (N, L, D) token reps, not packed planes; use "
                "encode_tokens()")
        values, indices, ids = self._run_batches("passage", batches)
        lex = self.lex_dim if self.lex_dim > 0 else values.shape[1]
        return PackedIndex(
            values=values,
            indices=indices,
            docids=np.asarray([str(i) for i in ids], dtype=object),
            lex_dim=lex,
        )

    def encode_queries(self, batches: Iterable[dict]):
        """``(values, indices or None, qids)`` (the reference's query
        pickle)."""
        if self.cfg.model_type == "colbert":
            raise ValueError(
                "colbert emits (N, L, D) token reps, not packed planes; use "
                "encode_tokens()")
        return self._run_batches("query", batches)

    def encode_tokens(self, batches: Iterable[dict], role: str):
        """ColBERT token reps: ``(reps (N, L, D) f16, ids)``, padded to the
        batches' length with masked rows zeroed."""
        reps, _, ids = self._run_batches(role, batches)
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
    and the item order they cover.
    """
    from dhr_tpu_torch.data.collate import collate_encode, wrap_specials

    plan, order = plan_length_buckets(
        [len(t) + 2 for t in toks], batch_size, max_len
    )

    def gen():
        for sel, blen in plan:
            yield collate_encode(
                [ids[i] for i in sel],
                [wrap_specials(toks[i], blen, cls_id, sep_id) for i in sel],
                blen,
            )

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
