"""Corpus densification: sparse vocabulary vectors -> (value, fold) planes.

Port of ``dhr_tpu/densify_offline/corpus.py``.  A batch of sparse rows goes
through the C++ CSR densifier (:func:`dhr_tpu_torch.native.densify_csr`)
when it is built; otherwise it is scattered into a dense ``(B, vocab -
omission)`` matrix and reduced with one reshape / max / argmax, the
semantic reference (the first, lowest fold wins ties).

Front ends (the original densify_corpus.py table):

=============  ==========  ================  =============
front end      omission    whole-word terms  index dtype
=============  ==========  ================  =============
bm25           472         yes               int16
deepimpact     502         yes               int16
unicoil        570         no (wordpiece)    uint8
splade         570         no (wordpiece)    uint8
=============  ==========  ================  =============

Query fold planes are always int16.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

import numpy as np

from dhr_tpu_torch import native
from dhr_tpu_torch.ops.densify import REMOVE_DIMS_BY_MODEL
from dhr_tpu_torch.retrieval.index import PackedIndex

WHOLE_WORD_MODELS = {"bm25": True, "deepimpact": True,
                     "unicoil": False, "splade": False}


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    model: str = "bm25"
    out_dim: int = 768
    vocab_size: int | None = None  # required for whole-word models

    @property
    def omission(self) -> int:
        return REMOVE_DIMS_BY_MODEL[self.model]

    @property
    def index_dtype(self):
        return np.int16 if WHOLE_WORD_MODELS[self.model] else np.uint8

    def padded_vocab(self, raw_vocab: int) -> int:
        """Smallest vocab >= raw that densifies evenly into out_dim."""
        usable = raw_vocab - self.omission
        k = -(-usable // self.out_dim)
        return self.omission + k * self.out_dim


def _csr(rows: list[dict]):
    """``(tids i32, weights f32, offsets i64)`` with each row's tids
    ascending, so the C++ densifier's first-seen fold is the lowest."""
    tid_rows, w_rows = [], []
    for vec in rows:
        t = np.fromiter((int(k) for k in vec), np.int64, len(vec))
        w = np.fromiter(vec.values(), np.float32, len(vec))
        order = np.argsort(t, kind="stable")
        tid_rows.append(t[order])
        w_rows.append(w[order])
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(t) for t in tid_rows], out=offsets[1:])
    tids = (np.concatenate(tid_rows) if tid_rows
            else np.zeros(0, np.int64)).astype(np.int32)
    ws = np.concatenate(w_rows) if w_rows else np.zeros(0, np.float32)
    return tids, ws, offsets


def densify_batch(
    rows: list[dict[int, float]], cfg: DensifyConfig, vocab_size: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Densify a batch of sparse rows: ``(values f16 (B, d), indices (B, d)
    of cfg.index_dtype, n_collisions)``.  ``vocab_size - omission`` must be
    a multiple of ``out_dim`` (see :meth:`DensifyConfig.padded_vocab`)."""
    B, d, om = len(rows), cfg.out_dim, cfg.omission
    usable = vocab_size - om
    if usable % d:
        raise ValueError(f"vocab_size {vocab_size} - omission {om} is not a "
                         f"multiple of out_dim {d}; use padded_vocab")

    if native.available():
        values, indices, collisions = native.densify_csr(
            *_csr(rows), om, d, vocab_size)
        return (values.astype(np.float16),
                indices.astype(cfg.index_dtype), collisions)

    dense = np.zeros((B, usable), np.float32)
    collisions = 0
    for i, vec in enumerate(rows):
        if not vec:
            continue
        tids = np.fromiter((int(t) for t in vec), np.int64, len(vec))
        ws = np.fromiter(vec.values(), np.float32, len(vec))
        keep = (tids >= om) & (tids < vocab_size)
        tids, ws = tids[keep], ws[keep]
        u = tids - om
        sl = u % d
        collisions += len(sl) - len(np.unique(sl))  # extras beyond 1st/slice
        dense[i, u] = ws
    folded = dense.reshape(B, usable // d, d)
    values = folded.max(axis=1).astype(np.float16)
    indices = folded.argmax(axis=1).astype(cfg.index_dtype)
    return values, indices, collisions


def _densify_stream(rows: Iterable[tuple[str, dict]], cfg: DensifyConfig,
                    vocab_size: int, batch_size: int):
    """``(values, indices, ids, collisions)`` of a (id, sparse vector)
    stream, ``batch_size`` rows per :func:`densify_batch`."""
    vals, idxs, ids = [], [], []
    batch_rows, batch_ids = [], []
    collisions = 0

    def flush():
        nonlocal collisions
        if not batch_rows:
            return
        v, i, c = densify_batch(batch_rows, cfg, vocab_size)
        collisions += c
        vals.append(v)
        idxs.append(i)
        ids.extend(batch_ids)
        batch_rows.clear()
        batch_ids.clear()

    for rid, vec in rows:
        batch_ids.append(str(rid))
        batch_rows.append(vec)
        if len(batch_rows) >= batch_size:
            flush()
    flush()
    values = np.concatenate(vals, axis=0) if vals else np.zeros(
        (0, cfg.out_dim), np.float16)
    indices = np.concatenate(idxs, axis=0) if idxs else np.zeros(
        (0, cfg.out_dim), cfg.index_dtype)
    return values, indices, ids, collisions


def densify_corpus(
    sparse_rows: Iterable[tuple[str, dict]],
    cfg: DensifyConfig,
    vocab_size: int,
    batch_size: int = 256,
) -> PackedIndex:
    """Densify a (docid, sparse vector) stream into a :class:`PackedIndex`
    (``lex_dim = out_dim``, no CLS tail); its ``collisions`` attribute
    counts the slice collisions."""
    values, indices, ids, collisions = _densify_stream(
        sparse_rows, cfg, cfg.padded_vocab(vocab_size), batch_size)
    index = PackedIndex(
        values=values,
        indices=indices,
        docids=np.asarray(ids, dtype=object),
        lex_dim=cfg.out_dim,
    )
    index.collisions = collisions
    return index


def densify_query_rows(
    rows: Iterable[tuple[str, dict]],
    cfg: DensifyConfig,
    vocab_size: int,
    batch_size: int = 256,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Densify query sparse vectors: ``(values f16, indices int16, qids)``."""
    values, indices, ids, _ = _densify_stream(
        rows, cfg, cfg.padded_vocab(vocab_size), batch_size)
    return values, indices.astype(np.int16), ids
