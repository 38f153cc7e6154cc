"""ctypes bindings for the C++ host runtime
(``dhr_tpu_torch/native_src/dhr_native.cpp``).

The library is built on demand with g++ and cached as
``libdhr_torch_native.so`` — into ``build/`` next to the package in a
writable source checkout, else into ``~/.cache/dhr_tpu_torch`` — a name of
its own, so this package and ``dhr_tpu`` never load each other's library.
Every entry point has a pure-Python fallback, so the package works without
a compiler (``available()`` reports which path is active).

Entry points: :func:`load_tokenized_corpus_native` (JSONL corpus -> CSR),
:func:`bm25_csr` (Lucene-flavour BM25 weights), :func:`densify_csr`
(fold-max densification), :func:`merge_topk_shards` (k-way merge of
per-shard top-k lists) and :func:`plan_packing_native` (the token-packing
planner).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "native_src", "dhr_native.cpp")
_LIB_NAME = "libdhr_torch_native.so"


def _so_path() -> str:
    # build/ next to the package ONLY in a source checkout (pyproject.toml
    # beside the package marks one): a writable venv site-packages must not
    # gain a stray top-level build/ directory that pip uninstall never
    # removes
    parent = os.path.dirname(_PKG)
    if (os.path.isfile(os.path.join(parent, "pyproject.toml"))
            and os.access(parent, os.W_OK)):
        return os.path.join(parent, "build", _LIB_NAME)
    return os.path.join(
        os.path.expanduser("~"), ".cache", "dhr_tpu_torch", _LIB_NAME)


_SO = _so_path()

_lib = None
_tried = False


class _CorpusStruct(ctypes.Structure):
    _fields_ = [
        ("n_docs", ctypes.c_int64),
        ("n_tokens", ctypes.c_int64),
        ("ids_buf", ctypes.POINTER(ctypes.c_char)),
        ("ids_len", ctypes.c_int64),
        ("id_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("tokens", ctypes.POINTER(ctypes.c_int32)),
        ("token_offsets", ctypes.POINTER(ctypes.c_int64)),
    ]


def _build() -> str | None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
    except (subprocess.SubprocessError, FileNotFoundError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    os.replace(tmp, _SO)  # a concurrent loader never sees a half-written .so
    return _SO


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # rebuild when the source is newer than the cached .so (a stale library
    # raises AttributeError at symbol binding for entry points added since)
    fresh = (
        os.path.exists(_SO)
        and (not os.path.exists(_SRC)
             or os.path.getmtime(_SO) >= os.path.getmtime(_SRC))
    )
    so = _SO if fresh else _build()
    for attempt in range(2):
        if so is None:
            return None
        try:
            _lib = _bind(ctypes.CDLL(so))
            return _lib
        except (OSError, AttributeError):
            # corrupt or out-of-date .so despite the mtime check: one
            # forced rebuild, then the Python fallbacks
            _lib = None
            so = _build() if attempt == 0 else None
    return None


def _bind(lib):
    lib.dhr_load_corpus.restype = ctypes.POINTER(_CorpusStruct)
    lib.dhr_load_corpus.argtypes = [ctypes.c_char_p]
    lib.dhr_free_corpus.argtypes = [ctypes.POINTER(_CorpusStruct)]
    lib.dhr_free_corpus.restype = None
    lib.dhr_bm25_df.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dhr_bm25_df.restype = None
    lib.dhr_bm25_weights.restype = ctypes.c_int64
    lib.dhr_bm25_weights.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.c_double, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.dhr_densify_csr.restype = ctypes.c_int64
    lib.dhr_densify_csr.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dhr_merge_topk.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dhr_merge_topk.restype = None
    lib.dhr_plan_packing.restype = ctypes.c_int64
    lib.dhr_plan_packing.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def available() -> bool:
    """True when the C++ library is built and bound (else the Python
    fallbacks run)."""
    return _load() is not None


def so_path() -> str | None:
    """The loaded library's path, or None on the Python fallbacks."""
    return _SO if available() else None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# --------------------------------------------------------------------------
# corpus loading
# --------------------------------------------------------------------------


def load_tokenized_corpus_native(path: str):
    """JSONL ``{"text_id", "text": [ids]}`` -> ``(ids list, tokens i32,
    token_offsets i64)``.  Falls back to Python's json reader, returning the
    same CSR layout (an empty text stays empty, as in the C++ parser)."""
    lib = _load()
    if lib is None:
        from dhr_tpu_torch.data.examples import read_jsonl

        rows = list(read_jsonl(path))
        ids = [str(r["text_id"]) for r in rows]
        texts = [r["text"] for r in rows]
        offsets = np.zeros(len(texts) + 1, np.int64)
        np.cumsum([len(t) for t in texts], out=offsets[1:])
        tokens = np.fromiter(
            (t for doc in texts for t in doc), np.int32, int(offsets[-1])
        )
        return ids, tokens, offsets

    c = lib.dhr_load_corpus(path.encode())
    if not c:
        raise FileNotFoundError(path)
    try:
        s = c.contents
        n = s.n_docs
        id_offsets = np.ctypeslib.as_array(s.id_offsets, shape=(n + 1,)).copy()
        ids_raw = ctypes.string_at(s.ids_buf, s.ids_len)
        ids = [
            ids_raw[id_offsets[i]: id_offsets[i + 1]].decode()
            for i in range(n)
        ]
        tokens = np.ctypeslib.as_array(
            s.tokens, shape=(max(int(s.n_tokens), 1),)
        )[: s.n_tokens].copy()
        offsets = np.ctypeslib.as_array(
            s.token_offsets, shape=(n + 1,)
        ).copy()
        return ids, tokens, offsets
    finally:
        lib.dhr_free_corpus(c)


# --------------------------------------------------------------------------
# BM25
# --------------------------------------------------------------------------


def bm25_csr(tokens: np.ndarray, offsets: np.ndarray, vocab: int,
             k1: float = 0.9, b: float = 0.4):
    """BM25 weights for a CSR corpus of mapped term ids (ids outside
    ``[0, vocab)`` are skipped).

    Returns ``(tids i32, weights f32, out_offsets i64, df i64)``; each
    document's terms come out in ascending id order.
    """
    tokens = np.ascontiguousarray(tokens, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_docs = len(offsets) - 1
    df = np.zeros(vocab, np.int64)
    lib = _load()
    if lib is None:
        return _bm25_csr_py(tokens, offsets, vocab, k1, b, df)
    total = ctypes.c_int64(0)
    lib.dhr_bm25_df(
        _ptr(tokens, ctypes.c_int32), _ptr(offsets, ctypes.c_int64),
        n_docs, vocab, _ptr(df, ctypes.c_int64), ctypes.byref(total),
    )
    avgdl = total.value / max(n_docs, 1)
    cap = len(tokens) + 1
    out_tids = np.zeros(cap, np.int32)
    out_w = np.zeros(cap, np.float32)
    out_off = np.zeros(n_docs + 1, np.int64)
    written = lib.dhr_bm25_weights(
        _ptr(tokens, ctypes.c_int32), _ptr(offsets, ctypes.c_int64),
        n_docs, _ptr(df, ctypes.c_int64), vocab, avgdl, n_docs, k1, b,
        _ptr(out_tids, ctypes.c_int32), _ptr(out_w, ctypes.c_float),
        _ptr(out_off, ctypes.c_int64), cap,
    )
    if written < 0:
        raise RuntimeError("dhr_bm25_weights overflowed its output buffer")
    return out_tids[:written], out_w[:written], out_off, df


def _bm25_csr_py(tokens, offsets, vocab, k1, b, df):
    n_docs = len(offsets) - 1
    total = 0
    docs = []
    for d in range(n_docs):
        doc = tokens[offsets[d]: offsets[d + 1]]
        total += len(doc)
        docs.append(doc)
        for t in np.unique(doc):
            if 0 <= t < vocab:
                df[t] += 1
    avgdl = total / max(n_docs, 1)
    out_tids, out_w, out_off = [], [], [0]
    for doc in docs:
        uniq, tf = np.unique(doc[(doc >= 0) & (doc < vocab)],
                             return_counts=True)
        norm = 1.0 - b + b * len(doc) / max(avgdl, 1e-9)
        idf = np.log(1.0 + (n_docs - df[uniq] + 0.5) / (df[uniq] + 0.5))
        w = idf * tf * (k1 + 1.0) / (tf + k1 * norm)
        out_tids.extend(uniq.tolist())
        out_w.extend(w.tolist())
        out_off.append(len(out_tids))
    return (np.asarray(out_tids, np.int32), np.asarray(out_w, np.float32),
            np.asarray(out_off, np.int64), df)


# --------------------------------------------------------------------------
# densify
# --------------------------------------------------------------------------


def densify_csr(tids, weights, offsets, omission: int, out_dim: int,
                vocab: int):
    """CSR sparse vectors -> ``(values f32 (N, d), indices i32 (N, d),
    collisions)``: each slice keeps its largest weight and that weight's
    fold, ties to the lowest fold when each row's tids ascend."""
    tids = np.ascontiguousarray(tids, np.int32)
    weights = np.ascontiguousarray(weights, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_docs = len(offsets) - 1
    values = np.zeros((n_docs, out_dim), np.float32)
    indices = np.zeros((n_docs, out_dim), np.int32)
    lib = _load()
    if lib is None:
        from dhr_tpu_torch.ops.densify import densify_sparse_rows

        collisions = 0
        for d in range(n_docs):
            sl = slice(offsets[d], offsets[d + 1])
            v, ix, c = densify_sparse_rows(
                tids[sl], weights[sl], out_dim, omission, vocab
            )
            values[d], indices[d] = v, ix
            collisions += c
        return values, indices, collisions
    collisions = lib.dhr_densify_csr(
        _ptr(tids, ctypes.c_int32), _ptr(weights, ctypes.c_float),
        _ptr(offsets, ctypes.c_int64), n_docs, omission, out_dim, vocab,
        _ptr(values, ctypes.c_float), _ptr(indices, ctypes.c_int32),
    )
    return values, indices, int(collisions)


# --------------------------------------------------------------------------
# top-k shard merge
# --------------------------------------------------------------------------


def merge_topk_shards(scores: np.ndarray, ids: np.ndarray, k_out: int):
    """(S, B, K) score/id shards -> global (B, k_out), descending score,
    ties to the lower id; slots past the S*K candidates hold -inf / -1."""
    scores = np.ascontiguousarray(scores, np.float32)
    ids = np.ascontiguousarray(ids, np.int64)
    S, B, K = scores.shape
    out_s = np.full((B, k_out), -np.inf, np.float32)
    out_i = np.full((B, k_out), -1, np.int64)
    lib = _load()
    if lib is None:
        flat_s = scores.transpose(1, 0, 2).reshape(B, S * K)
        flat_i = ids.transpose(1, 0, 2).reshape(B, S * K)
        order = np.lexsort((flat_i, -flat_s), axis=1)[:, :k_out]
        k = order.shape[1]
        out_s[:, :k] = np.take_along_axis(flat_s, order, 1)
        out_i[:, :k] = np.take_along_axis(flat_i, order, 1)
        return out_s, out_i
    lib.dhr_merge_topk(
        _ptr(scores, ctypes.c_float), _ptr(ids, ctypes.c_int64),
        S, B, K, k_out,
        _ptr(out_s, ctypes.c_float), _ptr(out_i, ctypes.c_int64),
    )
    return out_s, out_i


def plan_packing_native(lengths, row_len: int, max_segments: int):
    """C++ twin of :func:`dhr_tpu_torch.encode.plan_packing` (the same plan
    item for item); None when the library is unavailable.

    Returns ``(items, row_offsets)`` int64 arrays — row ``r`` packs original
    item indices ``items[row_offsets[r]:row_offsets[r+1]]`` in slot order.
    """
    lib = _load()
    if lib is None:
        return None
    lengths = np.ascontiguousarray(
        np.clip(np.asarray(lengths, np.int64), 1, row_len)
    )
    n = len(lengths)
    items = np.zeros(n, np.int64)
    offsets = np.zeros(n + 1, np.int64)
    n_rows = lib.dhr_plan_packing(
        _ptr(lengths, ctypes.c_int64), n, row_len, max_segments,
        _ptr(items, ctypes.c_int64), _ptr(offsets, ctypes.c_int64),
    )
    return items, offsets[: n_rows + 1]
