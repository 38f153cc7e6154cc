"""Query-side sparse vectors, per front end.

Port of ``dhr_tpu/densify_offline/query.py``:

- bm25: analyzed term frequencies over the corpus term dictionary;
- deepimpact: whitespace term frequencies;
- unicoil / splade: weights from a query encoder callable (any
  ``encode(text) -> {token: weight}``; :func:`make_unicoil_query_encoder`
  builds one from the port's agg-family model).
"""

from __future__ import annotations

from collections import Counter
from collections.abc import Callable, Iterator

import torch

from dhr_tpu_torch.densify_offline.bm25 import BM25Vectorizer, simple_analyzer
from dhr_tpu_torch.device import resolve_device


def bm25_query_vectors(
    queries: list[tuple[str, str]],
    vectorizer: BM25Vectorizer,
    analyzer: Callable[[str], list[str]] = simple_analyzer,
) -> Iterator[tuple[str, dict]]:
    for qid, text in queries:
        yield qid, vectorizer.query_vector(analyzer(text))


def whitespace_tf_query_vectors(
    queries: list[tuple[str, str]],
    term_id: Callable[[str], int | None],
) -> Iterator[tuple[str, dict]]:
    """DeepImpact-style: raw whitespace term frequency."""
    for qid, text in queries:
        vec = {}
        for term, f in Counter(text.split()).items():
            tid = term_id(term)
            if tid is not None:
                vec[tid] = float(f)
        yield qid, vec


def make_unicoil_query_encoder(model, tokenizer, max_len: int = 64,
                               cls_id: int | None = 101,
                               device: str | torch.device | None = None):
    """A uniCOIL-style query encoder ``text -> {token_id: weight}`` from the
    port's model.

    uniCOIL gives each query token a learned scalar weight at its own vocab
    position: the skip-MLM lexical rep of the agg family (scatter-max of
    the term-weight head at the input token ids), so any agg ``BiEncoder``
    built with ``skip_mlm=True`` serves.  The model runs on ``device``, the
    GPU unless ``"cpu"`` is given.  Weights <= 0 are dropped.
    """
    from dhr_tpu_torch.models.transformer import compute_copy

    cfg = model.cfg
    dev = resolve_device(device)
    encoder = compute_copy(model, cfg.encoder.dtype, dev).eval().encoder_q

    def encode(text: str) -> dict:
        ids = tokenizer.encode(
            text, add_special_tokens=False, max_length=max_len,
            truncation=True) or [0]
        if cls_id is not None:
            ids = [cls_id] + ids
        t = torch.tensor([ids], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            lex = encoder(t, torch.ones_like(t), is_query=True).lexical[0]
        lex = lex.float().cpu().numpy()
        terms = set(ids[1:] if cls_id is not None else ids)
        return {int(t): float(lex[t]) for t in terms if lex[t] > 0}

    return encode


def encoder_query_vectors(
    queries: list[tuple[str, str]],
    encoder: Callable[[str], dict],
    token_to_id: Callable[[str], int | None] | None = None,
) -> Iterator[tuple[str, dict]]:
    """uniCOIL / SPLADE-style: weights from a learned query encoder."""
    for qid, text in queries:
        raw = encoder(text)
        if token_to_id is None:
            yield qid, {int(t): float(w) for t, w in raw.items()}
        else:
            vec = {}
            for tok, w in raw.items():
                tid = token_to_id(tok)
                if tid is not None:
                    vec[tid] = float(w)
            yield qid, vec
