"""BM25 term weighting over a term-frequency store (the Lucene stand-in).

Port of ``dhr_tpu/densify_offline/bm25.py``:

- :class:`TermDictionary`: term -> contiguous id (sorted order), document
  frequencies, collection stats.
- :class:`BM25Vectorizer`: per-document ``{term_id: weight}`` sparse vectors
  with Lucene's BM25 (k1=0.9, b=0.4, pyserini's defaults;
  idf = ln(1 + (N - df + 0.5) / (df + 0.5))).

Terms may be strings (whole-word models: bm25, deepimpact) or wordpiece ids
(unicoil, splade); ids pass through unchanged.  For a whole corpus,
:func:`dhr_tpu_torch.native.bm25_csr` computes the same weights over mapped
term ids in one C++ pass.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from collections.abc import Iterable

# [^\W_] is exactly str.isalnum(): re's \w is isalnum() plus "_"
_WORD = re.compile(r"[^\W_]+")


class TermDictionary:
    """Term ids and document frequencies built from a tokenized corpus."""

    def __init__(self):
        self.df: Counter = Counter()
        self.num_docs = 0
        self.total_terms = 0
        self._term2id: dict | None = None

    def add_document(self, terms: Iterable) -> None:
        terms = list(terms)
        self.num_docs += 1
        self.total_terms += len(terms)
        self.df.update(set(terms))

    def build(self, reserve: int = 0) -> None:
        """Freeze the dictionary; ids are ``reserve + rank`` in sorted order.

        ``reserve`` is the front end's omission offset: ids below it are
        never assigned, so densification drops them uniformly.
        """
        self._term2id = {
            t: reserve + i for i, t in enumerate(sorted(map(str, self.df)))
        }

    @property
    def vocab_size(self) -> int:
        if self._term2id is None:
            raise ValueError("call build() first")
        if not self._term2id:
            return 0
        return max(self._term2id.values()) + 1

    def term_id(self, term) -> int | None:
        return self._term2id.get(str(term))

    @property
    def avg_doc_len(self) -> float:
        return self.total_terms / max(self.num_docs, 1)


class BM25Vectorizer:
    """Lucene-flavour BM25 weights: ``idf * tf*(k1+1) / (tf + k1*norm)``."""

    def __init__(self, dictionary: TermDictionary, k1: float = 0.9,
                 b: float = 0.4):
        self.dic = dictionary
        self.k1 = k1
        self.b = b

    def idf(self, term) -> float:
        df = self.dic.df.get(term, 0) or self.dic.df.get(str(term), 0)
        n = self.dic.num_docs
        return math.log(1.0 + (n - df + 0.5) / (df + 0.5))

    def doc_vector(self, terms: Iterable) -> dict[int, float]:
        """Sparse ``{term_id: bm25_weight}`` of one document."""
        terms = list(terms)
        tf = Counter(terms)
        dl = len(terms)
        norm = 1.0 - self.b + self.b * dl / max(self.dic.avg_doc_len, 1e-9)
        out = {}
        for term, f in tf.items():
            tid = self.dic.term_id(term)
            if tid is None:
                continue
            out[tid] = (self.idf(term) * f * (self.k1 + 1.0)
                        / (f + self.k1 * norm))
        return out

    def query_vector(self, terms: Iterable) -> dict[int, float]:
        """Query-side weights: the analyzed term frequencies."""
        out = {}
        for term, f in Counter(terms).items():
            tid = self.dic.term_id(term)
            if tid is not None:
                out[tid] = float(f)
        return out


def simple_analyzer(text: str) -> list[str]:
    """Lowercase, then split into maximal runs of alphanumeric characters
    (``str.isalnum``): a stand-in for Lucene's EnglishAnalyzer when raw
    text, not pre-analyzed terms, is supplied."""
    return _WORD.findall(text.lower())
