"""Offline densification: BM25 / impact front ends and the corpus densifier.

Port of ``dhr_tpu/densify_offline``.  An existing sparse model's vectors
(BM25, DeepImpact, uniCOIL, SPLADE) become ``(value, fold)`` planes that the
port's GIP search reads; host code (NumPy and the C++ runtime of
:mod:`dhr_tpu_torch.native`), except the uniCOIL query encoder, which runs
its model on the GPU unless the CPU is asked for.
"""

from dhr_tpu_torch.densify_offline.bm25 import (
    BM25Vectorizer,
    TermDictionary,
    simple_analyzer,
)
from dhr_tpu_torch.densify_offline.corpus import (
    DensifyConfig,
    densify_batch,
    densify_corpus,
    densify_query_rows,
)
from dhr_tpu_torch.densify_offline.query import (
    bm25_query_vectors,
    encoder_query_vectors,
    make_unicoil_query_encoder,
    whitespace_tf_query_vectors,
)

__all__ = [
    "BM25Vectorizer",
    "DensifyConfig",
    "TermDictionary",
    "bm25_query_vectors",
    "densify_batch",
    "densify_corpus",
    "densify_query_rows",
    "encoder_query_vectors",
    "make_unicoil_query_encoder",
    "simple_analyzer",
    "whitespace_tf_query_vectors",
]
