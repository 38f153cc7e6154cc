"""Index and query diagnostics (NumPy over a :class:`PackedIndex`).

Port of ``dhr_tpu/retrieval/stats.py``: index density, the mean number of
query dims above theta (the theta pass's work per query), and fold usage
over the fold planes (how evenly folds win their slices).
"""

from __future__ import annotations

import numpy as np


def index_stats(packed) -> dict:
    values = np.asarray(packed.values, np.float32)
    out = {
        "rows": int(packed.num_rows),
        "dim": int(packed.dim),
        "lex_dim": int(packed.lex_dim),
        "density": float((values != 0).mean()),
        "value_mean": float(values.mean()),
        "value_absmax": float(np.abs(values).max()),
        "bytes_values": int(packed.values.nbytes),
        "bytes_indices": 0 if packed.indices is None else int(
            packed.indices.nbytes
        ),
    }
    if packed.indices is not None:
        folds, counts = np.unique(np.asarray(packed.indices),
                                  return_counts=True)
        frac = counts / counts.sum()
        out["fold_usage"] = {
            "n_folds_used": int(len(folds)),
            "max_fraction": float(frac.max()),
            "entropy_bits": float(-(frac * np.log2(frac)).sum()),
        }
    return out


def avg_important_dims(query_values: np.ndarray, theta: float,
                       lex_dim: int | None = None) -> float:
    """Mean number of query dims above theta (the theta-pass work per
    query)."""
    qv = np.asarray(query_values, np.float32)
    if lex_dim is not None:
        qv = qv[:, :lex_dim]
    return float((qv > theta).sum(axis=1).mean())
