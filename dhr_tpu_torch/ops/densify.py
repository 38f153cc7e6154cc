"""Densification: vocabulary-space lexical vectors -> (value, fold) pairs.

Port of ``dhr_tpu/ops/densify.py``.  Drop the first ``remove_dims``
vocabulary slots, reshape the rest row-major into ``(k, out_dim)`` and
max-pool over the fold axis, remembering which fold won:

    token offset u = t - remove_dims  ->  slice u % out_dim, fold u // out_dim
    values[j]  = max_i  x[i, j]
    indices[j] = argmax_i x[i, j]          (the first maximum wins on ties)

``torch.max`` along a dim returns the first maximal index on the CPU and on
CUDA alike, as ``jnp.argmax`` does.  :func:`densify_sparse_rows` is the
host (NumPy) twin for one sparse row, the offline pipeline's fallback.
"""

from __future__ import annotations

import numpy as np
import torch

# BERT / DistilBERT wordpiece: the first 570 ids are special tokens and
# unused slots; 30522 - 570 = 29952 = 39 * 768.
WORDPIECE_REMOVE_DIMS = 570
# Per-front-end omission counts (the reference's densify_corpus.py:17-21).
REMOVE_DIMS_BY_MODEL = {
    "bm25": 472,
    "deepimpact": 502,
    "unicoil": 570,
    "splade": 570,
    "dhr": 570,
    "dlr": 570,
}


def densify(lexical_reps: torch.Tensor, out_dim: int = 768,
            remove_dims: int = WORDPIECE_REMOVE_DIMS):
    """``(..., vocab)`` -> ``(values, indices)`` of shape ``(..., out_dim)``;
    values keep the input dtype, indices are int32 in ``[0, k)`` with ``k =
    (vocab - remove_dims) // out_dim``, which must divide evenly."""
    vocab = lexical_reps.shape[-1]
    if (vocab - remove_dims) % out_dim != 0:
        raise ValueError(
            f"vocab - remove_dims = {vocab - remove_dims} not divisible by "
            f"out_dim = {out_dim}"
        )
    k = (vocab - remove_dims) // out_dim
    lead = lexical_reps.shape[:-1]
    folded = lexical_reps[..., remove_dims:].reshape(*lead, k, out_dim)
    values, indices = folded.max(dim=-2)
    return values, indices.to(torch.int32)


def undensify(values: torch.Tensor, indices: torch.Tensor, vocab_size: int,
              remove_dims: int = WORDPIECE_REMOVE_DIMS) -> torch.Tensor:
    """Scatter a densified pair back to a (lossy) vocabulary-space vector:
    only each slice's winning fold is recovered, the rest are zero."""
    out_dim = values.shape[-1]
    k = (vocab_size - remove_dims) // out_dim
    lead = values.shape[:-1]
    folded = torch.zeros(*lead, k, out_dim, dtype=values.dtype,
                         device=values.device)
    folded.scatter_(-2, indices[..., None, :].long(), values[..., None, :])
    flat = folded.reshape(*lead, k * out_dim)
    return torch.nn.functional.pad(flat, (remove_dims, 0))


def densify_sparse_rows(token_ids, weights, out_dim: int, remove_dims: int,
                        vocab_size: int):
    """One sparse row ``(token_ids, weights)`` -> ``(values f32 (out_dim,),
    indices i32 (out_dim,), n_collisions)`` on the host: each slice keeps
    its largest weight and that weight's fold, the lowest fold on ties;
    ids below ``remove_dims`` are dropped.  A collision is a token beyond
    the first landing on a slice."""
    k = (vocab_size - remove_dims) // out_dim
    values = np.zeros((out_dim,), dtype=np.float32)
    indices = np.zeros((out_dim,), dtype=np.int32)
    occupied = np.zeros((out_dim,), dtype=bool)
    token_ids = np.asarray(token_ids)
    weights = np.asarray(weights)
    keep = token_ids >= remove_dims
    token_ids = token_ids[keep]
    weights = weights[keep]
    u = token_ids - remove_dims
    slices = u % out_dim
    folds = u // out_dim
    collisions = len(slices) - len(np.unique(slices)) if len(slices) else 0
    # fold order, so the first (lowest-fold) maximum wins as in densify()
    for j in np.argsort(folds, kind="stable"):
        s, f, w = slices[j], folds[j], weights[j]
        if not occupied[s] or w > values[s]:
            values[s] = w
            indices[s] = f
            occupied[s] = True
    if folds.max(initial=0) >= k:
        raise ValueError(f"token id beyond vocab_size={vocab_size}")
    return values, indices, collisions
