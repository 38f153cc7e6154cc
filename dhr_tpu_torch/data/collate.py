"""Padding token lists into encode batches (NumPy).

Port of the encode path's part of ``dhr_tpu/data/collate.py``.  Corpora
store ids without special tokens; :func:`wrap_specials` adds [CLS] and
[SEP] and truncates to the length budget.
"""

from __future__ import annotations

import numpy as np


def wrap_specials(
    tokens: list[int], max_len: int,
    cls_id: int | None = None, sep_id: int | None = None,
) -> list[int]:
    """[CLS] + tokens + [SEP], truncated so the total fits ``max_len``."""
    budget = max_len - (cls_id is not None) - (sep_id is not None)
    t = list(tokens[:budget])
    if cls_id is not None:
        t = [cls_id] + t
    if sep_id is not None:
        t = t + [sep_id]
    return t or [0]


def pad_token_batch(
    token_lists: list[list[int]], max_len: int, pad_id: int = 0,
    cls_id: int | None = None, sep_id: int | None = None,
) -> dict[str, np.ndarray]:
    """Pad ragged token-id lists to ``(B, max_len)`` ids + attention mask,
    optionally wrapping each row in special tokens first."""
    B = len(token_lists)
    input_ids = np.full((B, max_len), pad_id, np.int32)
    mask = np.zeros((B, max_len), np.int32)
    for i, toks in enumerate(token_lists):
        t = wrap_specials(toks, max_len, cls_id, sep_id)
        input_ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return {"input_ids": input_ids, "attention_mask": mask}


def collate_encode(
    ids: list, token_lists: list[list[int]], max_len: int, pad_id: int = 0
) -> dict:
    b = pad_token_batch(token_lists, max_len, pad_id)
    b["ids"] = list(ids)
    return b
