"""Padding token lists into fixed-shape encode and train batches (NumPy).

Port of ``dhr_tpu/data/collate.py``.  Corpora store ids without special
tokens; :func:`wrap_specials` adds [CLS] and [SEP] and truncates to the
length budget.  A train batch flattens each example's passages in order
(positive first) and, for margin-KD, prepends the positive's teacher score
0 to each row of ``teacher_scores``.
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


def collate_train(
    examples: list[tuple[list[int], list[list[int]], list[float] | None]],
    q_max_len: int, p_max_len: int, pad_id: int = 0,
    cls_id: int | None = None, sep_id: int | None = None,
) -> dict:
    """(query, passages, scores) examples -> one fixed-shape train batch."""
    queries = [q for q, _, _ in examples]
    passages = [p for _, ps, _ in examples for p in ps]
    batch = {
        "query": pad_token_batch(queries, q_max_len, pad_id, cls_id, sep_id),
        "passage": pad_token_batch(passages, p_max_len, pad_id, cls_id,
                                   sep_id),
    }
    if examples[0][2] is not None:
        batch["teacher_scores"] = np.asarray(
            [[0.0] + list(s) for _, _, s in examples], np.float32)
    return batch


def collate_train_packed(
    examples: list[tuple[list[int], list[list[int]], list[float] | None]],
    q_max_len: int, p_max_len: int,
    pack_rows: int, pack_segments: int,
    pad_id: int = 0,
    cls_id: int | None = None, sep_id: int | None = None,
) -> dict:
    """Train batch with the passage tower token-packed.

    Queries collate as in :func:`collate_train`; passages pack several to a
    row of ``p_max_len`` under ``pack_rows`` rows.  The batch carries
    ``packed_passage`` instead of ``passage``: the packed id / segment /
    position / seg_start arrays plus ``slot_pos``, where passage k (in the
    plain flatten order the loss expects) sits at flat slot ``slot_pos[k]``
    of the ``(pack_rows * pack_segments,)`` per-slot outputs.  A batch whose
    plan needs more than ``pack_rows`` rows falls back to one passage a row
    (``num_passages`` rows).
    """
    from dhr_tpu_torch.encode import collate_packed, plan_packing

    queries = [q for q, _, _ in examples]
    passages = [p for _, ps, _ in examples for p in ps]
    rows = plan_packing(
        [len(t) + (cls_id is not None) + (sep_id is not None)
         for t in passages],
        p_max_len, pack_segments,
    )
    if len(rows) > pack_rows:
        rows = [[i] for i in range(len(passages))]
        pack_rows = len(passages)
    packed = collate_packed(rows, list(range(len(passages))), passages,
                            pack_rows, p_max_len, pack_segments, cls_id,
                            sep_id)
    slot_pos = np.zeros(len(passages), np.int32)
    for r, row in enumerate(rows):
        for s, item in enumerate(row):
            slot_pos[item] = r * pack_segments + s
    batch = {
        "query": pad_token_batch(queries, q_max_len, pad_id, cls_id, sep_id),
        "packed_passage": {
            "input_ids": packed["input_ids"],
            "segment_ids": packed["segment_ids"],
            "position_ids": packed["position_ids"],
            "seg_start": packed["seg_start"],
            "slot_pos": slot_pos,
        },
    }
    if examples[0][2] is not None:
        batch["teacher_scores"] = np.asarray(
            [[0.0] + list(s) for _, _, s in examples], np.float32)
    return batch
