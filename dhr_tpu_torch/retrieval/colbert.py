"""ColBERT late-interaction scoring and full-ranking retrieval over saved
token reps.

Port of ``dhr_tpu/retrieval/colbert.py``.  Token reps are ``(N, L, D)``
with [CLS] at position 0 and masked positions zero, as
:meth:`dhr_tpu_torch.encode.Encoder.encode_tokens` (or the reference's)
writes them:

- :func:`maxsim_pairwise`: row-aligned ``sum_i max_j q_i . p_j`` over the
  non-CLS positions plus the CLS dot product;
- :func:`maxsim_listwise`: every query against every passage;
- :func:`score_pairs`: id-joined ``(qid, pid)`` pairs, in batches;
- :func:`maxsim_topk`: one query batch against a passage plane on the
  device, streamed in ``p_chunk`` slabs with a running exact top-k (the
  reference's ``_maxsim_topk_device``);
- :func:`full_ranking`: every query against every passage.  The plane stays
  on the device in its stored dtype (f16) when it fits
  ``max_plane_bytes``, else it streams in host slabs whose top-k merge
  exactly on the host.

Every product is f32: each slab is cast to f32 before it is multiplied, as
the reference does (an f16 product would round the similarities), and
TF32 stays off.  The similarities of all positions come from one GEMM;
the CLS term is its ``(0, 0)`` entry.  MaxSim is plain PyTorch: the
reference computes it outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from dhr_tpu_torch.device import resolve_device


def maxsim_pairwise(q_reps: torch.Tensor,
                    p_reps: torch.Tensor) -> torch.Tensor:
    """Row-aligned scores ``(B,)`` f32 from full reps (CLS at position 0)."""
    sim = torch.bmm(q_reps.float(), p_reps.float().transpose(1, 2))
    return sim[:, 1:, 1:].amax(-1).sum(-1) + sim[:, 0, 0]


def maxsim_listwise(q_reps: torch.Tensor,
                    p_reps: torch.Tensor) -> torch.Tensor:
    """All-pairs scores ``(B, N)`` f32 from full reps (CLS at position 0)."""
    B, Lq, D = q_reps.shape
    N, Lp, _ = p_reps.shape
    q = q_reps.float().reshape(B * Lq, D)
    p = p_reps.float().reshape(N * Lp, D)
    sim = (q @ p.T).view(B, Lq, N, Lp)
    return sim[:, 1:, :, 1:].amax(-1).sum(1) + sim[:, 0, :, 0]


def score_pairs(q_reps: np.ndarray, qids: list[str], p_reps: np.ndarray,
                pids: list[str], pairs: list[tuple[str, str]],
                batch_size: int = 256,
                device: str | torch.device | None = None) -> np.ndarray:
    """Scores ``(len(pairs),)`` f32 of explicit ``(qid, pid)`` pairs; each
    batch's rows are gathered on the host and scored on ``device``."""
    dev = resolve_device(device)
    q_row = {str(q): i for i, q in enumerate(qids)}
    p_row = {str(p): i for i, p in enumerate(pids)}
    qi = np.asarray([q_row[q] for q, _ in pairs], np.int64)
    pi = np.asarray([p_row[p] for _, p in pairs], np.int64)
    out = []
    with torch.inference_mode():
        for start in range(0, len(pairs), batch_size):
            sl = slice(start, start + batch_size)
            out.append(maxsim_pairwise(
                torch.from_numpy(q_reps[qi[sl]]).to(dev),
                torch.from_numpy(p_reps[pi[sl]]).to(dev)))
        if not out:
            return np.empty(0, np.float32)
        return torch.cat(out).cpu().numpy()


def maxsim_topk(q_reps: torch.Tensor, p_plane: torch.Tensor, topk: int,
                p_chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """One query batch against the whole plane ``p_plane`` (on the
    device), ``p_chunk`` passages at a time: ``(scores (B, topk) f32,
    rows (B, topk) int64)``, descending.

    Each slab's scores join the kept ones and a stable sort keeps the
    first ``topk``, so on equal scores the lower row wins, as the
    reference's ``lax.top_k`` over ``[kept, new]`` decides.  Only one
    ``(B * Lq, p_chunk * Lp)`` similarity block is live at a time.
    """
    B = q_reps.shape[0]
    q = q_reps.float()
    best_s = torch.empty(B, 0, dtype=torch.float32, device=q.device)
    best_r = torch.empty(B, 0, dtype=torch.int64, device=q.device)
    for s0 in range(0, p_plane.shape[0], p_chunk):
        s = maxsim_listwise(q, p_plane[s0:s0 + p_chunk])
        rows = torch.arange(s0, s0 + s.shape[1], device=q.device)
        cat_s = torch.cat([best_s, s], dim=1)
        cat_r = torch.cat([best_r, rows.expand(B, -1)], dim=1)
        order = torch.sort(cat_s, dim=1, descending=True,
                           stable=True).indices[:, :topk]
        best_s = cat_s.gather(1, order)
        best_r = cat_r.gather(1, order)
    return best_s, best_r


def full_ranking(
    q_reps: np.ndarray,
    p_reps: np.ndarray,
    topk: int = 1000,
    q_batch: int = 16,
    p_chunk: int = 512,
    max_plane_bytes: int = 4 << 30,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact MaxSim retrieval of every query against every passage:
    ``(scores (Nq, topk) f32, rows (Nq, topk) int64)``, rows as positions
    in the passage plane, descending.

    A plane within ``max_plane_bytes`` is copied to ``device`` once, in its
    stored dtype, and the query batches stream through it.  A larger one
    is cut into passage slabs of at most ``max_plane_bytes`` (a multiple
    of ``p_chunk`` rows), each ranked on the device in turn; their top-k
    lists merge on the host by a stable sort, so the result equals the
    resident plane's.
    """
    dev = resolve_device(device)
    n = p_reps.shape[0]
    topk = min(topk, n)
    if p_reps.nbytes > max_plane_bytes and n > p_chunk:
        per_row = max(1, p_reps.nbytes // n)
        slab = max(p_chunk,
                   (max_plane_bytes // per_row) // p_chunk * p_chunk)
        parts_s, parts_r = [], []
        for s0 in range(0, n, slab):
            ss, rr = full_ranking(q_reps, p_reps[s0:s0 + slab], topk=topk,
                                  q_batch=q_batch, p_chunk=p_chunk,
                                  max_plane_bytes=max_plane_bytes,
                                  device=dev)
            parts_s.append(ss)
            parts_r.append(rr + s0)
        cat_s = np.concatenate(parts_s, axis=1)
        cat_r = np.concatenate(parts_r, axis=1)
        order = np.argsort(-cat_s, axis=1, kind="stable")[:, :topk]
        return (np.take_along_axis(cat_s, order, axis=1),
                np.take_along_axis(cat_r, order, axis=1))
    nq = q_reps.shape[0]
    if nq == 0:
        return np.zeros((0, topk), np.float32), np.zeros((0, topk), np.int64)
    with torch.inference_mode():
        plane = torch.from_numpy(np.ascontiguousarray(p_reps)).to(dev)
        outs = [maxsim_topk(torch.from_numpy(q_reps[s:s + q_batch]).to(dev),
                            plane, topk, p_chunk)
                for s in range(0, nq, q_batch)]
        return (torch.cat([s for s, _ in outs]).cpu().numpy(),
                torch.cat([r for _, r in outs]).cpu().numpy())
