"""GIP search over a :class:`DeviceIndex` on one GPU.

Port of ``dhr_tpu/retrieval/searcher.py`` in ``mode="gip"``.  Per query
batch:

1. prep (once per call, on the device): lambda-scale the CLS tail, zero the
   dims at or below ``theta`` (stage 1 only), fold the int8 scales into both
   query copies *after* thresholding, and pad the fold indices with 1 over
   the CLS dims;
2. stage 1, the theta pass: each query's top ``max_important_dims`` dims
   (all ``dim`` at theta=0) scored over every row by kernel K1
   (``ops.partial_gip``), bf16 scores when an exact rerank follows and
   ``candidate_bf16``, else f32;
3. candidate selection: exact top-``agip_topk`` per stratified slice
   (the reference's per-slice ``approx_max_k``, exact here), or one exact
   top-k;
4. stage 2 (``rerank``): exact GIP of the candidates with the
   unthresholded query by kernel K2 (``ops.rerank_gip``), then an exact
   top-``topk``.

Mode map from the reference's flags: ``--brute_force`` is theta=0;
``--theta t`` is theta=t; ``--rerank --agip_topk K`` is rerank=True,
agip_topk=K; ``--lamda`` is ``lam``.  The ip and pq modes, row chunking,
fused candidates and escalation are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import torch
import torch.nn.functional as F

from dhr_tpu_torch.device import resolve_device
from dhr_tpu_torch.ops.partial_gip import partial_gip_scores
from dhr_tpu_torch.ops.rerank_gip import rerank_gip
from dhr_tpu_torch.retrieval.index import DeviceIndex

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    topk: int = 1000
    mode: str = "gip"            # only 'gip' is ported
    theta: float = 0.0           # 0 => brute force GIP
    rerank: bool = False
    agip_topk: int = 10000
    lam: float = 1.0             # query CLS weight
    max_important_dims: int = 128  # theta-pass scan length
    query_batch: int = 64
    # stratified candidate selection when an exact rerank follows: top-(k/S)
    # of each of S column bands (see _pick_slices); False = one exact top-k
    approx_candidates: bool = True
    # bf16 stage-1 scores when an exact rerank follows (the kernel still
    # accumulates in f32; final scores always come from the f32 rerank)
    candidate_bf16: bool = True
    candidate_slices: int | str = "auto"
    # not ported yet: each raises at Searcher construction when set
    fused_candidates: bool | str = False
    escalate_pool: int = 0
    row_chunk: int = 0


def _pick_slices(candidate_slices, n_lanes: int, k_local: int) -> int:
    """Resolve the stratified-selection slice count for a score plane.

    "auto" stays at 1 unless the pool is a small fraction of the plane
    (n >= 8k): at high pool fractions the per-slice counts of true top-k
    members vary enough that slice edges visibly change the pool (measured:
    486/1600 rank rows moved at k/n = 25% on the parity fixture), while at
    bench scale (k/n ~ 0.6%) the pool recall is equal-or-better.  An
    explicit slice count skips that guard.  Then halve until each slice
    keeps >= 64 candidates and divides the lane count.
    """
    if candidate_slices == "auto":
        s = 16 if n_lanes >= 8 * k_local else 1
    else:
        s = int(candidate_slices)
    while s > 1 and (
        k_local // s < 64
        or n_lanes % s
        or (n_lanes // s) <= 2 * (k_local // s)
    ):
        s //= 2
    return max(s, 1)


def stratified_topk(scores: torch.Tensor, k: int, S: int):
    """Exact top-(k/S) of each of S equal column bands: ``(vals, rows)``
    with rows into the full plane, unordered."""
    B, n = scores.shape
    w, ks = n // S, k // S
    vals, pos = torch.topk(scores.reshape(B * S, w), ks, dim=-1,
                           sorted=False)
    off = (torch.arange(B * S, device=scores.device) % S * w)[:, None]
    return vals.reshape(B, S * ks), (pos + off).reshape(B, S * ks)


class Searcher:
    """Batched GIP searcher over a :class:`DeviceIndex`.

    ``device`` defaults to the GPU (raising without one); the index must
    live on it.  Pass ``device="cpu"`` for an index on the CPU.
    """

    def __init__(self, index: DeviceIndex, config: SearchConfig,
                 device: str | torch.device | None = None):
        dev = resolve_device(device)
        if index.device.type != dev.type:
            raise ValueError(f"the index lives on {index.device}, the "
                             f"searcher was asked to run on {dev}")
        if config.mode != "gip":
            raise NotImplementedError(
                f"mode={config.mode!r} is not ported yet (only 'gip')")
        for field, off in (("fused_candidates", False), ("escalate_pool", 0),
                           ("row_chunk", 0)):
            if getattr(config, field) != off:
                raise NotImplementedError(f"{field} is not ported yet")
        if index.indices_T is None:
            raise ValueError(
                "mode='gip' needs the dim-major planes; rebuild the "
                "DeviceIndex with layout='both' or 'dim'")
        if config.rerank and index.values is None:
            raise ValueError(
                "rerank needs the row-major planes but the index was built "
                "layout='dim'; rebuild with layout='both' or disable rerank")
        self.index = index
        self.config = config
        self.device = index.device
        n = index.num_rows
        self._k1 = min(config.agip_topk if config.rerank else config.topk, n)
        self._n_dims = (index.dim if config.theta == 0.0
                        else min(config.max_important_dims, index.dim))
        self._cand_dtype = (torch.bfloat16
                            if config.rerank and config.candidate_bf16
                            else torch.float32)
        self.last_timing = None

    # -- stages ------------------------------------------------------------

    def prepare_queries(self, query_values, query_indices=None):
        """``(qv, qv_stage1, qi)`` on the device: the rerank sees the full
        values, stage 1 the thresholded ones; both scale-folded; ``qi`` is
        int32 padded with 1 over the CLS dims."""
        cfg, idx = self.config, self.index
        lex, dim = idx.lex_dim, idx.dim
        qv = torch.as_tensor(query_values, device=self.device).float()
        if dim > lex and cfg.lam != 1.0:
            qv = torch.cat([qv[:, :lex], qv[:, lex:] * cfg.lam], dim=1)
        if query_indices is None:
            qi = torch.ones(qv.shape, dtype=torch.int32, device=self.device)
        else:
            qi = torch.as_tensor(query_indices, device=self.device).int()
            if qi.shape[1] < dim:
                qi = F.pad(qi, (0, dim - qi.shape[1]), value=1)
        # threshold first, then fold the scales, so theta means the same on
        # an int8 index as on the float one
        qv1 = torch.where(qv > cfg.theta, qv, 0.0) if cfg.theta > 0 else qv
        if idx.value_scales is not None:
            qv = qv * idx.value_scales[None, :]
            qv1 = qv1 * idx.value_scales[None, :]
        return qv.contiguous(), qv1.contiguous(), qi.contiguous()

    def stage1(self, qv1: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
        """Theta-pass scores ``(B, N)`` through kernel K1."""
        idx = self.index
        return partial_gip_scores(qv1, qi, idx.values_T, idx.indices_T,
                                  idx.lex_dim, self._n_dims, self._cand_dtype)

    def select(self, scores: torch.Tensor):
        """Stage-1 candidates ``(vals, rows)``: the rerank pool (unordered)
        or, without rerank, the exact descending top-k."""
        cfg, k = self.config, self._k1
        if cfg.rerank and cfg.approx_candidates:
            S = _pick_slices(cfg.candidate_slices, scores.shape[-1], k)
            if S > 1:
                return stratified_topk(scores, k, S)
            return torch.topk(scores, k, dim=-1, sorted=False)
        return torch.topk(scores, k, dim=-1)

    def stage2(self, qv: torch.Tensor, qi: torch.Tensor,
               cand_rows: torch.Tensor):
        """Exact rerank through kernel K2, then the exact top-``topk``."""
        idx = self.index
        scores = rerank_gip(qv, qi, cand_rows.contiguous(), idx.values,
                            idx.indices, idx.lex_dim)
        vals, pos = torch.topk(scores, min(self.config.topk, scores.shape[1]),
                               dim=-1)
        return vals, torch.gather(cand_rows, -1, pos)

    def search_batch(self, qv, qv1, qi):
        vals, rows = self.select(self.stage1(qv1, qi))
        if self.config.rerank:
            return self.stage2(qv, qi, rows)
        return vals.float(), rows

    # -- host API ------------------------------------------------------------

    def search(self, query_values, query_indices=None):
        """Search a query set; returns ``(scores f32, rows int64)`` numpy."""
        t0 = time.perf_counter()
        qv, qv1, qi = self.prepare_queries(query_values, query_indices)
        self._warn_truncated_scan(qv1)
        B, bs = qv.shape[0], self.config.query_batch
        outs = [self.search_batch(qv[s:s + bs], qv1[s:s + bs], qi[s:s + bs])
                for s in range(0, B, bs)]
        scores = torch.cat([o[0] for o in outs]).cpu().numpy()
        rows = torch.cat([o[1] for o in outs]).cpu().numpy()
        dt = time.perf_counter() - t0
        self.last_timing = {
            "queries": int(B),
            "n_batches": len(outs),
            "device": str(self.device),
            "total_s": dt,
            "qps": B / max(dt, 1e-9),
        }
        return scores, rows

    def _warn_truncated_scan(self, qv1: torch.Tensor) -> None:
        """Stage 1 scans only the top ``max_important_dims`` dims; without a
        rerank, queries with more above-theta dims rank differently from
        the reference's scan of every above-theta dim.  Say so."""
        cfg = self.config
        if not (cfg.theta > 0 and not cfg.rerank) or qv1.shape[0] == 0:
            return
        n_above = int((qv1 != 0).sum(dim=1).max())
        if n_above > self._n_dims:
            logger.warning(
                "theta=%g leaves up to %d important dims per query but "
                "max_important_dims=%d caps the stage-1 scan; rankings may "
                "diverge from the reference. Raise --max-important-dims or "
                "add --rerank.", cfg.theta, n_above, self._n_dims)

    def search_run(self, qids, query_values, query_indices=None):
        """Search returning TREC-ready ``{qid: [docid...]}, {qid: [score...]}``."""
        scores, rows = self.search(query_values, query_indices)
        docids = self.index.docids
        n = self.index.num_rows
        results, out_scores = {}, {}
        for i, qid in enumerate(qids):
            keep = rows[i] < n
            results[str(qid)] = [str(docids[j]) for j in rows[i][keep]]
            out_scores[str(qid)] = [float(x) for x in scores[i][keep]]
        return results, out_scores
