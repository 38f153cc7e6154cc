"""GIP / IP / PQ search over a :class:`DeviceIndex` on one GPU.

Port of ``dhr_tpu/retrieval/searcher.py``.  Per query batch:

1. prep (once per call, on the device): lambda-scale the CLS tail, zero the
   dims at or below ``theta`` (gip mode, stage 1 only), fold the int8
   scales into both query copies *after* thresholding (pq mode: into the
   rerank copy only, see ``prepare_queries``), and pad the fold indices
   with 1 over the CLS dims;
2. stage 1, one of
   - gip: the theta pass, each query's top ``max_important_dims`` dims
     (all ``dim`` at theta=0) scored over every row by kernel K1
     (``ops.partial_gip``), bf16 scores when an exact rerank follows and
     ``candidate_bf16``, else f32;
   - gip, ``fused_candidates``: the same theta pass reduced per group of
     ``candidate_block`` rows by kernel K3 (``ops.gip_candidates``); the
     ``(B, N)`` plane is never written;
   - ip: one inner product over the dim-major or row-major value plane
     (a library GEMM, bf16 x bf16 -> f32 or f32; the reference leaves it
     to XLA too), row-chunked on the row-major plane (``row_chunk``);
   - pq: ADC scores of the PQ codes (``ops.pq``);
3. candidate selection: exact top-``agip_topk`` per stratified slice (the
   reference's per-slice ``approx_max_k``, exact here), or one exact top-k;
4. stage 2 (``rerank``, lexical planes only): exact GIP of the candidates
   with the unthresholded query by kernel K2 (``ops.rerank_gip``), then an
   exact top-``topk``;
5. two-tier escalation (``escalate_pool``): queries whose reranked
   ``topk``-th score lies within ``escalate_margin`` of the stage-1 pool
   floor search again at the full ``agip_topk``.

Mode map from the reference's flags: ``--brute_force`` is theta=0;
``--theta t`` is theta=t; ``--IP`` is mode='ip'; ``--PQIP`` is mode='pq';
``--rerank --agip_topk K`` is rerank=True, agip_topk=K; ``--lamda`` is
``lam``.  A dense index (no fold planes) searches by inner product in any
mode but pq.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch
import torch.nn.functional as F

from dhr_tpu_torch.device import resolve_device
from dhr_tpu_torch.ops.gip_candidates import (
    decode_packed_candidates,
    partial_gip_candidates,
)
from dhr_tpu_torch.ops.partial_gip import partial_gip_scores
from dhr_tpu_torch.ops.pq import pq_ip_scores, pq_luts
from dhr_tpu_torch.ops.rerank_gip import rerank_gip
from dhr_tpu_torch.retrieval.index import DeviceIndex

logger = logging.getLogger(__name__)

MODES = ("gip", "ip", "pq")
_IP_BLOCK_ROWS = 1 << 18  # rows of a non-bf16 plane converted per ip GEMM


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    topk: int = 1000
    mode: str = "gip"            # 'gip' | 'ip' | 'pq'
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
    # fused candidate selection through K3: True / False / "auto" (auto =
    # on when the reduced plane holds 2x the pool and approx_candidates);
    # only with rerank over the gip planes and candidate_block > 1
    fused_candidates: bool | str = False
    candidate_block: int = 8
    # two-tier escalation: tier-1 pool size (0 = off) and trigger margin
    escalate_pool: int = 0
    escalate_margin: float = 0.0
    # row-chunked ip stage 1 on the row-major plane: 0 auto (chunk above
    # ~2M rows), -1 off, >0 target rows per chunk
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


def _pick_row_chunks(row_chunk: int, n_rows: int) -> int:
    """Chunk count J of the row-chunked ip stage 1 (``row_chunk``).

    Auto chunks only above ~2M rows, targeting <= 512k rows per chunk.
    J = ceil(n_rows / target); the remainder past J equal chunks is one
    tail slice, so any row count chunks (MS MARCO's 8,841,823 is prime).
    """
    if row_chunk < 0 or n_rows <= 0:
        return 1
    if row_chunk == 0:
        if n_rows <= (1 << 21):
            return 1
        target = 512 * 1024
    else:
        target = row_chunk
    if n_rows <= target:
        return 1
    return -(-n_rows // target)


def _row_chunk_split(n_rows: int, J: int) -> tuple[int, int]:
    """``(chunk, main)``: J chunks of ``chunk`` rows cover ``main`` rows,
    ``n_rows - main`` is the tail.  Chunks align down to 512 rows when
    large."""
    chunk = n_rows // J
    if chunk >= 1024:
        chunk -= chunk % 512
    return chunk, J * chunk


def _bf16_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 ``a @ w`` with f32 accumulation and an f32 result: one tensor
    core GEMM on the GPU; the CPU, which has no bf16 -> f32 GEMM, widens
    the operands (exact) and multiplies in f32."""
    if a.device.type == "cuda":
        return torch.mm(a, w, out_dtype=torch.float32)
    return a.float() @ w.float()


def _ip_scores(qv: torch.Tensor, plane: torch.Tensor,
               row_major: bool) -> torch.Tensor:
    """``(B, D) x (D, N)`` (dim-major) or ``(B, D) x (N, D)`` (row-major)
    -> ``(B, N)`` f32, with the reference's precision: f32 planes multiply
    in f32 (TF32 stays off, PyTorch's default); other planes multiply as
    bf16 x bf16 -> f32, the reference's product (int8 and bf16 values are
    exact in bf16, f16 rounds to it).  The GPU reads a bf16 plane in place;
    other planes (and every plane on the CPU) convert ``_IP_BLOCK_ROWS``
    rows at a time, so the temporary is one block, never a copy of the
    plane."""
    if plane.dtype == torch.float32:
        return qv.float() @ (plane.T if row_major else plane)
    a = qv.to(torch.bfloat16)
    n = plane.shape[0] if row_major else plane.shape[1]
    if plane.dtype == torch.bfloat16 and plane.device.type == "cuda":
        return _bf16_mm(a, plane.T if row_major else plane)
    out = torch.empty(a.shape[0], n, dtype=torch.float32, device=a.device)
    for s in range(0, n, _IP_BLOCK_ROWS):
        e = min(s + _IP_BLOCK_ROWS, n)
        w = (plane[s:e].T if row_major else plane[:, s:e]).to(torch.bfloat16)
        out[:, s:e] = _bf16_mm(a, w)
    return out


class Searcher:
    """Batched searcher over a :class:`DeviceIndex`.

    ``device`` defaults to the GPU (raising without one); the index must
    live on it.  Pass ``device="cpu"`` for an index on the CPU.
    """

    def __init__(self, index: DeviceIndex, config: SearchConfig,
                 device: str | torch.device | None = None):
        dev = resolve_device(device)
        if index.device.type != dev.type:
            raise ValueError(f"the index lives on {index.device}, the "
                             f"searcher was asked to run on {dev}")
        cfg = config
        if cfg.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}; got {cfg.mode!r}")
        if cfg.mode == "pq" and index.pq_codes is None:
            raise ValueError(
                "mode='pq' needs a PQ-quantized index (PackedIndex."
                "quantize_pq / 'index --pq-m')")
        if (cfg.mode == "gip" and index.indices_T is None
                and index.indices is not None):
            raise ValueError(
                "mode='gip' needs the dim-major planes but the index was "
                "built layout='row'; rebuild with layout='both' (or use "
                "mode='ip'/'pq' candidates, which score row-major)")
        if cfg.rerank and index.values is None:
            raise ValueError(
                "rerank needs the row-major planes but the index was built "
                "layout='dim'; rebuild with layout='both' or disable rerank")
        self._tier2 = None
        if cfg.escalate_pool:
            if not cfg.rerank:
                raise ValueError("escalate_pool needs rerank=True (the "
                                 "trigger compares reranked scores to the "
                                 "stage-1 pool floor)")
            if index.indices is None:
                raise ValueError(
                    "escalate_pool needs an index with lexical index "
                    "planes: a dense (indices=None) index has no rerank "
                    "stage, so there is no tier-2 to escalate to")
            if not cfg.topk <= cfg.escalate_pool < cfg.agip_topk:
                raise ValueError(
                    f"escalate_pool={cfg.escalate_pool} must lie in "
                    f"[topk={cfg.topk}, agip_topk={cfg.agip_topk})")
            # tier 2: the full-pool searcher over the same planes
            self._tier2 = Searcher(
                index, dataclasses.replace(cfg, escalate_pool=0), device=dev)
        self.index = index
        self.config = cfg
        self.device = index.device
        self.escalated_queries = 0  # cumulative over calls
        self.last_timing = None
        n = index.num_rows
        self._has_gip = index.indices_T is not None and cfg.mode == "gip"
        # a dense index has no rerank stage (the reference's stage 2 is
        # None there); stage 1 then returns the pool
        self._rerank = cfg.rerank and index.indices is not None
        pool = cfg.escalate_pool or cfg.agip_topk
        self._k1 = min(pool if cfg.rerank else cfg.topk, n)
        self._n_dims = (index.dim if cfg.theta == 0.0
                        else min(cfg.max_important_dims, index.dim))
        self._cand_dtype = (torch.bfloat16
                            if cfg.rerank and cfg.candidate_bf16
                            else torch.float32)
        G = cfg.candidate_block
        self._fused = bool(
            cfg.fused_candidates in (True, "auto")
            and cfg.rerank and self._has_gip and G > 1
            # "auto" respects exact candidates (block reduction breaks
            # candidate recall 1.0); an explicit True overrides
            and (cfg.approx_candidates or cfg.fused_candidates is True)
            # every candidate is a distinct group winner
            and n // G >= (self._k1 if cfg.fused_candidates is True
                           else 2 * self._k1))
        self._packed_ids = G & (G - 1) == 0
        self._row_major_ip = (not self._has_gip and cfg.mode != "pq"
                              and index.values_T is None)
        self._row_chunks = (_pick_row_chunks(cfg.row_chunk, n)
                            if self._row_major_ip else 1)

    # -- stages ------------------------------------------------------------

    def prepare_queries(self, query_values, query_indices=None):
        """``(qv, qv_stage1, qi)`` on the device: the rerank sees the full
        values, stage 1 the thresholded ones (gip mode only: ip and pq run
        the full inner product, as the reference's IP mode does); both
        scale-folded, except that pq's stage-1 copy stays unfolded because
        its tables come from float centroids; ``qi`` is int32 padded with 1
        over the CLS dims."""
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
        qv1 = qv
        if cfg.theta > 0 and cfg.mode == "gip":
            qv1 = torch.where(qv > cfg.theta, qv, 0.0)
        if idx.value_scales is not None:
            qv = qv * idx.value_scales[None, :]
            if cfg.mode != "pq":
                qv1 = qv1 * idx.value_scales[None, :]
        return qv.contiguous(), qv1.contiguous(), qi.contiguous()

    def stage1(self, qv1: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
        """Stage-1 scores ``(B, N)``: K1 (gip), an inner product (ip) or
        ADC (pq)."""
        cfg, idx = self.config, self.index
        if cfg.mode == "pq":
            return pq_ip_scores(pq_luts(qv1, idx.pq_centroids), idx.pq_codes)
        if self._has_gip:
            return partial_gip_scores(qv1, qi, idx.values_T, idx.indices_T,
                                      idx.lex_dim, self._n_dims,
                                      self._cand_dtype)
        if self._row_major_ip:
            return _ip_scores(qv1, idx.values, row_major=True)
        return _ip_scores(qv1, idx.values_T, row_major=False)

    def select(self, scores: torch.Tensor):
        """Stage-1 candidates ``(vals, rows)``: the rerank pool (unordered)
        or, without rerank, the exact descending top-k."""
        cfg = self.config
        k = min(self._k1, scores.shape[-1])
        if cfg.rerank and cfg.approx_candidates:
            S = _pick_slices(cfg.candidate_slices, scores.shape[-1], k)
            if S > 1:
                return stratified_topk(scores, k, S)
            return torch.topk(scores, k, dim=-1, sorted=False)
        return torch.topk(scores, k, dim=-1)

    def fused_stage1(self, qv1: torch.Tensor, qi: torch.Tensor):
        """K3's reduced plane: packed ``(B, P)`` f32, or ``(scores,
        rows)``."""
        idx = self.index
        return partial_gip_candidates(
            qv1, qi, idx.values_T, idx.indices_T, idx.lex_dim, self._n_dims,
            self.config.candidate_block, self._packed_ids, self._cand_dtype)

    def select_fused(self, reduced):
        """Candidates ``(vals, rows)`` from K3's reduced plane: stratified
        or one top-k over the group winners, then the winners' rows by
        arithmetic (packed ids) or a gather of the row plane."""
        cfg, G = self.config, self.config.candidate_block
        plane = reduced if self._packed_ids else reduced[0]
        lanes = plane.shape[-1]
        k = self._k1
        if cfg.approx_candidates and lanes > 2 * k:
            S = _pick_slices(cfg.candidate_slices, lanes, k)
            if S > 1:
                vals, pos = stratified_topk(plane, k, S)
            else:
                vals, pos = torch.topk(plane, k, dim=-1, sorted=False)
        else:
            vals, pos = torch.topk(plane, min(k, lanes), dim=-1)
        if self._packed_ids:
            return decode_packed_candidates(vals, pos, G)
        return vals, torch.gather(reduced[1], -1, pos).long()

    def chunked_stage1(self, qv1: torch.Tensor):
        """Row-chunked ip candidates ``(vals, rows)``, descending: each
        chunk (a view of the row-major plane) and the tail slice keep their
        top rows, then one merge.  Exact mode keeps ``min(pool, part
        rows)`` per part, so the merge is the exact top-k; the reference
        caps the tail at a chunk's width (ADVICE r5 #1) and can lose rows."""
        cfg, values = self.config, self.index.values
        n = values.shape[0]
        J = self._row_chunks
        chunk, main = _row_chunk_split(n, J)
        k = self._k1
        approx = cfg.rerank and cfg.approx_candidates
        k_pc = min(chunk, -(-k // J)) if approx else k
        bounds = [(lo, lo + chunk) for lo in range(0, main, chunk)]
        if main < n:
            bounds.append((main, n))
        vals, rows = [], []
        for lo, hi in bounds:
            s = _ip_scores(qv1, values[lo:hi], row_major=True)
            kp = min(k_pc, hi - lo)
            v, r = torch.topk(s, kp, dim=-1,
                              sorted=not (approx and hi - lo > 2 * k_pc))
            vals.append(v)
            rows.append(r + lo)
        vals, rows = torch.cat(vals, dim=-1), torch.cat(rows, dim=-1)
        vals, pos = torch.topk(vals, min(k, vals.shape[-1]), dim=-1)
        return vals, torch.gather(rows, -1, pos)

    def candidates(self, qv1: torch.Tensor, qi: torch.Tensor):
        """Stage 1 and selection: ``(vals, rows)``."""
        if self._fused:
            return self.select_fused(self.fused_stage1(qv1, qi))
        if self._row_chunks > 1:
            return self.chunked_stage1(qv1)
        return self.select(self.stage1(qv1, qi))

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
        """``(scores f32, rows, stage-1 pool floor f32)`` of one batch."""
        vals, rows = self.candidates(qv1, qi)
        floor = vals.float().amin(dim=-1)
        if self._rerank:
            vals, rows = self.stage2(qv, qi, rows)
        return vals.float(), rows, floor

    # -- host API ------------------------------------------------------------

    def _run(self, prepped):
        """All batches of prepared queries: ``(scores, rows, floors)``
        numpy."""
        qv, qv1, qi = prepped
        bs = self.config.query_batch
        outs = [self.search_batch(qv[s:s + bs], qv1[s:s + bs], qi[s:s + bs])
                for s in range(0, qv.shape[0], bs)]
        return tuple(torch.cat([o[i] for o in outs]).cpu().numpy()
                     for i in range(3))

    def search(self, query_values, query_indices=None):
        """Search a query set; returns ``(scores f32, rows int64)`` numpy.
        ``last_timing`` covers the whole call, escalation included."""
        t0 = time.perf_counter()
        prepped = self.prepare_queries(query_values, query_indices)
        self._warn_truncated_scan(prepped[1])
        scores, rows, floors = self._run(prepped)
        n_esc = 0
        if self._tier2 is not None:
            n_esc = self._escalate(prepped, scores, rows, floors)
        dt = time.perf_counter() - t0
        B = scores.shape[0]
        self.last_timing = {
            "queries": int(B),
            "n_batches": -(-B // self.config.query_batch),
            "escalated": n_esc,
            "device": str(self.device),
            "total_s": dt,
            "qps": B / max(dt, 1e-9),
        }
        return scores, rows

    def _escalate(self, prepped, scores, rows, floors) -> int:
        """Tier 2: queries whose reranked ``topk``-th score sits within
        ``escalate_margin`` of their stage-1 pool floor search again at the
        full ``agip_topk``, from the prepared queries already on the
        device; their results overwrite tier 1's in place."""
        esc = np.nonzero(scores[:, -1] - floors
                         <= self.config.escalate_margin)[0]
        self.escalated_queries += len(esc)
        if len(esc):
            sel = torch.from_numpy(esc).to(self.device)
            s2, r2, _ = self._tier2._run(tuple(x[sel] for x in prepped))
            scores[esc] = s2
            rows[esc] = r2
        return len(esc)

    def calibrate_escalation(self, query_values, query_indices=None,
                             miss_mass_target=0.95):
        """The ``escalate_margin`` that escalates the queries covering
        ``miss_mass_target`` of the missing-row mass (rows the full pool
        returns in the top-k that the small pool misses), smallest margin
        first, measured on a query sample by running both tiers on every
        query.  Returns the margin with its evidence, under the
        reference's keys."""
        if self._tier2 is None:
            raise ValueError(
                "calibrate_escalation needs escalate_pool > 0 "
                "(build the Searcher with the tier-1 pool to calibrate)")
        prepped = self.prepare_queries(query_values, query_indices)
        s1, rows1, floors = self._run(prepped)
        _, rows_full, _ = self._tier2._run(prepped)
        B, k = rows1.shape
        margin = s1[:, -1] - floors
        ov = np.array([len(np.intersect1d(rows1[i], rows_full[i])) / k
                       for i in range(B)])
        miss = (1.0 - ov) * k
        out = {
            "pool": self.config.escalate_pool,
            "agip_topk": self.config.agip_topk,
            "n_queries": B,
            "overlap_small_mean": float(ov.mean()),
            "overlap_small_min": float(ov.min()),
            "frac_deficient": float((ov < 1.0).mean()),
        }
        if miss.sum() == 0:
            # the small pool already reproduces the full pool: a margin
            # below every observed one never escalates
            out["escalate_margin"] = float(margin.min()) - 1.0
            out["frac_escalated"] = 0.0
            out["overlap_after_mean"] = 1.0
            return out
        order = np.argsort(margin)
        cum = np.cumsum(miss[order]) / miss.sum()
        i_t = int(np.searchsorted(cum, miss_mass_target))
        t = float(margin[order][min(i_t, B - 1)])
        esc = margin <= t
        ov_after = ov.copy()
        ov_after[esc] = 1.0
        out["escalate_margin"] = t
        out["frac_escalated"] = float(esc.mean())
        out["overlap_after_mean"] = float(ov_after.mean())
        return out

    def _warn_truncated_scan(self, qv1: torch.Tensor) -> None:
        """Stage 1 scans only the top ``max_important_dims`` dims; without a
        rerank, queries with more above-theta dims rank differently from
        the reference's scan of every above-theta dim.  Say so."""
        cfg = self.config
        if not (cfg.theta > 0 and cfg.mode == "gip" and not cfg.rerank) \
                or qv1.shape[0] == 0:
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


def calibrate_pool(index: DeviceIndex, config: SearchConfig,
                   query_values, query_indices=None,
                   pools=(10000, 5000, 2000, 1000),
                   overlap_target: float = 0.99, passes: int = 3):
    """Measure the candidate-pool throughput/quality frontier on a query
    sample and recommend the smallest ``agip_topk`` whose final top-k
    overlaps the largest pool's at ``overlap_target``.

    Timing passes run round-robin over the pools, alternating direction,
    so clock drift cancels; quality (overlap against the largest pool)
    comes from the warm-up pass.  Returns per-pool ``{qps_median,
    qps_best, pass_s, overlap_mean, overlap_min}`` and ``recommended_pool``:
    the smallest pool of the descending run of pools that all meet the
    target (the largest pool when none below it does).
    """
    if not config.rerank:
        raise ValueError("calibrate_pool sweeps agip_topk, which only "
                         "exists on the rerank path (rerank=True)")
    pools = sorted({int(p) for p in pools}, reverse=True)
    if len(pools) < 2:
        raise ValueError("calibrate_pool needs at least two pool sizes")
    if pools[-1] < config.topk:
        raise ValueError(
            f"every pool must be >= topk={config.topk} (got {pools[-1]})")
    searchers = {
        p: Searcher(index, dataclasses.replace(
            config, agip_topk=p, escalate_pool=0), device=index.device)
        for p in pools
    }
    n_rows = index.num_rows
    rows_by_pool = {p: searchers[p].search(query_values, query_indices)[1]
                    for p in pools}
    B = rows_by_pool[pools[0]].shape[0]
    times = {p: [] for p in pools}
    for i in range(passes):
        for p in (pools if i % 2 == 0 else pools[::-1]):
            t0 = time.monotonic()
            searchers[p].search(query_values, query_indices)
            times[p].append(time.monotonic() - t0)
    ref_rows = rows_by_pool[pools[0]]
    report = {
        "topk": config.topk,
        "n_queries": B,
        "passes": passes,
        "overlap_target": overlap_target,
        "reference_pool": pools[0],
        "pools": {},
    }
    for p in pools:
        ov = np.array([
            len(np.intersect1d(
                rows_by_pool[p][i][rows_by_pool[p][i] < n_rows],
                ref_rows[i][ref_rows[i] < n_rows])) / config.topk
            for i in range(B)])
        med = float(np.median(times[p]))
        report["pools"][p] = {
            "qps_median": round(B / med, 1),
            "qps_best": round(B / min(times[p]), 1),
            "pass_s": [round(t, 4) for t in times[p]],
            "overlap_mean": round(float(ov.mean()), 4),
            "overlap_min": round(float(ov.min()), 4),
        }
    # stop at the first miss so a fluke qualifier below a disqualified pool
    # is never picked
    recommended = pools[0]
    for p in pools:
        if report["pools"][p]["overlap_mean"] >= overlap_target:
            recommended = p
        else:
            break
    report["recommended_pool"] = recommended
    return report
