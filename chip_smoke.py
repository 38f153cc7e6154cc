#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (dhr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--queries Q] [--seed S]

Run from the root of a checkout.  It builds the CUDA kernels from
``dhr_tpu_torch/csrc`` (nvcc, sm_90a, into ``build/kernels/``), holds each
against its plain PyTorch version on the card, then runs two paths over one
synthetic MS MARCO-sized corpus through the entry points a user calls
(``DeviceIndex.from_arrays``, ``Searcher.search``), both at the bench
operating point (int8 planes, theta=0.3, 48 important dims, a 10,000-row
pool, exact rerank, top 1000):

- the main path: theta pass (K1), candidate selection, rerank (K2);
- the fused path: theta pass reduced per 8-row group (K3), selection over
  the reduced plane with arithmetic row decoding, rerank (K2).

It checks each path's kernel launch counts and its staged-vs-exact ranking
agreement.  On a 204,803-row slice it also holds the other search modes
(row-chunked ip, pq, two-tier escalation) on the card against the same
search on the CPU's plain path, and on the full index it times ip (dim- and
row-major) and pq (m=64) with rerank.

Each phase prints one JSON line; the card's name and power limit (as
nvidia-smi gives them) and the ``{"kernels": [...]}`` line come before the
last line, ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the last line.  Without CUDA, or outside a checkout, it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

MSMARCO_PASSAGES = 8_841_823
LEX_DIM = 768
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TPU_AGREEMENT = {"10": 1.0, "100": 0.9994, "1000": 0.9969}  # BENCH_r05.json
K1_SOURCE = "dhr_tpu_torch/csrc/partial_gip.cu"
K2_SOURCE = "dhr_tpu_torch/csrc/rerank_gip.cu"
K3_SOURCE = "dhr_tpu_torch/csrc/gip_candidates.cu"
SMALL_ROWS = 204_803


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, torch) -> float:
    """Mean device ms per call of ``fn`` over ``iters`` calls (CUDA events),
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_close(name, got, want, rel_tol, torch):
    """Assert ``|got - want| <= rel_tol * max(|want|, 1)`` (same -inf
    positions); returns the max abs difference."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{name}: non-finite entries differ")
    diff = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    scale = float(want[fin].abs().max()) if fin.any() else 0.0
    if not diff <= rel_tol * max(scale, 1.0):
        raise AssertionError(f"{name}: max |diff| {diff} > {rel_tol} * "
                             f"max(|want|={scale}, 1)")
    return diff


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from dhr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build(["partial_gip", "rerank_gip", "gip_candidates"])
    ptxas = {}
    for n, r in reports.items():
        regs = [int(w) for ln in r.splitlines() if "registers" in ln
                for a, w in zip(ln.split(), ln.split()[1:]) if a == "Used"]
        spills = [ln.strip() for ln in r.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        ptxas[n] = {"max_registers": max(regs, default=None),
                    "spilling_lines": spills}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(_build.build_dir()), "ptxas": ptxas})


def small_world(seed, torch):
    """A 204,803-row corpus slice, 16 prepared queries at full width and
    the 16 raw ones."""
    import numpy as np

    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.synth import synth_index_planes, synth_reps

    n = SMALL_ROWS
    v, f, scales, _ = synth_index_planes(seed, n, device="cuda")
    index = DeviceIndex.from_arrays(v, f, np.arange(n).astype(str), LEX_DIM,
                                    scales, device="cuda")
    qv, qf, _ = synth_reps(seed, 16, role="query", stream=1, device="cuda")
    prep = Searcher(index, SearchConfig(theta=0.3, max_important_dims=48))
    return index, prep.prepare_queries(qv, qf), (qv, qf)


def phase_k1(index, queries, torch):
    """K1 vs plain: 8 queries, I=48 (theta=0.3) and I=896 (theta=0), rows
    204,800 and 204,803 (prime: ragged edge, unaligned dim rows)."""
    from dhr_tpu_torch.ops.partial_gip import (
        partial_gip, partial_gip_plain, select_important)

    qv, qv1, qi = (x[:8] for x in queries)
    worst, cases = 0.0, 0
    for n in (204_800, 204_803):
        vt8 = index.values_T[:, :n].contiguous()
        it8 = index.indices_T[:, :n].contiguous()
        for vdt in (torch.int8, torch.bfloat16, torch.float32):
            vt = vt8.to(vdt)
            for idt in (torch.int8, torch.int16):
                it = it8.to(idt)
                for q, n_imp in ((qv1, 48), (qv, qv.shape[1])):
                    imp = select_important(q, qi, n_imp)
                    for out in (torch.float32, torch.bfloat16):
                        tol = 1e-4 if out == torch.float32 else 8e-3
                        got = partial_gip(*imp, vt, it, LEX_DIM, out)
                        want = partial_gip_plain(*imp, vt, it, LEX_DIM, out)
                        torch.cuda.synchronize()
                        worst = max(worst, check_close(
                            f"partial_gip N={n} {vdt} {idt} I={n_imp} {out}",
                            got, want, tol, torch))
                        cases += 1
    emit({"phase": "k1_vs_plain", "cases": cases, "max_abs_err": worst,
          "tol": "1e-4 (f32 out) / 8e-3 (bf16 out) * max(|want|, 1)"})
    return worst


def phase_k2(index, queries, seed, torch):
    """K2 vs plain: B=16, K=10,000 and 1,001, D=896, lex=768, int8 and
    int16 indices, int8/bf16/f32 values; one row id out of range."""
    from dhr_tpu_torch.ops.rerank_gip import rerank_gip, rerank_gip_plain

    qv, _, qi = queries
    n = index.num_rows
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    worst, cases = 0.0, 0
    for k in (10_000, 1_001):
        rows = torch.randint(0, n, (qv.shape[0], k), generator=g,
                             device="cuda")
        rows[0, 0] = n  # never read: scores -inf
        for vdt in (torch.int8, torch.bfloat16, torch.float32):
            vals = index.values.to(vdt)
            for idt in (torch.int8, torch.int16):
                ind = index.indices.to(idt)
                got = rerank_gip(qv, qi, rows, vals, ind, LEX_DIM)
                want = rerank_gip_plain(qv, qi, rows, vals, ind, LEX_DIM)
                torch.cuda.synchronize()
                worst = max(worst, check_close(
                    f"rerank_gip K={k} {vdt} {idt}", got, want, 1e-4, torch))
                cases += 1
    emit({"phase": "k2_vs_plain", "cases": cases, "max_abs_err": worst,
          "tol": "1e-4 * max(|want|, 1)"})
    return worst


def phase_k3(index, queries, torch):
    """K3 vs plain: 8 queries, rows 204,800 and 204,803 (ragged, unaligned
    dim rows), value int8/bf16, index int8/int16, I=48 (theta 0.3) and
    I=896 (theta 0); G=8 packed, G=8 two planes (f32 and bf16 out), G=3
    two planes.  Rows equal, scores bit-equal, packed rows decode to the
    two-plane rows."""
    from dhr_tpu_torch.ops.gip_candidates import (
        decode_packed_candidates, gip_candidates, gip_candidates_plain)
    from dhr_tpu_torch.ops.partial_gip import select_important

    qv, qv1, qi = (x[:8] for x in queries)
    variants = ((8, True, torch.float32), (8, False, torch.float32),
                (8, False, torch.bfloat16), (3, False, torch.float32))
    worst, cases = 0.0, 0
    for n in (204_800, SMALL_ROWS):
        vt8 = index.values_T[:, :n].contiguous()
        it8 = index.indices_T[:, :n].contiguous()
        for vdt in (torch.int8, torch.bfloat16):
            vt = vt8.to(vdt)
            for idt in (torch.int8, torch.int16):
                it = it8.to(idt)
                for q, n_imp in ((qv1, 48), (qv, qv.shape[1])):
                    imp = select_important(q, qi, n_imp)
                    two_plane_rows = None
                    for G, packed, out in variants:
                        name = (f"gip_candidates N={n} {vdt} {idt} "
                                f"I={n_imp} G={G} packed={packed} {out}")
                        got = gip_candidates(*imp, vt, it, LEX_DIM, G,
                                             packed, out)
                        want = gip_candidates_plain(*imp, vt, it, LEX_DIM,
                                                    G, packed, out)
                        torch.cuda.synchronize()
                        if packed:
                            got_v, want_v = got, want
                            packed_plane = got
                        else:
                            (got_v, got_r), (want_v, want_r) = got, want
                            if not torch.equal(got_r, want_r):
                                raise AssertionError(f"{name}: rows differ")
                            if G == 8 and out == torch.float32:
                                two_plane_rows = got_r
                        bits = (got_v.float().view(torch.int32),
                                want_v.float().view(torch.int32))
                        if not torch.equal(*bits):
                            raise AssertionError(f"{name}: scores differ")
                        worst = max(worst, check_close(
                            name, got_v, want_v, 0.0, torch))
                        cases += 1
                    pos = torch.arange(packed_plane.shape[1], device="cuda")
                    _, rows = decode_packed_candidates(
                        packed_plane, pos.expand_as(packed_plane), 8)
                    valid = two_plane_rows < n
                    if not (torch.equal(rows[valid],
                                        two_plane_rows[valid].long())
                            and bool((rows[~valid] >= n).all())):
                        raise AssertionError(
                            f"decoded packed rows != two-plane rows at N={n}")
    emit({"phase": "k3_vs_plain", "cases": cases, "max_abs_err": worst,
          "tol": "0 (rows equal, scores bit-equal)"})
    return worst


def phase_search_vs_plain(index, queries_raw, torch):
    """The whole search on the card against the same search on the CPU's
    plain PyTorch path, over the 204,803-row corpus: same final scores at
    each rank, same rows apart from ties at the candidate pool's edge."""
    import numpy as np

    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher

    qv, qf = (x[:8] for x in queries_raw)
    cpu_index = DeviceIndex.from_arrays(
        index.values.cpu(), index.indices.cpu(), index.docids,
        index.lex_dim, index.value_scales.cpu(), device="cpu")
    cfg = SearchConfig(topk=1000, theta=0.3, rerank=True, agip_topk=10000,
                       max_important_dims=48, query_batch=8)
    got_s, got_r = Searcher(index, cfg).search(qv, qf)
    want_s, want_r = Searcher(cpu_index, cfg, device="cpu").search(
        qv.cpu(), qf.cpu())
    check_close("search scores gpu vs cpu plain", torch.from_numpy(got_s),
                torch.from_numpy(want_s), 1e-4, torch)
    overlap = agreement(got_r, want_r)
    emit({"phase": "search_vs_plain", "queries": int(qv.shape[0]),
          "rows": index.num_rows, "overlap": overlap})
    if min(overlap.values()) < 0.99:
        raise AssertionError(f"search on the card vs plain: {overlap}")


def phase_modes(index, queries_raw, torch):
    """The other search modes on the card against the same search on the
    CPU's plain path, 16 queries over the 204,803-row slice: row-chunked ip
    + rerank (layout row, 5 chunks and a 3-row tail), pq (m=64, built by
    ``PackedIndex.quantize_pq`` on the card, twice: the two builds must be
    equal) + rerank, and two-tier escalation (pool 2,000 of 10,000) at a
    margin that escalates some queries; overlap >= 0.99 at every k."""
    import numpy as np

    from dhr_tpu_torch.retrieval import (
        DeviceIndex, PackedIndex, SearchConfig, Searcher)

    qv, qf = queries_raw
    args = (index.docids, index.lex_dim)
    row = DeviceIndex.from_arrays(index.values, index.indices, *args,
                                  index.value_scales, layout="row",
                                  device="cuda")
    cpu_both = DeviceIndex.from_arrays(
        index.values.cpu(), index.indices.cpu(), *args,
        index.value_scales.cpu(), device="cpu")
    cpu_row = DeviceIndex.from_arrays(
        cpu_both.values, cpu_both.indices, *args, cpu_both.value_scales,
        layout="row", device="cpu")
    base = dict(topk=1000, rerank=True, agip_topk=10000, query_batch=8)
    out = {"phase": "modes_vs_plain", "queries": int(qv.shape[0]),
           "rows": index.num_rows}

    def compare(name, cfg, card_index, cpu_index):
        card = Searcher(card_index, cfg)
        cpu = Searcher(cpu_index, cfg, device="cpu")
        got_s, got_r = card.search(qv, qf)
        want_s, want_r = cpu.search(qv.cpu(), qf.cpu())
        # stage-1 scores of ip differ in the last bits between the card's
        # and the CPU's GEMM, which can move a row across the pool's edge:
        # compare the final scores of common rows
        common = [np.intersect1d(a, b, return_indices=True)
                  for a, b in zip(got_r, want_r)]
        check_close(f"{name} scores of common rows, gpu vs cpu plain",
                    torch.from_numpy(np.concatenate(
                        [got_s[i][c[1]] for i, c in enumerate(common)])),
                    torch.from_numpy(np.concatenate(
                        [want_s[i][c[2]] for i, c in enumerate(common)])),
                    1e-4, torch)
        overlap = agreement(got_r, want_r)
        out[name] = {"overlap": overlap}
        if min(overlap.values()) < 0.99:
            raise AssertionError(f"{name} on the card vs plain: {overlap}")
        return card, cpu

    ip_cfg = SearchConfig(mode="ip", row_chunk=50_000, **base)
    card, _ = compare("ip_row_chunked", ip_cfg, row, cpu_row)
    out["ip_row_chunked"]["chunks"] = card._row_chunks
    if card._row_chunks != 5:
        raise AssertionError(f"row chunks {card._row_chunks}, expected 5")

    floats = PackedIndex(
        values=(row.values.float() * row.value_scales[None, :]).cpu().numpy(),
        indices=row.indices.cpu().numpy(), docids=index.docids,
        lex_dim=index.lex_dim)
    t0 = time.perf_counter()
    packed = floats.quantize_pq(m=64, device="cuda")
    out["pq_build_s"] = time.perf_counter() - t0
    again = floats.quantize_pq(m=64, device="cuda")
    if not (np.array_equal(packed.pq_codes, again.pq_codes)
            and np.array_equal(packed.pq_centroids, again.pq_centroids)):
        raise AssertionError("two pq builds of the same plane differ")
    del floats, again
    compare("pq_m64", SearchConfig(mode="pq", **base),
            DeviceIndex.from_packed(packed, layout="row", device="cuda"),
            DeviceIndex.from_packed(packed, layout="row", device="cpu"))
    out["pq_m64"]["builds_equal"] = True

    gip = dict(theta=0.3, max_important_dims=48, escalate_pool=2000, **base)
    probe = Searcher(index, SearchConfig(**gip))
    s, _, floors = probe._run(probe.prepare_queries(qv, qf))
    m = np.sort(s[:, -1] - floors)
    mid = len(m) // 2
    margin = float((m[mid - 1] + m[mid]) / 2)
    card, cpu = compare("escalation", SearchConfig(escalate_margin=margin,
                                                   **gip), index, cpu_both)
    out["escalation"].update(margin=margin,
                             escalated_card=card.escalated_queries,
                             escalated_cpu=cpu.escalated_queries)
    emit(out)
    if not 0 < card.escalated_queries < qv.shape[0]:
        raise AssertionError(f"escalated {card.escalated_queries} of "
                             f"{qv.shape[0]}: expected some, not all")


def phase_modes_full(searcher, queries, torch):
    """ip over the dim-major plane, row-chunked ip over the row-major plane
    and pq (m=64) over codes of the int8 plane, each + rerank, on the main
    path's index (the row-major twin and the pq index share its planes):
    q/s (one warm-up, three timed passes of the main path's queries), peak
    memory, launches (K2 only) and agreement with the exact search."""
    import numpy as np

    from dhr_tpu_torch.ops.pq import train_encode_pq
    from dhr_tpu_torch.retrieval import Searcher

    qv, qf, erows = queries
    idx = searcher.index
    row = dataclasses.replace(idx, values_T=None, indices_T=None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    codes, centroids = train_encode_pq(idx.values, 64,
                                       value_scales=idx.value_scales)
    torch.cuda.synchronize()
    pq_build_s = time.perf_counter() - t0
    pq = dataclasses.replace(row, pq_codes=codes, pq_centroids=centroids)
    base = searcher.config
    n_passes = 4  # one warm-up, three timed
    out = {"phase": "modes_full", "rows": idx.num_rows,
           "queries": int(qv.shape[0]), "query_batch": base.query_batch,
           "pq_build_s": pq_build_s}
    for name, index, mode in (("ip_dim_major", idx, "ip"),
                              ("ip_row_chunked", row, "ip"),
                              ("pq_m64", pq, "pq")):
        s = Searcher(index, dataclasses.replace(base, mode=mode))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        qps, scores, rows = timed_passes(s, qv, qf, n_passes - 1)
        launches = read_launches()
        want = {"partial_gip": 0, "gip_candidates": 0,
                "rerank_gip": n_passes * -(-qv.shape[0] // base.query_batch)}
        if launches != want:
            raise AssertionError(f"{name} launches {launches}, expected "
                                 f"{want}")
        check_result(scores, rows, qv.shape[0], base.topk, idx.num_rows)
        out[name] = {"qps_median": float(np.median(qps)), "qps_passes": qps,
                     "row_chunks": s._row_chunks, "launches": launches,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "staged_vs_exact": agreement(rows[:erows.shape[0]],
                                                  erows)}
        del s, scores, rows
    emit(out)


def agreement(staged, exact, ks=(10, 100, 1000)):
    import numpy as np

    return {str(k): float(np.mean([
        len(set(a[:k].tolist()) & set(b[:k].tolist())) / k
        for a, b in zip(staged, exact)])) for k in ks}


def _counters():
    from dhr_tpu_torch.ops.gip_candidates import gip_candidates
    from dhr_tpu_torch.ops.partial_gip import partial_gip
    from dhr_tpu_torch.ops.rerank_gip import rerank_gip

    return {"partial_gip": partial_gip, "rerank_gip": rerank_gip,
            "gip_candidates": gip_candidates}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def timed_passes(searcher, qv, qf, n_passes):
    """One warm-up pass, then ``n_passes`` timed: ``(q/s list, scores,
    rows)`` of the last pass."""
    searcher.search(qv, qf)
    qps = []
    for _ in range(n_passes):
        t = time.perf_counter()
        scores, rows = searcher.search(qv, qf)
        qps.append(qv.shape[0] / (time.perf_counter() - t))
    return qps, scores, rows


def check_result(scores, rows, n_queries, topk, n_rows):
    import numpy as np

    if scores.shape != (n_queries, topk) or rows.shape != scores.shape:
        raise AssertionError(f"result shape {scores.shape} / {rows.shape}")
    if not np.isfinite(scores).all() or rows.min() < 0 \
            or rows.max() >= n_rows:
        raise AssertionError("non-finite scores or row ids out of range")
    if (np.diff(scores, axis=1) > 0).any():
        raise AssertionError("final scores are not in descending order")


def phase_main(args, torch):
    """The main path at full width and the given row count."""
    import numpy as np

    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.synth import synth_index_planes, synth_reps

    t0 = time.perf_counter()
    v, f, scales, _ = synth_index_planes(args.seed, args.rows, device="cuda")
    index = DeviceIndex.from_arrays(
        v, f, np.arange(args.rows).astype(str), LEX_DIM, scales,
        device="cuda")
    del v, f
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qv, qf, _ = synth_reps(args.seed, args.queries, role="query", stream=1,
                           device="cuda")
    above = (qv[:, :LEX_DIM] > 0.3).sum(dim=1).float()
    cfg = SearchConfig(topk=1000, theta=0.3, rerank=True, agip_topk=10000,
                       max_important_dims=48, query_batch=128)
    searcher = Searcher(index, cfg)

    n_passes = 6  # one warm-up, five timed
    reset_launches()
    qps, scores, rows = timed_passes(searcher, qv, qf, n_passes - 1)
    launches = read_launches()
    want_launches = n_passes * -(-args.queries // cfg.query_batch)
    emit({"phase": "kernels", "path": "main", "launches": launches,
          "expected": {"partial_gip": want_launches,
                       "rerank_gip": want_launches, "gip_candidates": 0}})
    if launches != {"partial_gip": want_launches,
                    "rerank_gip": want_launches, "gip_candidates": 0}:
        raise AssertionError(f"main path launches {launches}, expected K1 "
                             f"and K2 {want_launches} times, K3 never")
    check_result(scores, rows, args.queries, cfg.topk, args.rows)
    n_agree = min(64, args.queries)
    exact = Searcher(index, dataclasses.replace(
        cfg, theta=0.0, rerank=False, approx_candidates=False,
        candidate_bf16=False, query_batch=n_agree))
    reset_launches()
    _, erows = exact.search(qv[:n_agree], qf[:n_agree])
    exact_launches = read_launches()
    emit({"phase": "kernels", "path": "exact_brute_force",
          "launches": exact_launches})
    if exact_launches != {"partial_gip": 1, "rerank_gip": 0,
                          "gip_candidates": 0}:
        raise AssertionError(f"exact search launches {exact_launches}, "
                             "expected K1 once, K2 and K3 never")
    agree = agreement(rows[:n_agree], erows)

    # per-stage device times of the first batch (CUDA events)
    bs = cfg.query_batch
    qvb, qv1b, qib = searcher.prepare_queries(qv[:bs], qf[:bs])
    scores = searcher.stage1(qv1b, qib)
    _, cand = searcher.select(scores)
    stage_ms = {
        "theta_kernel_k1": cuda_ms(lambda: searcher.stage1(qv1b, qib), 3,
                                   torch),
        "candidate_select": cuda_ms(lambda: searcher.select(scores), 3,
                                    torch),
        "rerank_k2_and_topk": cuda_ms(
            lambda: searcher.stage2(qvb, qib, cand), 3, torch),
    }
    emit({
        "phase": "main_path", "rows": args.rows,
        "rows_full_size": args.rows == MSMARCO_PASSAGES,
        "queries": args.queries, "query_batch": bs,
        "index_build_s": build_s,
        "index_bytes": sum(t.numel() * t.element_size() for t in (
            index.values, index.values_T, index.indices, index.indices_T)),
        "qps_median": float(np.median(qps)), "qps_passes": qps,
        "stage_ms_first_batch": stage_ms,
        "query_dims_above_theta_mean": float(above.mean()),
        "frac_queries_above_scan_cap": float((above > 48).float().mean()),
        "staged_vs_exact": agree, "agreement_queries": n_agree,
        "tpu_v5e_reference_agreement_not_this_card": TPU_AGREEMENT,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    for k, a in agree.items():
        if a < 0.99:
            raise AssertionError(f"staged-vs-exact agreement@{k} = {a} < 0.99")
    del exact, scores
    return searcher, (qvb, qv1b, qib, cand), launches, (qv, qf, erows)


def phase_fused(searcher, queries, torch):
    """The fused path on the main path's index and queries: K3 (G=8, packed
    ids) in place of K1 + selection over the full plane; K2 as before."""
    import numpy as np

    from dhr_tpu_torch.retrieval import Searcher

    qv, qf, erows = queries
    cfg = dataclasses.replace(searcher.config, fused_candidates=True,
                              candidate_block=8)
    fused = Searcher(searcher.index, cfg)
    if not (fused._fused and fused._packed_ids):
        raise AssertionError("the fused path did not engage")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_passes = 6  # one warm-up, five timed
    reset_launches()
    qps, scores, rows = timed_passes(fused, qv, qf, n_passes - 1)
    launches = read_launches()
    n_batches = n_passes * -(-qv.shape[0] // cfg.query_batch)
    want = {"partial_gip": 0, "rerank_gip": n_batches,
            "gip_candidates": n_batches}
    emit({"phase": "kernels", "path": "fused", "launches": launches,
          "expected": want})
    if launches != want:
        raise AssertionError(f"fused path launches {launches}, expected "
                             f"{want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_result(scores, rows, qv.shape[0], cfg.topk, fused.index.num_rows)
    agree = agreement(rows[:erows.shape[0]], erows)

    bs = cfg.query_batch
    qvb, qv1b, qib = fused.prepare_queries(qv[:bs], qf[:bs])
    red = fused.fused_stage1(qv1b, qib)
    _, cand = fused.select_fused(red)
    stage_ms = {
        "fused_kernel_k3": cuda_ms(lambda: fused.fused_stage1(qv1b, qib), 3,
                                   torch),
        "candidate_select_and_decode": cuda_ms(
            lambda: fused.select_fused(red), 3, torch),
        "rerank_k2_and_topk": cuda_ms(lambda: fused.stage2(qvb, qib, cand),
                                      3, torch),
    }
    emit({
        "phase": "fused_path", "rows": fused.index.num_rows,
        "candidate_block": cfg.candidate_block,
        "reduced_lanes": red.shape[1], "queries": int(qv.shape[0]),
        "query_batch": bs, "qps_median": float(np.median(qps)),
        "qps_passes": qps, "stage_ms_first_batch": stage_ms,
        "staged_vs_exact": agree, "agreement_queries": int(erows.shape[0]),
        "peak_mem_gb": peak,
    })
    for k, a in agree.items():
        if a < 0.99:
            raise AssertionError(f"fused staged-vs-exact agreement@{k} = {a} "
                                 "< 0.99")
    return launches


def phase_timing(searcher, batch, launches, errs, torch):
    """Kernel, plain and bound times at the main path's first-batch shapes
    (K3 at the fused path's, which are the same queries and planes)."""
    from dhr_tpu_torch.ops.gip_candidates import (
        gip_candidates, gip_candidates_plain)
    from dhr_tpu_torch.ops.partial_gip import (
        partial_gip, partial_gip_plain, select_important)
    from dhr_tpu_torch.ops.rerank_gip import rerank_gip, rerank_gip_plain

    idx = searcher.index
    qvb, qv1b, qib, cand = batch
    B, N, D, lex = qvb.shape[0], idx.num_rows, idx.dim, idx.lex_dim
    torch.cuda.empty_cache()

    imp = select_important(qv1b, qib, 48)
    vt, it = idx.values_T, idx.indices_T
    out_dt = torch.bfloat16
    k1 = lambda: partial_gip(*imp, vt, it, lex, out_dt)  # noqa: E731
    k1_plain = lambda: partial_gip_plain(*imp, vt, it, lex, out_dt)  # noqa: E731
    k1_ms = cuda_ms(k1, 5, torch)
    k1_plain_ms = cuda_ms(k1_plain, 1, torch)
    k1_err = check_close("partial_gip main path", k1(), k1_plain(), 8e-3,
                         torch)
    used = imp[0] != 0
    dims = imp[1][used]
    union = torch.unique(dims)
    n_lex_union = int((union < lex).sum())
    nnz, nnz_lex = int(used.sum()), int((dims < lex).sum())
    v_b, i_b, o_b = vt.element_size(), it.element_size(), 2
    k1_bytes = (union.numel() * N * v_b + n_lex_union * N * i_b
                + B * N * o_b + imp[0].numel() * 12)
    k1_stream_bytes = nnz * N * v_b + nnz_lex * N * i_b + B * N * o_b
    k1_ops = 2 * nnz * N
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / F32_FLOPS_PER_S)

    G = 8
    k3 = lambda: gip_candidates(*imp, vt, it, lex, G, True)  # noqa: E731
    k3_plain = lambda: gip_candidates_plain(*imp, vt, it, lex, G, True)  # noqa: E731
    k3_ms = cuda_ms(k3, 5, torch)
    k3_plain_ms = cuda_ms(k3_plain, 1, torch)
    got, want = k3(), k3_plain()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("gip_candidates main path: packed plane differs")
    k3_err = check_close("gip_candidates main path", got, want, 0.0, torch)
    del got, want
    P = -(-N // (128 * G)) * 128
    k3_bytes = k1_bytes - B * N * o_b + B * P * 4
    k3_stream_bytes = k1_stream_bytes - B * N * o_b + B * P * 4
    k3_bound = max(k3_bytes / HBM_BYTES_PER_S, k1_ops / F32_FLOPS_PER_S)

    vals, ind = idx.values, idx.indices
    k2 = lambda: rerank_gip(qvb, qib, cand, vals, ind, lex)  # noqa: E731
    k2_plain = lambda: rerank_gip_plain(qvb, qib, cand, vals, ind, lex)  # noqa: E731
    k2_ms = cuda_ms(k2, 5, torch)
    k2_plain_ms = cuda_ms(k2_plain, 1, torch)
    k2_err = check_close("rerank_gip main path", k2(), k2_plain(), 1e-4,
                         torch)
    K = cand.shape[1]
    n_unique = torch.unique(cand).numel()
    row_bytes = D * vals.element_size() + lex * ind.element_size()
    k2_bytes = n_unique * row_bytes + B * K * (8 + 4) + B * (D + D) * 4
    k2_ops = 2 * B * K * D
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / F32_FLOPS_PER_S)

    def by(nbytes, ops):
        return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S
                else "operations")

    emit({"phase": "kernel_shapes",
          "partial_gip": {"B": B, "N": N, "I": 48, "nonzero_imp": nnz,
                          "distinct_dims": union.numel(),
                          "bytes_each_input_once": k1_bytes,
                          "bytes_per_query_streams": k1_stream_bytes,
                          "stream_bound_ms": k1_stream_bytes
                          / HBM_BYTES_PER_S * 1e3},
          "gip_candidates": {"B": B, "N": N, "G": G, "reduced_lanes": P,
                             "bytes_each_input_once": k3_bytes,
                             "bytes_per_query_streams": k3_stream_bytes,
                             "stream_bound_ms": k3_stream_bytes
                             / HBM_BYTES_PER_S * 1e3},
          "rerank_gip": {"B": B, "K": K, "D": D, "lex": lex,
                         "distinct_rows": n_unique,
                         "bytes_each_input_once": k2_bytes,
                         "bytes_per_query_rows": B * K * row_bytes}})
    return [
        {"name": "partial_gip", "route": "cuda", "source": K1_SOURCE,
         "replaces": "dhr_tpu/ops/pallas_gip.py:115",
         "launches": launches["partial_gip"],
         "max_abs_err": max(errs[0], k1_err), "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound * 1e3,
         "bound_by": by(k1_bytes, k1_ops), "library_ms": None},
        {"name": "rerank_gip", "route": "cuda", "source": K2_SOURCE,
         "replaces": "dhr_tpu/ops/pallas_rerank.py:81",
         "launches": launches["rerank_gip"],
         "max_abs_err": max(errs[1], k2_err), "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound * 1e3,
         "bound_by": by(k2_bytes, k2_ops), "library_ms": None},
        {"name": "gip_candidates", "route": "cuda", "source": K3_SOURCE,
         "replaces": "dhr_tpu/ops/pallas_gip.py:346",
         "launches": launches["gip_candidates"],
         "max_abs_err": max(errs[2], k3_err), "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound * 1e3,
         "bound_by": by(k3_bytes, k1_ops), "library_ms": None},
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=MSMARCO_PASSAGES,
                    help="corpus rows of the main path (default: the MS "
                         "MARCO passage count)")
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import dhr_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    pkg = os.path.dirname(os.path.abspath(dhr_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"chip_smoke: dhr_tpu_torch comes from {pkg}, not from this "
              "checkout", file=sys.stderr)
        return 1

    name, smi = phase_device(torch)
    phase_build()
    index, queries, raw = small_world(args.seed + 1, torch)
    errs = (phase_k1(index, queries, torch),
            phase_k2(index, queries, args.seed, torch),
            phase_k3(index, queries, torch))
    phase_search_vs_plain(index, raw, torch)
    phase_modes(index, raw, torch)
    del index, queries, raw
    torch.cuda.empty_cache()
    searcher, batch, launches, main_queries = phase_main(args, torch)
    launches["gip_candidates"] = phase_fused(searcher, main_queries,
                                             torch)["gip_candidates"]
    phase_modes_full(searcher, main_queries, torch)
    del main_queries
    kernels = phase_timing(searcher, batch, launches, errs, torch)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
