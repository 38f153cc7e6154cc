"""Where the theta-pass kernels' time goes, on one GPU.

    python -m dhr_tpu_torch.tools.k1_ablation [--rows N] [--parent-csrc DIR]

Builds K1 (``csrc/partial_gip.cu``) and K3 (``csrc/gip_candidates.cu``) as
they are, and variants made by editing a copy of their sources.  K1: 4 / 8
/ 16 rows per lane; staging only (each block returns once its copies
land); compute only (no copies: shared memory as found).  K3: staging only
(copies and barriers, no arithmetic); compute only (no copies); two
staging buffers in place of the kernel's one (the next step's copies
issued before this step's arithmetic, one block an SM: a patch of the
kernel's staging, ``K3_TWO_BUFFERS``); 256-thread blocks.  K2 (with ``--parent-csrc``):
a ring of 4 or 8 rows per warp in place of 2; registers not held to three
blocks an SM.  Times each in turns with CUDA events on the main path's
first batch: synthetic MS MARCO-size int8 planes (``retrieval.synth``,
seed 0), 128 queries at theta 0.3 with 48 important dims; K1 bf16 out, K3
G=8 packed; the plan's tile, and other tiles for the as-built kernels.
Every full variant must equal the plain version bit for bit (K2: within
1e-4 of the parent's).

``--parent-csrc DIR``: the ``csrc`` directory of an earlier commit, e.g.
unpacked with ``git archive``, whose K1 and K2 take today's C entries and
whose K3 takes the per-query entry of before the staged K3; its K1, K3 and
K2 (on the main path's candidates) are then timed in turns with today's
(today's K3 also with its plan made in the call, ``k3_with_plan``: the
span the parent's K3, which needs no plan, covers), and their outputs
compared: K1 and K3 bit for bit, K2 within 1e-4 relative
(its order of summation may differ).

Prints one JSON line with the card's name, power limit and clock; the
variants' sources and libraries go under ``build/k1_ablation/``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib
import json
import re
import subprocess
from pathlib import Path

ROWS = 8_841_823
LEX_DIM = 768

# edits of a kernel source that make each variant (old text -> new text)
_ROWS_LINE = "constexpr int kRows = 8;"
_COPY_LOOP = "for (int c = threadIdx.x; c < n_chunks; c += {}) {{"
K1_VARIANTS = {
    "as_built": {},
    "rows4": {_ROWS_LINE: "constexpr int kRows = 4;"},
    "rows16": {_ROWS_LINE: "constexpr int kRows = 16;"},
    "stage_only": {
        "  dhr::cp_async_wait_all();\n  __syncthreads();\n":
        "  dhr::cp_async_wait_all();\n  __syncthreads();\n"
        "  if (n_u >= 0) return;\n"},
    "compute_only": {
        _COPY_LOOP.format("blockDim.x"):
        _COPY_LOOP.format("blockDim.x").replace("c < n_chunks",
                                                "c < 0 * n_chunks")},
}
_SKIP = "      if (qb >= batch) continue;"
# K3 with a second staging buffer: step j + 1's copies go out before step
# j's arithmetic, into the other buffer, and the barrier after the
# arithmetic goes
K3_TWO_BUFFERS = {
    "  VT* const s_v = reinterpret_cast<VT*>(smem);\n"
    "  IT* const s_i = reinterpret_cast<IT*>(smem + static_cast<size_t>(n_u)"
    " * T *\n"
    "                                                   sizeof(VT));\n":
    "  const size_t v_bytes = static_cast<size_t>(n_u) * T * sizeof(VT);\n"
    "  const size_t buf_bytes =\n"
    "      v_bytes + static_cast<size_t>(n_lex + 1) * T * sizeof(IT);\n"
    "  const auto buf_v = [&](int j) {\n"
    "    return reinterpret_cast<VT*>(smem + (j % 2) * buf_bytes);\n"
    "  };\n"
    "  const auto buf_i = [&](int j) {\n"
    "    return reinterpret_cast<IT*>(smem + (j % 2) * buf_bytes + v_bytes);\n"
    "  };\n",
    "    const int64_t n0 = row0 + static_cast<int64_t>(j) * kLane;\n":
    "    VT* const s_v = buf_v(j);\n"
    "    IT* const s_i = buf_i(j);\n"
    "    const int64_t n0 = row0 + static_cast<int64_t>(j) * kLane;\n",
    "    __syncthreads();  // step j has landed\n"
    "    const VT* my_v = s_v + r0;\n"
    "    const IT* my_i = s_i + r0;\n":
    "    __syncthreads();  // step j has landed; step j - 1 is done\n"
    "    if (j + 1 < n_steps) stage(j + 1);\n"
    "    const VT* my_v = buf_v(j) + r0;\n"
    "    const IT* my_i = buf_i(j) + r0;\n",
    "    if (j + 1 < n_steps) {\n"
    "      __syncthreads();  // every lane is done with the buffer\n"
    "      stage(j + 1);\n"
    "    }\n": "",
    "  const size_t smem =\n      static_cast<size_t>(T) *":
    "  const size_t smem =\n      2 * static_cast<size_t>(T) *",
}
K3_VARIANTS = {
    "k3_as_built": {},
    "k3_stage_only": {_SKIP: "      if (qb >= batch || n_u >= 0) continue;"},
    "k3_compute_only": {
        _COPY_LOOP.format("kThreads"):
        _COPY_LOOP.format("kThreads").replace("c < n_chunks",
                                              "c < 0 * n_chunks")},
    "k3_two_buffers": K3_TWO_BUFFERS,
    "k3_small_blocks": {"constexpr int kThreads = 512;":
                        "constexpr int kThreads = 256;",
                        "__launch_bounds__(kThreads, 2)":
                        "__launch_bounds__(kThreads, 4)"},
}
_AHEAD = "constexpr int kAhead = 2;"
K2_VARIANTS = {
    "k2_as_built": {},
    "k2_ahead4": {_AHEAD: "constexpr int kAhead = 4;"},
    "k2_ahead8": {_AHEAD: "constexpr int kAhead = 8;"},
    "k2_free_registers": {"__launch_bounds__(kThreads, 3)\nrerank_gip_kernel":
                          "__launch_bounds__(kThreads)\nrerank_gip_kernel"},
}
# 16 rows of f32 values are one 64-byte shared-memory access
_WORD64 = ("template <> struct Word<32> { using T = Word32; };",
           "template <> struct Word<32> { using T = Word32; };\n"
           "struct alignas(16) Word64 { uint4 a, b, c, d; };\n"
           "template <> struct Word<64> { using T = Word64; };")


def _compile(name: str, src_dir: Path, out_dir: Path, main: str,
             edits: dict, build):
    """Start nvcc on an edited copy of ``src_dir``; returns (proc, lib)."""
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    for f in src_dir.iterdir():
        s = f.read_text()
        if f.suffix == ".cuh":
            s = s.replace(*_WORD64)
        for old, new in edits.items():
            if f.name == main:
                if old not in s:
                    raise RuntimeError(f"{name}: {old!r} not in {main}")
                s = s.replace(old, new)
        (d / f.name).write_text(s)
    lib = out_dir / f"{name}.so"
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(d / main)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--parent-csrc", type=Path, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_ablation needs a CUDA device")
    from dhr_tpu_torch.ops import _build
    from dhr_tpu_torch.ops.gip_candidates import (
        QUERY_ROWS, candidates_plan, gip_candidates, gip_candidates_plain,
        reduced_lanes)
    from dhr_tpu_torch.ops.rerank_gip import rerank_gip
    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.synth import synth_index_planes, synth_reps

    pg = importlib.import_module("dhr_tpu_torch.ops.partial_gip")
    out_dir = _build.build_dir().parent / "k1_ablation"
    builds = {name: _compile(name, _build.CSRC, out_dir, "partial_gip.cu",
                             edits, _build)
              for name, edits in K1_VARIANTS.items()}
    builds.update({name: _compile(name, _build.CSRC, out_dir,
                                  "gip_candidates.cu", edits, _build)
                   for name, edits in K3_VARIANTS.items()})
    if args.parent_csrc is not None:
        builds.update({name: _compile(name, _build.CSRC, out_dir,
                                      "rerank_gip.cu", edits, _build)
                       for name, edits in K2_VARIANTS.items()})
        for k in ("partial_gip", "gip_candidates", "rerank_gip"):
            builds[f"parent_{k}"] = _compile(
                f"parent_{k}", args.parent_csrc, out_dir, f"{k}.cu", {},
                _build)
    regs = {}
    for name, (proc, _) in builds.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        regs[name] = max(map(int, re.findall(r"Used (\d+) registers",
                                             report)))

    def use(kernel: str, name: str) -> None:
        _build._loaded[kernel] = ctypes.CDLL(str(builds[name][1]))

    N, B, G = args.rows, 128, 8
    v, f, scales, _ = synth_index_planes(0, N, device="cuda")
    idx = DeviceIndex.from_arrays(v, f, np.arange(1).astype(str), LEX_DIM,
                                  scales, device="cuda")
    del v, f
    qv, qf, _ = synth_reps(0, B, role="query", stream=1, device="cuda")
    searcher = Searcher(idx, SearchConfig(
        theta=0.3, max_important_dims=48, rerank=True, agip_topk=10000,
        topk=1000, query_batch=B))
    qvb, qv1, qi = searcher.prepare_queries(qv, qf)
    imp = pg.select_important(qv1, qi, 48)
    vt, it = idx.values_T, idx.indices_T
    D = vt.shape[0]
    plan = pg.staging_plan(*imp, D, LEX_DIM, 1, 1)
    plan3 = candidates_plan(*imp, D, LEX_DIM, 1, 1)
    want = pg.partial_gip_plain(*imp, vt, it, LEX_DIM, torch.bfloat16)
    want3 = gip_candidates_plain(*imp, vt, it, LEX_DIM, G, True)

    def ms(fn, iters=10):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def with_tile(p, t):
        return dataclasses.replace(p, chunks=(
            dataclasses.replace(p.chunks[0], tile=t),))

    def k1(name, tile=None):
        use("partial_gip", name)
        p = plan if tile is None else with_tile(plan, tile)
        fn = lambda: pg.partial_gip(  # noqa: E731
            *imp, vt, it, LEX_DIM, torch.bfloat16, plan=p)
        if name not in ("stage_only", "compute_only") \
                and not torch.equal(fn(), want):
            raise AssertionError(f"K1 {name} tile {tile}: not bit-equal")
        return fn

    def k3(name, tile=None):
        use("gip_candidates", name)
        p = plan3 if tile is None else with_tile(plan3, tile)
        fn = lambda: gip_candidates(  # noqa: E731
            *imp, vt, it, LEX_DIM, G, True, plan=p)
        if name not in ("k3_stage_only", "k3_compute_only") and not \
                torch.equal(fn().view(torch.int32), want3.view(torch.int32)):
            raise AssertionError(f"K3 {name} tile {tile}: not bit-equal")
        return fn

    runs = [(k1, "as_built", None), (k1, "rows4", None),
            (k1, "rows16", None), (k1, "stage_only", None),
            (k1, "compute_only", None), (k1, "as_built", 32),
            (k1, "as_built", 128),
            (k3, "k3_as_built", None), (k3, "k3_stage_only", None),
            (k3, "k3_compute_only", None), (k3, "k3_two_buffers", None),
            (k3, "k3_as_built", 32), (k3, "k3_small_blocks", 32)]
    c3 = plan3.chunks[0]

    def fits(kern, name, tile):
        """Whether a K3 tile override fits a block: its shared memory and
        its lanes for the batch's queries."""
        if kern is not k3 or tile is None:
            return True
        return B * tile <= QUERY_ROWS and pg.staged_bytes(
            c3.dims.numel(), c3.n_lex, tile, 1, 1) <= pg.SMEM_BYTES

    times: dict[str, list[float] | None] = {}
    for kern, name, tile in runs + runs[::-1]:   # in turns: forward, back
        key = name if tile is None else f"{name}_tile{tile}"
        if not fits(kern, name, tile):
            times[key] = None    # does not fit at this batch's |U|
            continue
        times.setdefault(key, []).append(ms(kern(name, tile)))
    use("partial_gip", "as_built")
    use("gip_candidates", "k3_as_built")

    if args.parent_csrc is not None:
        K = _build.KIND
        stream = torch.cuda.current_stream().cuda_stream
        _, cand = searcher.select(searcher.stage1(qv1, qi))
        cand = cand.contiguous()
        vals, ind = idx.values, idx.indices
        P = reduced_lanes(N, G)
        par3 = ctypes.CDLL(str(builds["parent_gip_candidates"][1]))
        par3 = par3.gip_candidates_launch
        par3.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4
                         + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        out3 = torch.empty(B, P, dtype=torch.float32, device="cuda")

        def parent_k3():
            err = par3(*(t.data_ptr() for t in imp), vt.data_ptr(),
                       it.data_ptr(), out3.data_ptr(), 0, N, vt.stride(0),
                       it.stride(0), P, B, 48, D, LEX_DIM, G, 4096,
                       K[torch.int8], K[torch.int8], K[torch.float32], 1,
                       stream)
            if err:
                raise RuntimeError(f"parent K3: CUDA error {err}")

        k1_fn = lambda: pg.partial_gip(  # noqa: E731
            *imp, vt, it, LEX_DIM, torch.bfloat16, plan=plan)
        k3_fn = lambda: gip_candidates(  # noqa: E731
            *imp, vt, it, LEX_DIM, G, True, plan=plan3)
        # the span the parent's K3 covers: today's K3 makes its plan first
        k3_plan_fn = lambda: gip_candidates(  # noqa: E731
            *imp, vt, it, LEX_DIM, G, True)
        k2_fn = lambda: rerank_gip(qvb, qi, cand, vals, ind,  # noqa: E731
                                   LEX_DIM)
        # key: (kernel, library, call); parent and today's in turns
        sets = {
            "parent_k1": ("partial_gip", "parent_partial_gip", k1_fn),
            "k1": ("partial_gip", "as_built", k1_fn),
            "parent_k3": (None, None, parent_k3),
            "k3": ("gip_candidates", "k3_as_built", k3_fn),
            "k3_with_plan": ("gip_candidates", "k3_as_built", k3_plan_fn),
            "parent_k2": ("rerank_gip", "parent_rerank_gip", k2_fn),
            "k2": ("rerank_gip", "k2_as_built", k2_fn),
            **{name: ("rerank_gip", name, k2_fn)
               for name in K2_VARIANTS if name != "k2_as_built"},
        }

        def ready(key):
            kernel, name, fn = sets[key]
            if kernel is not None:
                use(kernel, name)
            return fn

        got = {key: ready(key)() for key in sets}
        got["parent_k3"] = out3
        torch.cuda.synchronize()
        if not torch.equal(got["parent_k1"], got["k1"]):
            raise AssertionError("parent and today's K1 disagree")
        for key in ("k3", "k3_with_plan"):
            if not torch.equal(got["parent_k3"].view(torch.int32),
                               got[key].view(torch.int32)):
                raise AssertionError(f"parent and today's K3 ({key}) "
                                     "disagree")
        p2 = got["parent_k2"]
        fin = torch.isfinite(p2)
        for key in ("k2", *list(K2_VARIANTS)[1:]):
            k2 = got[key]
            if not torch.equal(fin, torch.isfinite(k2)) or not (
                    float((k2[fin] - p2[fin]).abs().max())
                    <= 1e-4 * max(float(p2[fin].abs().max()), 1.0)):
                raise AssertionError(f"parent and today's K2 ({key}) "
                                     "disagree")
        del got, p2, k2
        keys = list(sets)
        for key in keys + keys[::-1]:   # in turns: forward, then back
            times.setdefault(key, []).append(ms(ready(key)))
        use("partial_gip", "as_built")
        use("gip_candidates", "k3_as_built")
        use("rerank_gip", "k2_as_built")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    c = plan.chunks[0]
    print(json.dumps({
        "card": card, "rows": N, "queries": B, "plan_tile": c.tile,
        "k3_plan_tile": c3.tile, "k3_plan_chunks": len(plan3.chunks),
        "k3_staged_dims": c3.dims.numel(),
        "staged_dims": c.dims.numel(), "staged_lex_dims": c.n_lex,
        "counts_mean": float(plan.counts.float().mean()),
        "max_registers": regs, "ms": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
