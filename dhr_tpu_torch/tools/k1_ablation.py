"""Where the theta-pass kernel's time goes, on one GPU.

    python -m dhr_tpu_torch.tools.k1_ablation [--rows N] [--parent-csrc DIR]

Builds K1 (``csrc/partial_gip.cu``) as it is, and variants made by editing
a copy of its source: 4 / 8 / 16 rows per lane; staging only (each block
returns once its copies land); compute only (no copies: shared memory as
found).  Times each in turns with CUDA events on the main path's first
batch: synthetic MS MARCO-size int8 planes (``retrieval.synth``, seed 0),
128 queries at theta 0.3 with 48 important dims, bf16 out; the plan's row
tile, and 32 and 128 rows for the as-built kernel.  Every full variant
must equal the plain version bit for bit.

``--parent-csrc DIR``: the ``csrc`` directory of the commit before the
padded pitch (its C entries take contiguous planes), e.g. unpacked with
``git archive``; its K1 and K3 are then timed on contiguous planes in turns
with today's on the padded ones, and their outputs compared.

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

# edits of the K1 source that make each variant (old text -> new text)
_ROWS_LINE = "constexpr int kRows = 8;"
VARIANTS = {
    "as_built": {},
    "rows4": {_ROWS_LINE: "constexpr int kRows = 4;"},
    "rows16": {_ROWS_LINE: "constexpr int kRows = 16;"},
    "stage_only": {
        "  dhr::cp_async_wait_all();\n  __syncthreads();\n":
        "  dhr::cp_async_wait_all();\n  __syncthreads();\n"
        "  if (n_u >= 0) return;\n"},
    "compute_only": {
        "for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {":
        "for (int c = threadIdx.x; c < 0 * n_chunks; c += blockDim.x) {"},
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
        gip_candidates, reduced_lanes)
    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.synth import synth_index_planes, synth_reps

    pg = importlib.import_module("dhr_tpu_torch.ops.partial_gip")
    out_dir = _build.build_dir().parent / "k1_ablation"
    builds = {name: _compile(name, _build.CSRC, out_dir, "partial_gip.cu",
                             edits, _build)
              for name, edits in VARIANTS.items()}
    if args.parent_csrc is not None:
        for k in ("partial_gip", "gip_candidates"):
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

    N, B = args.rows, 128
    v, f, scales, _ = synth_index_planes(0, N, device="cuda")
    idx = DeviceIndex.from_arrays(v, f, np.arange(1).astype(str), LEX_DIM,
                                  scales, layout="dim", device="cuda")
    del v, f
    qv, qf, _ = synth_reps(0, B, role="query", stream=1, device="cuda")
    _, qv1, qi = Searcher(idx, SearchConfig(
        theta=0.3, max_important_dims=48)).prepare_queries(qv, qf)
    imp = pg.select_important(qv1, qi, 48)
    vt, it = idx.values_T, idx.indices_T
    D = vt.shape[0]
    plan = pg.staging_plan(*imp, D, LEX_DIM, 1, 1)
    want = pg.partial_gip_plain(*imp, vt, it, LEX_DIM, torch.bfloat16)

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

    def with_tile(t):
        return dataclasses.replace(plan, chunks=(
            dataclasses.replace(plan.chunks[0], tile=t),))

    def k1(name, tile=None):
        _build._loaded["partial_gip"] = ctypes.CDLL(str(builds[name][1]))
        p = plan if tile is None else with_tile(tile)
        fn = lambda: pg.partial_gip(  # noqa: E731
            *imp, vt, it, LEX_DIM, torch.bfloat16, plan=p)
        if name not in ("stage_only", "compute_only") \
                and not torch.equal(fn(), want):
            raise AssertionError(f"K1 {name} tile {tile}: not bit-equal")
        return fn

    runs = [("as_built", None), ("rows4", None), ("rows16", None),
            ("stage_only", None), ("compute_only", None), ("as_built", 32),
            ("as_built", 128)]
    times: dict[str, list[float]] = {}
    for name, tile in runs + runs[::-1]:   # in turns: forward, then back
        key = name if tile is None else f"{name}_tile{tile}"
        times.setdefault(key, []).append(ms(k1(name, tile)))
    _build._loaded["partial_gip"] = ctypes.CDLL(str(builds["as_built"][1]))

    if args.parent_csrc is not None:
        vt_c, it_c = vt.contiguous(), it.contiguous()
        stream = torch.cuda.current_stream().cuda_stream
        K = _build.KIND
        par1 = ctypes.CDLL(str(builds["parent_partial_gip"][1]))
        par1 = par1.partial_gip_launch
        par1.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        out1 = torch.empty(B, N, dtype=torch.bfloat16, device="cuda")

        def parent_k1():
            err = par1(*(t.data_ptr() for t in imp), vt_c.data_ptr(),
                       it_c.data_ptr(), out1.data_ptr(), N, B, 48, D,
                       LEX_DIM, K[torch.int8], K[torch.int8],
                       K[torch.bfloat16], stream)
            if err:
                raise RuntimeError(f"parent K1: CUDA error {err}")
        G = 8
        P = reduced_lanes(N, G)
        par3 = ctypes.CDLL(str(builds["parent_gip_candidates"][1]))
        par3 = par3.gip_candidates_launch
        par3.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
                         + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        out3 = torch.empty(B, P, dtype=torch.float32, device="cuda")

        def parent_k3():
            err = par3(*(t.data_ptr() for t in imp), vt_c.data_ptr(),
                       it_c.data_ptr(), out3.data_ptr(), 0, N, P, B, 48, D,
                       LEX_DIM, G, 4096, K[torch.int8], K[torch.int8],
                       K[torch.float32], 1, stream)
            if err:
                raise RuntimeError(f"parent K3: CUDA error {err}")
        k1_now = k1("as_built")
        k3_now = lambda: gip_candidates(  # noqa: E731
            *imp, vt, it, LEX_DIM, G, True)
        parent_k1()
        parent_k3()
        if not torch.equal(out1, want) or not torch.equal(
                out3.view(torch.int32), k3_now().view(torch.int32)):
            raise AssertionError("parent and today's kernels disagree")
        for key, fn, iters in (("parent_k1", parent_k1, 5),
                               ("k1", k1_now, 10),
                               ("parent_k3", parent_k3, 5),
                               ("k3", k3_now, 10)):
            times[key] = [ms(fn, iters)]
        for key, fn, iters in (("k3", k3_now, 10), ("parent_k3", parent_k3, 5),
                               ("k1", k1_now, 10), ("parent_k1", parent_k1, 5)):
            times[key].append(ms(fn, iters))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    c = plan.chunks[0]
    print(json.dumps({
        "card": card, "rows": N, "queries": B, "plan_tile": c.tile,
        "staged_dims": c.dims.numel(), "staged_lex_dims": c.n_lex,
        "counts_mean": float(plan.counts.float().mean()),
        "max_registers": regs, "ms": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
