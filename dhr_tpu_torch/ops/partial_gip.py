"""K1: theta-pass partial GIP scores, a CUDA kernel beside its plain version.

Replaces the Pallas TPU kernel ``pallas_partial_gip``
(``dhr_tpu/ops/pallas_gip.py:115-207``, entered through
``partial_gip_scores_pallas`` at 210-220).  For query ``b`` and row ``n``::

    scores[b, n] = sum_i imp_vals[b, i] * values_T[d_i, n] * gate
    gate         = d_i >= lex_dim  or  indices_T[d_i, n] == imp_gates[b, i]

with ``d_i = imp_dims[b, i]``.  Index values compare widened to int32.
Accumulation is f32 in the order of the important dims; the output is f32,
or bf16 cast once from the f32 sums.

Bound on the card: bytes — the batch's distinct non-zero important dim
rows of the dim-major value and index planes, each read once, and
``B * N * out`` bytes of scores.  The kernel (``csrc/partial_gip.cu``)
reads those rows once per row tile for the whole batch: each block stages
the tile's segment of every distinct dim row in shared memory
(:func:`staging_plan` picks the dims, the tile and, if the union does not
fit, a split of the batch) and computes every query from that copy.

The planes are ``(D, N)`` with unit stride along ``N`` and any row pitch;
on the card each row must start 16-byte aligned (``DeviceIndex`` pads the
pitch to a multiple of 128 elements, ``retrieval.index.dim_major``).

Routing: a CPU tensor goes to :func:`partial_gip_plain`; a CUDA tensor
launches the kernel or raises.  The recorder's counter
``launches.partial_gip`` counts launches (one per query chunk of the
plan); each read of the device's data by :func:`staging_plan` counts
under ``search.host_reads``, and the host's time from the plan's last read
to the first launch, when the device has nothing queued, is the span
``search.plan_gap`` (``utils.profiling``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

from dhr_tpu_torch.ops import _build
from dhr_tpu_torch.utils import profiling

VALUE_DTYPES = (torch.int8, torch.bfloat16, torch.float16, torch.float32)
INDEX_DTYPES = (torch.int8, torch.int16)
OUT_DTYPES = (torch.float32, torch.bfloat16)
TILES = (128, 64, 32, 16)     # rows of a row tile, largest first
SMEM_BYTES = 227 * 1024       # dynamic shared memory of one block (H100)
# per block when two share an SM: 228 KB, less 1 KB the system keeps per block
SMEM_TWO_BLOCKS = 113 * 1024
_NO_SLOT = 0xFFFF             # a kernel key's slot for a skipped dim
_MAX_SLOTS = _NO_SLOT         # slots 0..65534 fit the key's 16 bits


def partial_gip_plain(imp_vals, imp_dims, imp_gates, values_T, indices_T,
                      lex_dim: int, out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version: a twin of the reference scan
    ``searcher._partial_gip_scores`` with the kernel's ``out_dtype``
    (accumulate in f32, cast once)."""
    B, n_imp = imp_vals.shape
    n_rows = values_T.shape[1]
    acc = torch.zeros(B, n_rows, dtype=torch.float32, device=values_T.device)
    for i in range(n_imp):
        d = imp_dims[:, i].long()
        prod = values_T[d].float() * imp_vals[:, i, None].float()
        gate = indices_T[d.clamp(max=lex_dim - 1)] == imp_gates[:, i, None]
        gate |= (d >= lex_dim)[:, None]
        acc += prod.masked_fill_(~gate, 0.0)
    return acc.to(out_dtype)


# -- the staging plan ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Chunk:
    """Consecutive queries ``[start, stop)`` that one launch computes from
    one staged copy: ``dims`` (int32, sorted) are their distinct used dims,
    the first ``n_lex`` of them lexical, staged ``tile`` rows at a time."""

    start: int
    stop: int
    dims: torch.Tensor
    n_lex: int
    tile: int


@dataclasses.dataclass(frozen=True)
class StagingPlan:
    """``slots[b, i]``: the slot of ``imp_dims[b, i]`` in its chunk's
    ``dims``, or -1 for a skipped dim (zero weight, or outside [0, D)).
    ``entries`` / ``counts``: the kernel's per-query work
    (:func:`kernel_entries`); ``order``: each chunk's queries (numbered
    from its start) by their count, the order the kernel takes them in, so
    the queries that share a warp have similar counts.  ``read_at``: the
    host clock (``time.perf_counter``) as the plan's last read of the
    device returned."""

    slots: torch.Tensor
    chunks: tuple[Chunk, ...]
    entries: torch.Tensor
    counts: torch.Tensor
    order: torch.Tensor
    read_at: float = 0.0


def staged_bytes(n_dims: int, n_lex: int, tile: int, value_bytes: int,
                 index_bytes: int) -> int:
    """Shared memory of one block: ``tile`` rows of each staged value row,
    of each lexical dim's fold row, and of one zero fold row (CLS dims
    read it with gate 0)."""
    return tile * (n_dims * value_bytes + (n_lex + 1) * index_bytes)


def pick_tile(n_dims: int, n_lex: int, value_bytes: int, index_bytes: int,
              smem_bytes: int = SMEM_BYTES) -> int | None:
    """The row tile for a union of ``n_dims`` dims (``n_lex`` lexical):
    128 or 64 where two blocks then share an SM (one block's copies overlap
    the other's arithmetic), else the largest of 128 / 64 / 32 / 16 that
    fits ``smem_bytes``; None when none fits."""
    if n_dims > _MAX_SLOTS:
        return None
    fp = lambda t: staged_bytes(n_dims, n_lex, t, value_bytes,  # noqa: E731
                                index_bytes)
    for tile in TILES[:2]:
        if fp(tile) <= min(smem_bytes, SMEM_TWO_BLOCKS):
            return tile
    for tile in TILES:
        if fp(tile) <= smem_bytes:
            return tile
    return None


def staging_plan(imp_vals, imp_dims, imp_gates, dim: int, lex_dim: int,
                 value_bytes: int, index_bytes: int,
                 smem_bytes: int = SMEM_BYTES, pick=None) -> StagingPlan:
    """The kernel's staging plan for a batch of important dims.

    A dim is used where its weight is non-zero and it lies in ``[0, dim)``.
    One chunk holds the whole batch when the union of its used dims fits
    ``smem_bytes`` at some tile; otherwise the batch splits into
    consecutive query chunks, each as long as its union fits.  Everything
    is queued on the device first and the union's size read last: one
    device-to-host read, so the device idles only from that read to the
    launch (more reads only to split).  ``pick(n_dims, n_lex, n_queries,
    value_bytes, index_bytes, smem_bytes)`` chooses a chunk's tile (None:
    it does not fit); by default K1's :func:`pick_tile`.
    """
    B, n_imp = imp_dims.shape
    dev = imp_dims.device
    d = imp_dims.long()
    used = (imp_vals != 0) & (d >= 0) & (d < dim)
    d = torch.where(used, d, dim)
    present = torch.zeros(B, dim + 1, dtype=torch.bool, device=dev)
    present.scatter_(1, d, True)
    union = present[:, :dim].any(0)
    slots = _slot_table(union)[d]
    dims = torch.nonzero_static(union, size=dim).flatten().int()
    entries, counts = kernel_entries(slots, imp_vals, imp_dims, imp_gates,
                                     lex_dim, index_bytes)
    order = torch.argsort(counts).int()
    n_u, n_lex = torch.stack([union.sum(), union[:lex_dim].sum()]).tolist()
    read_at = time.perf_counter()
    profiling.count("search.host_reads")
    if pick is None:
        pick = lambda u, lx, nq, *a: pick_tile(u, lx, *a)  # noqa: E731
    fits = lambda u, lx, nq: pick(u, lx, nq, value_bytes,  # noqa: E731
                                  index_bytes, smem_bytes)
    if fits(n_u, n_lex, B) is not None:
        chunk = Chunk(0, B, dims[:n_u], n_lex, fits(n_u, n_lex, B))
        return StagingPlan(slots, (chunk,), entries, counts, order, read_at)
    chunks = []
    present_host = present[:, :dim].cpu().numpy()
    profiling.count("search.host_reads")
    for start, stop in _split(present_host, lex_dim, fits):
        u = present[start:stop, :dim].any(0)
        n_u, n_lex = torch.stack([u.sum(), u[:lex_dim].sum()]).tolist()
        read_at = time.perf_counter()
        profiling.count("search.host_reads")
        slots[start:stop] = _slot_table(u)[d[start:stop]]
        chunks.append(Chunk(start, stop,
                            torch.nonzero_static(u, size=n_u).flatten().int(),
                            n_lex, fits(n_u, n_lex, stop - start)))
    entries, counts = kernel_entries(slots, imp_vals, imp_dims, imp_gates,
                                     lex_dim, index_bytes)
    order = torch.cat([torch.argsort(counts[c.start:c.stop]).int()
                       for c in chunks])
    return StagingPlan(slots, tuple(chunks), entries, counts, order,
                       read_at)


def _slot_table(union: torch.Tensor) -> torch.Tensor:
    """int32 ``(dim + 1,)``: each dim of ``union`` its slot (its rank in
    the union), and -1 at index ``dim``, where skipped entries point."""
    ranks = torch.cumsum(union, 0, dtype=torch.int32) - 1
    return torch.cat([ranks, ranks.new_full((1,), -1)])


def _split(present: np.ndarray, lex_dim: int, fits) -> list[tuple[int, int]]:
    """Greedy query chunks whose unions (and queries) fit."""
    bounds, start = [], 0
    acc = np.zeros(present.shape[1], dtype=bool)
    size = lambda u: (int(u.sum()), int(u[:lex_dim].sum()))  # noqa: E731
    for b in range(present.shape[0]):
        grown = acc | present[b]
        if b > start and fits(*size(grown), b + 1 - start) is None:
            bounds.append((start, b))
            start, grown = b, present[b]
        if fits(*size(grown), b + 1 - start) is None:
            raise ValueError(
                f"query {b} alone uses {int(present[b].sum())} dims: too "
                "many to stage in shared memory at any tile")
        acc = grown
    bounds.append((start, present.shape[0]))
    return bounds


def kernel_entries(slots, imp_vals, imp_dims, imp_gates, lex_dim: int,
                   index_bytes: int):
    """The kernel's per-query work from a plan's ``slots``: ``(entries
    (B, I, 2) int32, counts (B,) int32)``.  ``entries[b, :counts[b]]`` are
    query ``b``'s used dims in their order, each ``(bits of its f32
    weight, slot | gate << 16)``; the rest hold slot 0xFFFF.  A CLS dim's
    gate is 0 (the kernel gates it against a zero fold row: always open).
    A lexical dim whose gate lies outside the folds' range (``index_bytes``
    wide) can match no fold and is left out too: its gated product is
    +0.0, which leaves an f32 sum's bits unchanged; so the kernel may
    compare a gate's low bits alone."""
    slot = slots.long()
    lex = imp_dims < lex_dim
    gate = torch.where(lex, imp_gates.long(), 0)
    half = 1 << (8 * index_bytes - 1)
    never = lex & ((gate < -half) | (gate >= half))
    skip = (slot < 0) | never
    key = (slot & 0xFFFF) | ((gate & 0xFFFF) << 16)
    key = torch.where(skip, _NO_SLOT, key)
    key = torch.where(key >= 1 << 31, key - (1 << 32), key).int()
    order = torch.argsort(skip.to(torch.int8), dim=1, stable=True)
    entries = torch.stack([torch.gather(imp_vals, 1, order).view(torch.int32),
                           torch.gather(key, 1, order)], dim=-1)
    return entries.contiguous(), (~skip).sum(1, dtype=torch.int32)


# -- the wrapper --------------------------------------------------------------


def check_planes(values_T, indices_T, aligned: bool) -> None:
    """Dim-major planes: unit stride along the rows; with ``aligned`` (the
    kernels' route) every dim row starts 16-byte aligned."""
    for name, t in (("values_T", values_T), ("indices_T", indices_T)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} must have unit stride along its rows "
                             f"(strides {tuple(t.stride())})")
        pitch = t.stride(0) if t.shape[0] > 1 else 0
        if aligned and ((pitch * t.element_size()) % 16
                        or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: each dim row must start 16-byte aligned (row "
                f"pitch {t.stride(0)} x {t.element_size()} B): build the "
                "planes with retrieval.index.dim_major, which pads the "
                "pitch to a multiple of 128 elements")


def _check(imp_vals, imp_dims, imp_gates, values_T, indices_T, lex_dim,
           out_dtype):
    if values_T.dim() != 2 or indices_T.dim() != 2:
        raise ValueError("values_T must be (D, N) and indices_T (lex, N)")
    D, N = values_T.shape
    if indices_T.shape != (lex_dim, N) or not 0 < lex_dim <= D:
        raise ValueError(
            f"indices_T {tuple(indices_T.shape)} must be (lex_dim={lex_dim}, "
            f"N={N}) with 0 < lex_dim <= D={D}")
    if imp_vals.dim() != 2 or imp_dims.shape != imp_vals.shape \
            or imp_gates.shape != imp_vals.shape:
        raise ValueError("imp_vals, imp_dims, imp_gates must all be (B, I)")
    if imp_vals.dtype != torch.float32 or imp_dims.dtype != torch.int32 \
            or imp_gates.dtype != torch.int32:
        raise TypeError("imp_vals must be f32, imp_dims / imp_gates int32")
    if values_T.dtype not in VALUE_DTYPES:
        raise TypeError(f"value plane dtype {values_T.dtype} not in "
                        f"{VALUE_DTYPES}")
    if indices_T.dtype not in INDEX_DTYPES:
        raise TypeError(f"index plane dtype {indices_T.dtype} not in "
                        f"{INDEX_DTYPES}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {OUT_DTYPES}")
    tensors = (imp_vals, imp_dims, imp_gates, values_T, indices_T)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must lie on one device")
    if not all(t.is_contiguous() for t in tensors[:3]):
        raise ValueError("imp_vals, imp_dims, imp_gates must be contiguous")
    check_planes(values_T, indices_T, values_T.device.type == "cuda")


def partial_gip(imp_vals, imp_dims, imp_gates, values_T, indices_T,
                lex_dim: int, out_dtype=torch.float32,
                plan: StagingPlan | None = None) -> torch.Tensor:
    """Partial GIP scores ``(B, N)`` from selected important dims.

    ``imp_vals`` (B, I) f32, ``imp_dims`` / ``imp_gates`` (B, I) int32,
    contiguous; ``values_T`` (D, N) int8/bf16/f16/f32, ``indices_T``
    (lex_dim, N) int8/int16, unit stride along N (16-byte aligned rows on
    the card); all on one device.  ``plan``: a :func:`staging_plan` of
    these inputs, made here when None.
    """
    _check(imp_vals, imp_dims, imp_gates, values_T, indices_T, lex_dim,
           out_dtype)
    dev = values_T.device
    if dev.type == "cpu":
        return partial_gip_plain(imp_vals, imp_dims, imp_gates, values_T,
                                 indices_T, lex_dim, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"partial_gip runs on cuda or cpu, not {dev}")
    B, n_imp = imp_vals.shape
    D, N = values_T.shape
    out = torch.empty(B, N, dtype=out_dtype, device=dev)
    if B == 0 or N == 0:
        return out
    if n_imp == 0:
        return out.zero_()
    made = plan is None
    if made:
        plan = staging_plan(imp_vals, imp_dims, imp_gates, D, lex_dim,
                            values_T.element_size(), indices_T.element_size())
    launch = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if made:
        profiling.record("search.plan_gap", plan.read_at)
    for c in plan.chunks:
        err = launch(
            plan.entries[c.start].data_ptr(), plan.counts[c.start].data_ptr(),
            plan.order[c.start].data_ptr(),
            c.dims.data_ptr(), values_T.data_ptr(), indices_T.data_ptr(),
            out[c.start].data_ptr(), N, values_T.stride(0),
            indices_T.stride(0), c.stop - c.start, n_imp, c.dims.numel(),
            c.n_lex, c.tile, _build.KIND[values_T.dtype],
            _build.KIND[indices_T.dtype], _build.KIND[out_dtype], stream,
        )
        if err:
            raise RuntimeError(f"partial_gip kernel launch failed: CUDA "
                               f"error {err}")
        profiling.count("launches.partial_gip")
    return out


def _launcher():
    fn = _build.load("partial_gip").partial_gip_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def select_important(qv: torch.Tensor, qi: torch.Tensor, n_dims: int):
    """``(imp_vals, imp_dims, imp_gates)``: each query's top ``n_dims`` dims
    by value (descending) and its fold index at each of them."""
    imp_val, imp_dim = torch.topk(qv, n_dims, dim=-1)
    imp_gate = torch.gather(qi, -1, imp_dim)
    return (imp_val.float().contiguous(), imp_dim.int().contiguous(),
            imp_gate.int().contiguous())


def partial_gip_scores(qv, qi, values_T, indices_T, lex_dim: int,
                       n_dims: int, out_dtype=torch.float32) -> torch.Tensor:
    """Twin of ``partial_gip_scores_pallas``: select, then score.

    ``qv`` (B, D) f32 is thresholded and scale-folded; ``qi`` (B, D) int32
    is padded with 1 over the CLS dims.
    """
    imp = select_important(qv, qi, n_dims)
    return partial_gip(*imp, values_T, indices_T, lex_dim, out_dtype)
