"""K3: the theta pass fused with a per-group (max, argmax) reduction, a CUDA
kernel beside its plain version.

Replaces the Pallas TPU kernel ``pallas_gip_candidates``
(``dhr_tpu/ops/pallas_gip.py:346-461``, entered through
``partial_gip_candidates_pallas`` at 464-478; decoder
``decode_packed_candidates`` at 321-338).  It forms K1's f32 theta-pass
sums (``ops.partial_gip``) and reduces every group of ``G`` rows to its
best row, so candidate selection reads a plane ``G`` times smaller and the
``(B, N)`` score plane is never written.

The partition is the reference's: row ``r`` sits at reduced position
``p = (r // (128 G)) * 128 + r % 128`` with local index
``j = (r // 128) % G``.  The first maximum in ``j`` order wins.  ``N`` needs
no multiple: the reduced plane has ``P = ceil(N / (128 G)) * 128`` lanes,
rows ``>= N`` take no part, and a group without a valid row holds ``-inf``
(with ``j = 0`` packed, row id ``N`` in two planes).  On ``N`` a multiple of
``128 G`` the output equals the reference's.

Outputs: with ``packed_ids`` (``G`` a power of two) one ``(B, P)`` f32 plane
with the winner's ``j`` in the low ``log2 G`` mantissa bits; else
``(scores (B, P) out_dtype, rows (B, P) int32)``.

Bound on the card: bytes — K1's reads (the batch's distinct used dim rows
of values and folds, each once) plus ``B * P * 4`` bytes of output (two
planes: plus the row plane).  The kernel (``csrc/gip_candidates.cu``) is
K1's staged design walked over whole groups: a block owns ``T`` lanes of
one group block, stages each of its ``G`` row segments for every distinct
dim once (:func:`candidates_plan`: K1's :func:`staging_plan` with this
kernel's tile picker), computes every query from that copy with K1's
arithmetic, keeps the running maxima in registers and writes each reduced
lane once.  Planes as K1's: each row 16-byte aligned on the card.

Routing: a CPU tensor goes to :func:`gip_candidates_plain`; a CUDA tensor
launches the kernel or raises.  The recorder's counter
``launches.gip_candidates`` counts launches (one per query chunk of the
plan), and the plan's reads and its gap count as K1's do
(``ops.partial_gip``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dhr_tpu_torch.ops import _build
from dhr_tpu_torch.ops.partial_gip import (
    _MAX_SLOTS,
    SMEM_BYTES,
    SMEM_TWO_BLOCKS,
    TILES,
    StagingPlan,
    _check,
    partial_gip_plain,
    select_important,
    staged_bytes,
    staging_plan,
)
from dhr_tpu_torch.utils import profiling

LANE = 128
# The kernel's launch limits, as csrc gip_candidates_limits reports them
# (held equal on the card by tests/test_torch_kernels.py and chip_smoke.py):
# the (query, row) pairs whose running maxima a block holds (512 lanes x 2
# query groups x 8 rows), and the largest group (j travels in a byte).
QUERY_ROWS = 512 * 2 * 8
MAX_GROUP = 256


def reduced_lanes(n_rows: int, reduce_block: int) -> int:
    """``P``: lanes of the reduced plane over ``n_rows`` rows."""
    return -(-n_rows // (LANE * reduce_block)) * LANE


def pick_candidates_tile(n_dims: int, n_lex: int, n_queries: int,
                         value_bytes: int, index_bytes: int,
                         smem_bytes: int = SMEM_BYTES) -> int | None:
    """K3's lane tile for ``n_queries`` queries over a union of ``n_dims``
    dims (``n_lex`` lexical): each warp keeps its queries' running maxima
    in registers, so a block holds at most ``QUERY_ROWS / tile`` queries;
    of the tiles that allow that and whose staged rows fit ``smem_bytes``,
    the largest at which two blocks share an SM, else the largest; None
    when there is none."""
    if n_dims > _MAX_SLOTS:
        return None
    fp = lambda t: staged_bytes(  # noqa: E731
        n_dims, n_lex, t, value_bytes, index_bytes)
    tiles = [t for t in TILES
             if n_queries * t <= QUERY_ROWS and fp(t) <= smem_bytes]
    two = [t for t in tiles if fp(t) <= SMEM_TWO_BLOCKS]
    return (two or tiles or [None])[0]


def candidates_plan(imp_vals, imp_dims, imp_gates, dim: int, lex_dim: int,
                    value_bytes: int, index_bytes: int,
                    smem_bytes: int = SMEM_BYTES) -> StagingPlan:
    """K3's staging plan: :func:`staging_plan` with K3's tile picker (a
    chunk holds at most as many queries as a block has lanes for)."""
    return staging_plan(imp_vals, imp_dims, imp_gates, dim, lex_dim,
                        value_bytes, index_bytes, smem_bytes,
                        pick=pick_candidates_tile)


def _pack(best: torch.Tensor, j: torch.Tensor, G: int) -> torch.Tensor:
    bits = (best.view(torch.int32) & -G) | j.to(torch.int32)
    return bits.view(torch.float32)


def gip_candidates_plain(imp_vals, imp_dims, imp_gates, values_T, indices_T,
                         lex_dim: int, reduce_block: int = 8,
                         packed_ids: bool = False,
                         out_dtype=torch.bfloat16):
    """Plain PyTorch version: K1's plain f32 sums, padded with ``-inf`` to
    whole groups, then the first max / argmax over ``j``."""
    G = reduce_block
    sums = partial_gip_plain(imp_vals, imp_dims, imp_gates, values_T,
                             indices_T, lex_dim, torch.float32)
    B, N = sums.shape
    P = reduced_lanes(N, G)
    sums = F.pad(sums, (0, P * G - N), value=float("-inf"))
    best, j = sums.reshape(B, P // LANE, G, LANE).max(dim=2)
    best, j = best.reshape(B, P), j.reshape(B, P)
    if packed_ids:
        return _pack(best.contiguous(), j, G)
    pos = torch.arange(P, device=sums.device)
    rows = (pos // LANE) * (G * LANE) + j * LANE + pos % LANE
    return best.to(out_dtype), rows.clamp(max=N).to(torch.int32)


def decode_packed_candidates(packed: torch.Tensor, pos: torch.Tensor,
                             reduce_block: int):
    """``(scores, rows)`` of packed winners picked at reduced positions
    ``pos``: the f32 score with the id bits cleared (< G ulps from the
    true score) and the absolute row (int64), by arithmetic alone.  A
    picked ``-inf`` lane decodes to a row ``>= N``."""
    G = reduce_block
    u = packed.contiguous().view(torch.int32)
    j = (u & (G - 1)).long()
    scores = (u & -G).view(torch.float32)
    pos = pos.long()
    rows = (pos // LANE) * (G * LANE) + j * LANE + pos % LANE
    return scores, rows


def gip_candidates(imp_vals, imp_dims, imp_gates, values_T, indices_T,
                   lex_dim: int, reduce_block: int = 8,
                   packed_ids: bool = False, out_dtype=torch.bfloat16,
                   plan: StagingPlan | None = None):
    """Per-group winners of the theta pass over ``(B, N)`` rows.

    Inputs as :func:`ops.partial_gip.partial_gip`.  Returns one ``(B, P)``
    f32 plane (``packed_ids``; ``out_dtype`` is ignored: the id bits need
    the f32 mantissa) or ``(scores (B, P) out_dtype, rows (B, P) int32)``.
    ``plan``: a :func:`candidates_plan` of these inputs, made here when
    None.
    """
    G = int(reduce_block)
    _check(imp_vals, imp_dims, imp_gates, values_T, indices_T, lex_dim,
           out_dtype)
    if G < 1 or (packed_ids and G & (G - 1)):
        raise ValueError(f"reduce_block={G} must be >= 1, and a power of "
                         "two with packed_ids")
    dev = values_T.device
    if dev.type == "cpu":
        return gip_candidates_plain(imp_vals, imp_dims, imp_gates, values_T,
                                    indices_T, lex_dim, G, packed_ids,
                                    out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"gip_candidates runs on cuda or cpu, not {dev}")
    B, n_imp = imp_vals.shape
    D, N = values_T.shape
    if G > MAX_GROUP or N >= 2**31:
        raise ValueError(f"shape out of the kernel's range: N={N}, G={G} "
                         f"(G <= {MAX_GROUP}, N < 2**31)")
    P = reduced_lanes(N, G)
    vals = torch.empty(B, P, dtype=torch.float32 if packed_ids else out_dtype,
                       device=dev)
    rows = None if packed_ids else torch.empty(B, P, dtype=torch.int32,
                                               device=dev)
    if B == 0 or N == 0:
        return vals if packed_ids else (vals, rows)
    made = plan is None
    if made:
        plan = candidates_plan(imp_vals, imp_dims, imp_gates, D, lex_dim,
                               values_T.element_size(),
                               indices_T.element_size())
    launch = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if made:
        profiling.record("search.plan_gap", plan.read_at)
    for c in plan.chunks:
        err = launch(
            plan.entries[c.start].data_ptr(), plan.counts[c.start].data_ptr(),
            plan.order[c.start].data_ptr(), c.dims.data_ptr(),
            values_T.data_ptr(), indices_T.data_ptr(),
            vals[c.start].data_ptr(),
            0 if rows is None else rows[c.start].data_ptr(), N,
            values_T.stride(0), indices_T.stride(0), P, c.stop - c.start,
            n_imp, c.dims.numel(), c.n_lex, G, c.tile,
            _build.KIND[values_T.dtype], _build.KIND[indices_T.dtype],
            _build.KIND[out_dtype], int(packed_ids), stream,
        )
        if err:
            raise RuntimeError(f"gip_candidates kernel launch failed: CUDA "
                               f"error {err}")
        profiling.count("launches.gip_candidates")
    return vals if packed_ids else (vals, rows)


def kernel_limits() -> tuple[int, int]:
    """``(query rows, largest group)`` as the built kernel reports them
    (needs the card's build)."""
    q, g = ctypes.c_int(), ctypes.c_int()
    _build.load("gip_candidates").gip_candidates_limits(ctypes.byref(q),
                                                        ctypes.byref(g))
    return q.value, g.value


def _launcher():
    fn = _build.load("gip_candidates").gip_candidates_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def partial_gip_candidates(qv, qi, values_T, indices_T, lex_dim: int,
                           n_dims: int, reduce_block: int = 8,
                           packed_ids: bool = False,
                           out_dtype=torch.bfloat16):
    """Twin of ``partial_gip_candidates_pallas``: select, then reduce."""
    imp = select_important(qv, qi, n_dims)
    return gip_candidates(*imp, values_T, indices_T, lex_dim, reduce_block,
                          packed_ids, out_dtype)
