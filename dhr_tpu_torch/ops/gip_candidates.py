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

Bound on the card: bytes — K1's reads (``I`` dim rows of values and
indices per query) plus ``B * P * 4`` bytes of output (two planes: plus the
row plane).  The kernel (``csrc/gip_candidates.cu``) runs K1's arithmetic
per query, straight from the dim-major planes (each row 16-byte aligned on
the card, as for K1), and reduces each block's span in shared memory.

Routing: a CPU tensor goes to :func:`gip_candidates_plain`; a CUDA tensor
launches the kernel or raises.  ``gip_candidates.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from dhr_tpu_torch.ops import _build
from dhr_tpu_torch.ops.partial_gip import (
    _check,
    partial_gip_plain,
    select_important,
)

LANE = 128
_PASS_ROWS = 256 * 16    # rows of one pass of the kernel's threads
_MAX_SPAN = 8 * _PASS_ROWS   # 128 KB of f32 sums in shared memory
_MAX_IMP = 4096          # (val, dim, gate) triples staged in 48 KB of smem
_MAX_GRID_Y = 65535


def reduced_lanes(n_rows: int, reduce_block: int) -> int:
    """``P``: lanes of the reduced plane over ``n_rows`` rows."""
    return -(-n_rows // (LANE * reduce_block)) * LANE


def _span(reduce_block: int) -> int:
    """Rows per thread block: a multiple of a pass and of ``128 G``."""
    return math.lcm(_PASS_ROWS, LANE * reduce_block)


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
                   packed_ids: bool = False, out_dtype=torch.bfloat16):
    """Per-group winners of the theta pass over ``(B, N)`` rows.

    Inputs as :func:`ops.partial_gip.partial_gip`.  Returns one ``(B, P)``
    f32 plane (``packed_ids``; ``out_dtype`` is ignored: the id bits need
    the f32 mantissa) or ``(scores (B, P) out_dtype, rows (B, P) int32)``.
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
    span = _span(G)
    if n_imp > _MAX_IMP or span > _MAX_SPAN or N >= 2**31 \
            or -(-N // span) > _MAX_GRID_Y:
        raise ValueError(f"shape out of the kernel's range: B={B}, "
                         f"I={n_imp}, N={N}, G={G}")
    P = reduced_lanes(N, G)
    vals = torch.empty(B, P, dtype=torch.float32 if packed_ids else out_dtype,
                       device=dev)
    rows = None if packed_ids else torch.empty(B, P, dtype=torch.int32,
                                               device=dev)
    if B == 0 or N == 0:
        return vals if packed_ids else (vals, rows)
    err = _launcher()(
        imp_vals.data_ptr(), imp_dims.data_ptr(), imp_gates.data_ptr(),
        values_T.data_ptr(), indices_T.data_ptr(), vals.data_ptr(),
        0 if rows is None else rows.data_ptr(), N, values_T.stride(0),
        indices_T.stride(0), P, B, n_imp, D, lex_dim,
        G, span, _build.KIND[values_T.dtype], _build.KIND[indices_T.dtype],
        _build.KIND[out_dtype], int(packed_ids),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gip_candidates kernel launch failed: CUDA error "
                           f"{err}")
    gip_candidates.launches += 1
    return vals if packed_ids else (vals, rows)


gip_candidates.launches = 0


def _launcher():
    fn = _build.load("gip_candidates").gip_candidates_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4
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
