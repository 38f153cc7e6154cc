"""K2: exact GIP rerank of gathered candidates, a CUDA kernel beside its
plain version.

Replaces the Pallas TPU kernel ``pallas_rerank_gip``
(``dhr_tpu/ops/pallas_rerank.py:81-163``) and, on the search path, the
reference's ``(B, K, D)`` gather + ``_rerank_gip``
(``dhr_tpu/retrieval/searcher.py:339-354, 706-717``).  For query ``b`` and
candidate row ``r = rows[b, k]``::

    out[b, k] = sum_{j<lex} [indices[r, j] == qi[b, j]] * values[r, j] * qv[b, j]
              + sum_{j>=lex} values[r, j] * qv[b, j]

Index values compare widened to int32 (the reference casts ``qi`` down to
the plane's dtype instead; see ROADMAP "Faults found").  A row id outside
``[0, N)`` is never read and scores ``-inf``.

Bound on the card: bytes — ``B * K * (D * v + lex * i)`` gathered row bytes
(fewer where queries share candidates).  The kernel
(``csrc/rerank_gip.cu``) reads each candidate row with one warp in 16-byte
words (an element path where a row is not whole words), holds the query in
registers, loads the next candidate's row while it reduces this one, and
never materialises the ``(B, K, D)`` gather.  It sums in its own order
(fused multiply-adds), within ``1e-4`` relative of the plain version.

Routing: a CPU tensor goes to :func:`rerank_gip_plain`; a CUDA tensor
launches the kernel or raises.  The recorder's counter
``launches.rerank_gip`` counts launches (``utils.profiling``).
"""

from __future__ import annotations

import ctypes

import torch

from dhr_tpu_torch.ops import _build
from dhr_tpu_torch.ops.partial_gip import INDEX_DTYPES, VALUE_DTYPES
from dhr_tpu_torch.utils import profiling

_CAND_PER_BLOCK = 128   # 8 warps x 16 candidates (csrc/rerank_gip.cu)
_MAX_GRID = 65535


def rerank_gip_plain(qv, qi, rows, values, indices, lex_dim: int
                     ) -> torch.Tensor:
    """Plain PyTorch version: the reference's take + ``_rerank_gip``."""
    valid = (rows >= 0) & (rows < values.shape[0])
    safe = torch.where(valid, rows, 0)
    cand_v = values[safe]
    cand_i = indices[safe]
    gate = cand_i == qi[:, None, :lex_dim]
    lex_prod = cand_v[..., :lex_dim].float() * qv[:, None, :lex_dim]
    lex = torch.where(gate, lex_prod, 0.0).sum(dim=-1)
    cls = (cand_v[..., lex_dim:].float() * qv[:, None, lex_dim:]).sum(dim=-1)
    return torch.where(valid, lex + cls, float("-inf"))


def _check(qv, qi, rows, values, indices, lex_dim):
    if values.dim() != 2 or indices.dim() != 2:
        raise ValueError("values must be (N, D) and indices (N, lex)")
    N, D = values.shape
    if indices.shape != (N, lex_dim) or not 0 < lex_dim <= D:
        raise ValueError(
            f"indices {tuple(indices.shape)} must be (N={N}, "
            f"lex_dim={lex_dim}) with 0 < lex_dim <= D={D}")
    if qv.dim() != 2 or qv.shape[1] != D:
        raise ValueError(f"qv {tuple(qv.shape)} must be (B, D={D})")
    B = qv.shape[0]
    if qi.dim() != 2 or qi.shape[0] != B or qi.shape[1] < lex_dim:
        raise ValueError(f"qi {tuple(qi.shape)} must be (B={B}, >= "
                         f"{lex_dim})")
    if rows.dim() != 2 or rows.shape[0] != B:
        raise ValueError(f"rows {tuple(rows.shape)} must be (B={B}, K)")
    if qv.dtype != torch.float32 or qi.dtype != torch.int32 \
            or rows.dtype != torch.int64:
        raise TypeError("qv must be f32, qi int32 and rows int64")
    if values.dtype not in VALUE_DTYPES:
        raise TypeError(f"value plane dtype {values.dtype} not in "
                        f"{VALUE_DTYPES}")
    if indices.dtype not in INDEX_DTYPES:
        raise TypeError(f"index plane dtype {indices.dtype} not in "
                        f"{INDEX_DTYPES}")
    tensors = (qv, qi, rows, values, indices)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def rerank_gip(qv, qi, rows, values, indices, lex_dim: int) -> torch.Tensor:
    """Exact GIP scores ``(B, K)`` f32 of each query's candidate rows.

    ``qv`` (B, D) f32 (unthresholded, scale-folded), ``qi`` (B, >=lex)
    int32, ``rows`` (B, K) int64, ``values`` (N, D) int8/bf16/f16/f32,
    ``indices`` (N, lex_dim) int8/int16, all contiguous on one device.
    """
    _check(qv, qi, rows, values, indices, lex_dim)
    dev = values.device
    if dev.type == "cpu":
        return rerank_gip_plain(qv, qi, rows, values, indices, lex_dim)
    if dev.type != "cuda":
        raise ValueError(f"rerank_gip runs on cuda or cpu, not {dev}")
    B, K = rows.shape
    N, D = values.shape
    if B > _MAX_GRID or -(-K // _CAND_PER_BLOCK) > 2**31 - 1:
        raise ValueError(f"shape out of the kernel's range: B={B}, K={K}")
    out = torch.empty(B, K, dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return out
    err = _launcher()(
        qv.data_ptr(), qi.data_ptr(), rows.data_ptr(), values.data_ptr(),
        indices.data_ptr(), out.data_ptr(), N, B, K, D, lex_dim,
        qi.shape[1], _build.KIND[values.dtype], _build.KIND[indices.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rerank_gip kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("launches.rerank_gip")
    return out


def _launcher():
    fn = _build.load("rerank_gip").rerank_gip_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
