"""K1: theta-pass partial GIP scores, a CUDA kernel beside its plain version.

Replaces the Pallas TPU kernel ``pallas_partial_gip``
(``dhr_tpu/ops/pallas_gip.py:115-207``, entered through
``partial_gip_scores_pallas`` at 210-220).  For query ``b`` and row ``n``::

    scores[b, n] = sum_i imp_vals[b, i] * values_T[d_i, n] * gate
    gate         = d_i >= lex_dim  or  indices_T[d_i, n] == imp_gates[b, i]

with ``d_i = imp_dims[b, i]``.  Index values compare widened to int32.
Accumulation is f32 in the order of the important dims; the output is f32,
or bf16 cast once from the f32 sums.

Bound on the card: bytes — each query streams its I non-zero important dim
rows of the dim-major value and index planes (``I * N * (v + i)`` bytes)
and writes ``N * out`` bytes of scores.  The kernel
(``csrc/partial_gip.cu``) reads those rows with 16-byte loads and orders
its grid so concurrent blocks share row tiles across queries (L2 reuse of
popular dims).

Routing: a CPU tensor goes to :func:`partial_gip_plain`; a CUDA tensor
launches the kernel or raises.  ``partial_gip.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from dhr_tpu_torch.ops import _build

VALUE_DTYPES = (torch.int8, torch.bfloat16, torch.float16, torch.float32)
INDEX_DTYPES = (torch.int8, torch.int16)
OUT_DTYPES = (torch.float32, torch.bfloat16)
_MAX_IMP = 4096          # (val, dim, gate) triples staged in 48 KB of smem
_ROWS_PER_BLOCK = 256 * 16
_MAX_GRID_Y = 65535


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
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def partial_gip(imp_vals, imp_dims, imp_gates, values_T, indices_T,
                lex_dim: int, out_dtype=torch.float32) -> torch.Tensor:
    """Partial GIP scores ``(B, N)`` from selected important dims.

    ``imp_vals`` (B, I) f32, ``imp_dims`` / ``imp_gates`` (B, I) int32,
    ``values_T`` (D, N) int8/bf16/f16/f32, ``indices_T`` (lex_dim, N)
    int8/int16, all contiguous on one device.
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
    if n_imp > _MAX_IMP or B > 2**31 - 1 \
            or -(-N // _ROWS_PER_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"shape out of the kernel's range: B={B}, "
                         f"I={n_imp}, N={N}")
    out = torch.empty(B, N, dtype=out_dtype, device=dev)
    if B == 0 or N == 0:
        return out
    if n_imp == 0:
        return out.zero_()
    err = _launcher()(
        imp_vals.data_ptr(), imp_dims.data_ptr(), imp_gates.data_ptr(),
        values_T.data_ptr(), indices_T.data_ptr(), out.data_ptr(),
        N, B, n_imp, D, lex_dim, _build.KIND[values_T.dtype],
        _build.KIND[indices_T.dtype], _build.KIND[out_dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"partial_gip kernel launch failed: CUDA error "
                           f"{err}")
    partial_gip.launches += 1
    return out


partial_gip.launches = 0


def _launcher():
    fn = _build.load("partial_gip").partial_gip_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
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
