"""K5: the MoE layer's combine, a CUDA kernel beside its plain version.

Replaces no Pallas kernel (the JAX package has no mixture of experts).  It
does the combine step of the decoder's routed experts
(``models/decoder.py`` ``routed_experts_grouped``): each token's ``k``
rows of the down projection's output, held in expert order, gathered back
by the inverse permutation ``slot`` and summed with the router's weights::

    out[n] = sum_j weights[n, j] * rows[slot[n, j]]

in f32 (each product rounded, then added), cast to ``rows``' dtype.  The
plain version, :func:`combine`, runs it as five eager passes over an
``(N, k, H)`` f32 copy: the gather, the cast, the weighting, the sum over
``k`` and the cast back.

Bound on the card: bytes — one read of the ``N * k`` rows and one write of
``(N, H)``.  The kernel (``csrc/moe_combine.cu``) reads each row once with
16-byte loads, all of a token's rows in flight before any arithmetic, and
keeps the sum in registers: no f32 copy.  Its sum runs in slot order,
which may differ from PyTorch's reduction: within an ulp of the output
dtype, where the sum does not cancel.

Routing: a CPU tensor goes to :func:`combine`; a CUDA tensor launches the
kernel or raises.  The kernel has no backward: the decoder calls it only
where autograd records nothing (``routed_experts_grouped``).  The
recorder's counter ``launches.moe_combine`` counts calls that launch it
(``utils.profiling``), one per MoE layer.
"""

from __future__ import annotations

import ctypes

import torch

from dhr_tpu_torch.ops import _build
from dhr_tpu_torch.utils import profiling

ROW_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
MAX_K = 16


def combine(rows: torch.Tensor, slot: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """``sum_j weights[:, j] * rows[slot[:, j]]`` in f32, cast to
    ``rows``' dtype: each token's ``k`` rows gathered back, no atomics."""
    picked = rows[slot.reshape(-1)].view(*slot.shape, rows.shape[-1])
    return (picked.float() * weights[..., None]).sum(dim=1).to(rows.dtype)


def _check(rows, slot, weights):
    if rows.dim() != 2:
        raise ValueError(f"rows {tuple(rows.shape)} must be (M, H)")
    if slot.dim() != 2:
        raise ValueError(f"slot {tuple(slot.shape)} must be (N, k)")
    if weights.shape != slot.shape:
        raise ValueError(f"weights {tuple(weights.shape)} must match slot "
                         f"{tuple(slot.shape)}")
    N, k = slot.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} slots a token: the kernel takes 1 to "
                         f"{MAX_K}")
    if N and rows.shape[0] == 0:
        raise ValueError("no rows for the slots to index")
    if rows.dtype not in ROW_DTYPES:
        raise TypeError(f"rows dtype {rows.dtype} not in {ROW_DTYPES}")
    if slot.dtype != torch.int64:
        raise TypeError(f"slot must be int64, not {slot.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be f32, not {weights.dtype}")
    if not all(t.is_contiguous() for t in (rows, slot, weights)):
        raise ValueError("rows, slot and weights must be contiguous")
    if len({t.device for t in (rows, slot, weights)}) != 1:
        raise ValueError("all inputs must lie on one device")


def moe_combine(rows, slot, weights) -> torch.Tensor:
    """``(N, H)`` in ``rows``' dtype: each token's ``k`` rows of ``rows``
    (M, H) bf16 / f16 / f32 at ``slot`` (N, k) int64, weighted by
    ``weights`` (N, k) f32 and summed in f32; all contiguous, on one
    device, ``1 <= k <= 16``, each slot id in ``[0, M)``."""
    _check(rows, slot, weights)
    dev = rows.device
    if dev.type == "cpu":
        return combine(rows, slot, weights)
    if dev.type != "cuda":
        raise ValueError(f"moe_combine runs on cuda or cpu, not {dev}")
    if torch.is_grad_enabled() and (rows.requires_grad
                                    or weights.requires_grad):
        raise RuntimeError("moe_combine's kernel has no backward: call it "
                           "with autograd off")
    (N, k), (M, H) = slot.shape, rows.shape
    out = torch.empty(N, H, dtype=rows.dtype, device=dev)
    if N == 0 or H == 0:
        return out
    err = _launcher()(
        rows.data_ptr(), slot.data_ptr(), weights.data_ptr(), out.data_ptr(),
        N, k, H, M, _build.KIND[rows.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"moe_combine kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("launches.moe_combine")
    return out


def _launcher():
    fn = _build.load("moe_combine").moe_combine_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
