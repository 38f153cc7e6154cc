"""K4: the lexical head's pool, a CUDA kernel beside its plain version.

Replaces no Pallas kernel.  It does the work of the XLA-fused softmax,
weighting and max of the reference's lexical head
(``dhr_tpu/models/retrievers.py:165-171``), which the port ran as separate
eager passes over the ``(B, L-1, V)`` logits plane: the bias add, a cast
to an f32 copy, the softmax, the weighting and the max over positions.
For the MLM head's projection ``proj`` (before its bias), the bias and the
per-position weight ``w`` (term weight x mask, f32)::

    out[b, v] = max_t softmax(proj[b, t] + bias)[v] * w[b, t]

with the bias add rounded to the projection's dtype and the softmax and
weighting in f32, as the eager passes compute them.

Bound on the card: bytes — one read of the projection plane (of the
positions whose weight is not zero) and one write of ``(B, V)`` f32.  The
kernel (``csrc/lexical_pool.cu``) reads the plane twice and writes no f32
plane: a first pass keeps each position's max and sum of exponentials, a
second takes the weighted max over positions, a vocabulary strip at a
time.  A position of zero weight (a masked one) contributes ``w`` itself
(+0 or -0) to the max and is not read.  Its sums run in its own order:
within ``3e-5`` relative of the plain version.

Routing: a CPU tensor goes to :func:`lexical_pool_plain`; a CUDA tensor
launches the kernel or raises.  The kernel has no backward: the model
calls it only in inference, eval mode with autograd off
(``RetrieverEncoder._lexical_reps``).  The
recorder's counter ``launches.lexical_pool`` counts calls that launch it
(``utils.profiling``), one per encoded batch.
"""

from __future__ import annotations

import ctypes

import torch

from dhr_tpu_torch.ops import _build
from dhr_tpu_torch.utils import profiling

PROJ_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_MAX_GRID_Y = 65535


def weighted_softmax(logits: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 ``softmax(logits) * w`` over the last dim, in place outside
    autograd; ``w`` broadcasts against the logits."""
    probs = torch.softmax(logits, dim=-1, dtype=torch.float32)
    return probs * w if torch.is_grad_enabled() else probs.mul_(w)


def lexical_pool_plain(proj, bias, weight) -> torch.Tensor:
    """Plain PyTorch version: the bias add in the projection's dtype, the
    f32 softmax, the weighting and the max over positions, as passes."""
    logits = proj + bias.to(proj.dtype)
    return weighted_softmax(logits, weight[..., None]).amax(dim=-2)


def _check(proj, bias, weight):
    if proj.dim() != 3:
        raise ValueError(f"proj {tuple(proj.shape)} must be (B, T, V)")
    B, T, V = proj.shape
    if T == 0 or V == 0:
        raise ValueError(f"proj {tuple(proj.shape)}: no positions or "
                         "vocabulary to pool")
    if bias.shape != (V,):
        raise ValueError(f"bias {tuple(bias.shape)} must be (V={V},)")
    if weight.shape != (B, T):
        raise ValueError(f"weight {tuple(weight.shape)} must be "
                         f"(B={B}, T={T})")
    if proj.dtype not in PROJ_DTYPES:
        raise TypeError(f"proj dtype {proj.dtype} not in {PROJ_DTYPES}")
    if weight.dtype != torch.float32:
        raise TypeError("weight must be f32")
    if len({t.device for t in (proj, bias, weight)}) != 1:
        raise ValueError("all inputs must lie on one device")


def lexical_pool(proj, bias, weight) -> torch.Tensor:
    """``(B, V)`` f32: the max over positions of ``softmax(proj + bias) *
    weight``.

    ``proj`` (B, T, V) bf16 / f16 / f32 whose last dim is contiguous (any
    row pitch), ``bias`` (V,) (cast to ``proj``'s dtype, as the MLM head
    adds it), ``weight`` (B, T) f32, on one device.
    """
    _check(proj, bias, weight)
    dev = proj.device
    if dev.type == "cpu":
        return lexical_pool_plain(proj, bias, weight)
    if dev.type != "cuda":
        raise ValueError(f"lexical_pool runs on cuda or cpu, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (proj, bias, weight)):
        raise RuntimeError("lexical_pool's kernel has no backward: call it "
                           "with autograd off")
    B, T, V = proj.shape
    if proj.stride(2) != 1:
        raise ValueError("proj's last dim must be contiguous")
    if B > _MAX_GRID_Y or V >= 2**31 - 2048:
        raise ValueError(f"shape out of the kernel's range: B={B}, V={V}")
    bias = bias.to(proj.dtype).contiguous()
    weight = weight.contiguous()
    out = torch.empty(B, V, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    stats = torch.empty(2, B * T, dtype=torch.float32, device=dev)
    err = _launcher()(
        proj.data_ptr(), bias.data_ptr(), weight.data_ptr(),
        stats.data_ptr(), out.data_ptr(), B, T, V, proj.stride(0),
        proj.stride(1), _build.KIND[proj.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"lexical_pool kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("launches.lexical_pool")
    return out


def _launcher():
    fn = _build.load("lexical_pool").lexical_pool_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int,
                                                    ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
