"""K6: the core of multi-head latent attention, a CUDA kernel beside its
plain version.

Replaces no Pallas kernel (the JAX package has no decoder).  It does all
that the decoder's MLA (``models/decoder.py`` ``MLA.forward``) computes
between its projections' outputs and ``o_proj``: the rope of ``q_pe`` and
``k_pe``, the scores of ``[q_nope | q_pe]`` against ``[k_nope | k_pe]``
(``k_pe`` one head, shared by all), the scale, the causal and key mask,
the f32 softmax, ``P V`` and the merge of the heads.  Inputs, for ``B``
passages of ``L`` tokens and ``n`` heads:

- ``q``: ``q_proj``'s output ``(B, L, n (d_nope + d_rope))``;
- ``kv``: ``kv_b_proj``'s output ``(B, L, n (d_nope + d_v))``;
- ``k_pe``: the last ``d_rope`` columns of ``kv_a_proj_with_mqa``'s
  output, a strided view ``(B, L, d_rope)`` read in place;
- ``cos``, ``sin``: :func:`~dhr_tpu_torch.models.decoder.rotary`'s
  ``(L, d_rope)`` f32, whose rows repeat their first half (the kernel
  reads that half alone); ``mask``: the ``(B, L)`` attention mask of any
  real dtype (key ``j`` is visible to query ``i`` iff ``j <= i`` and
  ``mask[b, j] > 0``; the kernel reads ``mask > 0``, one byte a key).

Output ``(B, L, n d_v)`` in ``q``'s dtype, laid out for ``o_proj``.  The
plain version, :func:`mla_attention_plain`, is the eager chain the
decoder ran before the kernel, bias and all (~30 passes a layer over
per-head copies, the ``(B, n, L, L)`` scores rounded to the compute dtype
before the f32 softmax).

Bound on the card: bytes, one read of ``q``, ``kv`` and ``k_pe`` and one
write of the output.  The kernel (``csrc/mla_attention.cu``) keeps the
scores and probabilities in registers; they are f32 (the plain version
rounds the scores to the compute dtype first), ``P`` is rounded to bf16
before ``P V`` as the plain version's cast does, and a query with no
visible key gets zeros.  Its rope is the plain version's bit for bit,
applied to each interleaved pair in place (the same permutation of
``q_pe`` and ``k_pe`` leaves each product unchanged).

Routing: the wrapper :func:`mla_attention` refuses what the kernel does
not take on any device, sends a CPU tensor to the plain version, and
launches the kernel for a CUDA one.  The kernel has no backward, and the
decoder calls the wrapper only for CUDA tensors where autograd records
nothing.  The recorder's counter ``launches.mla_attention`` counts its
launches (``utils.profiling``), one per MLA layer.
"""

from __future__ import annotations

import ctypes

import torch

from dhr_tpu_torch.ops import _build
from dhr_tpu_torch.utils import profiling

# (d_nope, d_rope, d_v) of the kernel's template instances: DeepSeek-V2
# (-Lite)'s and DecoderConfig.tiny's
HEAD_DIMS = ((128, 64, 128), (8, 8, 8))
MAX_BATCH = 65535


def apply_rope(t: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rope on ``t`` (..., L, d): de-interleave, then rotate
    (in f32, returning ``t``'s dtype)."""
    d = t.shape[-1]
    x = t.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return (x * cos + rot * sin).to(t.dtype)


def causal_bias(attention_mask: torch.Tensor, dtype) -> torch.Tensor:
    """``(B, 1, L, L)``: 0 where query ``i`` may see key ``j`` (``j <= i``
    and ``j`` real), -1e9 in ``dtype`` elsewhere."""
    L = attention_mask.shape[-1]
    pos = torch.arange(L, device=attention_mask.device)
    allowed = (pos[None, :] <= pos[:, None])[None, None] \
        & (attention_mask[:, None, None, :] > 0)
    return torch.where(allowed, 0.0, -1e9).to(dtype)


def mla_attention_plain(q, kv, k_pe, cos, sin, mask, heads: int,
                        d_nope: int, scale: float) -> torch.Tensor:
    """The eager MLA core: rope, the per-head ``cat``s, scores in ``q``'s
    dtype plus :func:`causal_bias`, the f32 softmax cast back, ``P V``,
    the heads merged."""
    B, L, _ = q.shape
    n, d_rope = heads, k_pe.shape[-1]
    q = q.view(B, L, n, -1).transpose(1, 2)
    q_nope, q_pe = q.split([d_nope, d_rope], dim=-1)
    kv = kv.view(B, L, n, -1).transpose(1, 2)
    k_nope, v = kv.split([d_nope, kv.shape[-1] - d_nope], dim=-1)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, None], cos, sin)          # (B, 1, L, d)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, n, L, d_rope)], dim=-1)
    bias = causal_bias(mask, q.dtype)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale + bias
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(q.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(B, L, -1)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _check(q, kv, k_pe, cos, sin, mask, heads, d_nope):
    """The kernel's ``(d_nope, d_rope, d_v)`` and ``k_pe``'s row pitch, or
    raise naming what it does not take."""
    if q.dim() != 3 or kv.dim() != 3 or k_pe.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)}, kv {tuple(kv.shape)} and "
                         f"k_pe {tuple(k_pe.shape)} must be (B, L, .)")
    B, L = q.shape[:2]
    if kv.shape[:2] != (B, L) or k_pe.shape[:2] != (B, L):
        raise ValueError(f"kv {tuple(kv.shape)} and k_pe "
                         f"{tuple(k_pe.shape)} must match q's (B, L) = "
                         f"{(B, L)}")
    d_rope = k_pe.shape[-1]
    if heads < 1 or q.shape[-1] % heads or kv.shape[-1] % heads:
        raise ValueError(f"{heads} heads do not divide q's "
                         f"{q.shape[-1]} or kv's {kv.shape[-1]} columns")
    d_v = kv.shape[-1] // heads - d_nope
    dims = (d_nope, d_rope, d_v)
    if q.shape[-1] // heads != d_nope + d_rope or dims not in HEAD_DIMS:
        raise ValueError(f"head dims (d_nope, d_rope, d_v) = {dims} with "
                         f"q's {q.shape[-1] // heads} a head: the kernel "
                         f"takes {HEAD_DIMS}")
    for name, t in (("q", q), ("kv", kv), ("k_pe", k_pe)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes "
                            "bfloat16 (on the card the decoder computes "
                            "in bfloat16)")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (L, d_rope):
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} must be "
                             f"float32 ({L}, {d_rope})")
    if mask.dtype.is_complex or tuple(mask.shape) != (B, L):
        raise ValueError(f"mask {mask.dtype} {tuple(mask.shape)} must be "
                         f"({B}, {L}) of a real dtype")
    if not all(t.is_contiguous() for t in (q, kv, cos, sin)):
        raise ValueError("q, kv, cos and sin must be contiguous")
    pitch = k_pe.stride(1)
    if (k_pe.stride(2) != 1 or k_pe.stride(0) != L * pitch
            or pitch < d_rope or pitch % 8):
        raise ValueError(f"k_pe strides {k_pe.stride()}: its rows must be "
                         "one token apart at a row pitch that is a "
                         f"multiple of 8 elements and >= {d_rope}")
    if not all(_aligned(t) for t in (q, kv, k_pe, cos, sin)):
        raise ValueError("q, kv, k_pe, cos and sin must start 16-byte "
                         "aligned")
    if len({t.device for t in (q, kv, k_pe, cos, sin, mask)}) != 1:
        raise ValueError("all inputs must lie on one device")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, kv, k_pe)):
        raise RuntimeError("mla_attention's kernel has no backward: call it "
                           "with autograd off")
    if B > MAX_BATCH:
        raise ValueError(f"{B} passages a call: the kernel takes at most "
                         f"{MAX_BATCH}")
    return dims, pitch


def mla_attention(q, kv, k_pe, cos, sin, mask, heads: int, d_nope: int,
                  scale: float) -> torch.Tensor:
    """``(B, L, heads d_v)`` bf16: the MLA core of ``q``, ``kv`` and
    ``k_pe`` (bf16, see the module docstring) under ``mask``, ``scale``
    the scores' factor; K6 on the card, :func:`mla_attention_plain` on the
    CPU.  Raises on head dims other than :data:`HEAD_DIMS`, another dtype
    or layout, a device mix, or autograd on."""
    (_, d_rope, d_v), pitch = _check(q, kv, k_pe, cos, sin, mask, heads,
                                     d_nope)
    dev = q.device
    if dev.type == "cpu":
        return mla_attention_plain(q, kv, k_pe, cos, sin, mask, heads,
                                   d_nope, scale)
    if dev.type != "cuda":
        raise ValueError(f"mla_attention runs on cuda or cpu, not {dev}")
    B, L = q.shape[:2]
    out = torch.empty(B, L, heads * d_v, dtype=q.dtype, device=dev)
    if B == 0 or L == 0:
        return out
    real = (mask > 0).contiguous()      # one byte a key, as the kernel reads
    err = _launcher()(
        q.data_ptr(), kv.data_ptr(), k_pe.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), real.data_ptr(), out.data_ptr(), B, L, heads, pitch,
        d_nope, d_rope, d_v, float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"mla_attention kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("launches.mla_attention")
    return out


def _launcher():
    fn = _build.load("mla_attention").mla_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
