"""K7: Kimi Delta Attention's chunked recurrence, a CUDA kernel beside its
plain version.

Replaces no Pallas kernel (the JAX package has no decoder).  It does all
that :func:`~dhr_tpu_torch.models.decoder.kda_scan` computes, the decoder's
KDA recurrence from the short convolutions' outputs to ``o``: the per-head
L2 norms of ``q`` and ``k`` and ``q``'s ``d ** -0.5``, each chunk of 64
positions' local products and unit-triangular solve, and the state passed
from chunk to chunk.  Inputs, for ``B`` passages of ``L`` positions, ``h``
heads of ``d``:

- ``q``, ``k``, ``v``: ``(B, L, h, d)`` bf16 or f32 (one dtype), read in
  place through their strides (the convolution's output is channel-major);
- ``g``: the log-decays ``(B, L, h, d)`` f32 (<= 0); ``beta``: ``(B, L,
  h)`` f32.

Output ``(B, L, h, d)`` in ``v``'s dtype, contiguous.  The plain version,
``decoder.kda_scan``, is its twin on the CPU and where autograd records:
f32 torch ops, the chunk-local part in blocks of chunks, then three
batched products a chunk.

Bound on the card: the f32 FFMA rate (~4.7M FMA a chunk and head at d =
128; the bytes take a fifth of that).  The kernel (``csrc/kda_scan.cu``)
runs as two launches: one block a (chunk, passage-head) for the
chunk-local part, whose f32 operands go to a scratch this wrapper
allocates (~160 KB a chunk and head), then one a (passage-head, 64 state
columns) for the state.  Every product, the solve and the state are f32
on the CUDA cores, and every exponent is a sum of the log-decays it spans,
as in the plain version; the sums run in other orders, so the two agree
to f32 round-off.

Routing: the wrapper :func:`fused_kda_scan` refuses what the kernel does
not take on any device, sends a CPU tensor to the plain version, and
launches the kernel for a CUDA one.  The kernel has no backward, and the
decoder calls the wrapper only for CUDA tensors where autograd records
nothing.  The recorder's counter ``launches.kda_scan`` counts its calls
(``utils.profiling``), one per KDA layer.
"""

from __future__ import annotations

import ctypes

import torch

from dhr_tpu_torch.ops import _build
from dhr_tpu_torch.utils import profiling

HEAD_DIMS = (128, 8)   # Kimi Linear's and DecoderConfig.tiny_kimi_linear's
DTYPES = (torch.bfloat16, torch.float32)
MAX_SEQUENCES = 65535  # B * h, the second grid dim


def _check(q, k, v, g, beta):
    """Raise naming what the kernel does not take."""
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, L, h, d)")
    for name, t in (("k", k), ("v", v), ("g", g)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match q's "
                             f"{tuple(q.shape)}")
    if beta.shape != q.shape[:3]:
        raise ValueError(f"beta {tuple(beta.shape)} must be q's (B, L, h) = "
                         f"{tuple(q.shape[:3])}")
    B, _, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                        f"the kernel takes one of {DTYPES} for all three")
    for name, t in (("g", g), ("beta", beta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes "
                            "float32")
    if len({t.device for t in (q, k, v, g, beta)}) != 1:
        raise ValueError("all inputs must lie on one device")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, g, beta)):
        raise RuntimeError("the KDA scan's kernel has no backward: call it "
                           "with autograd off")
    if B * h > MAX_SEQUENCES:
        raise ValueError(f"{B} passages x {h} heads: the kernel takes at "
                         f"most {MAX_SEQUENCES} sequences a call")


def fused_kda_scan(q, k, v, g, beta) -> torch.Tensor:
    """``o`` ``(B, L, h, d)`` in ``v``'s dtype: KDA's recurrence (see the
    module docstring), K7 on the card, the plain ``decoder.kda_scan`` on
    the CPU.  Raises on a head dim other than :data:`HEAD_DIMS`, another
    dtype, mismatched shapes, a device mix, or autograd on."""
    _check(q, k, v, g, beta)
    dev = q.device
    if dev.type == "cpu":
        # the decoder imports this module, so its plain scan is taken here
        from dhr_tpu_torch.models.decoder import kda_scan
        return kda_scan(q, k, v, g, beta)
    if dev.type != "cuda":
        raise ValueError(f"fused_kda_scan runs on cuda or cpu, not {dev}")
    B, L, h, d = q.shape
    out = torch.empty(B, L, h, d, dtype=v.dtype, device=dev)
    if B == 0 or L == 0 or h == 0:
        return out
    lib = _build.load("kda_scan")
    work = torch.empty(B * h * _work_floats(lib)(d, L), dtype=torch.float32,
                       device=dev)
    strides = (ctypes.c_longlong * 19)(
        *q.stride(), *k.stride(), *v.stride(), *g.stride(), *beta.stride())
    err = _launcher(lib)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        beta.data_ptr(), work.data_ptr(), out.data_ptr(), strides, B, L, h,
        d, _build.KIND[v.dtype], torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"kda_scan kernel launch failed: CUDA error {err}")
    profiling.count("launches.kda_scan")
    return out


def _work_floats(lib):
    fn = lib.kda_scan_work_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_longlong]
        fn.restype = ctypes.c_longlong
    return fn


def _launcher(lib):
    fn = lib.kda_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.POINTER(ctypes.c_longlong),
                          ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
