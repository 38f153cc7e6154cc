"""K8: Mamba-2's chunked SSD scan (Nemotron-H's state-space mixer), a CUDA
kernel beside its plain version.

Replaces no Pallas kernel (the JAX package has no decoder).  It does all
that :func:`~dhr_tpu_torch.models.decoder.ssd_scan` computes, the
recurrence from the convolution's outputs to ``y``: within each chunk
``(C B^T o exp(seg)) (dt x)``, the entering state's ``exp(a over [0, i])
C_i S``, each chunk's own state ``B^T (exp(a over (j, end]) dt x)`` passed
on decayed by the chunk's total, and the skip ``D x``.  Inputs, for ``Bt``
passages of ``L`` positions, ``h`` heads of ``P`` in ``g`` groups of state
``N``:

- ``x`` ``(Bt, L, h, P)``, ``B`` and ``C`` ``(Bt, L, g, N)``: bf16 or f32
  (one dtype), read in place through their strides (the convolution's
  output is channel-major), B and C by group, never broadcast to the heads;
- ``dt`` ``(Bt, L, h)`` f32 (>= 0); ``A`` (< 0) and ``D`` ``(h,)`` f32.

Output ``(Bt, L, h, P)`` in ``x``'s dtype, contiguous.  The plain version,
``decoder.ssd_scan``, is its twin on the CPU and where autograd records:
f32 torch ops over masked ``(c x c)`` decay matrices.

Bound on the card: the f32 FFMA rate (~27M FMA a chunk of 128 and group at
Nemotron-3-Nano's widths; the inputs' and output's bytes take an eighth of
that time, the f32 states passed between chunks about a third).  The kernel
(``csrc/ssd_scan.cu``) runs as three launches: each chunk's own state, one
block a (chunk, passage-group), into a scratch this wrapper allocates (the
states of every chunk but the last, ``N x P`` f32 a head, ~250 MB at 8 x
2,048); the states passed chunk to chunk, in place; then ``y``, one block a
(chunk, passage-group), ``C B^T`` computed once for the group's heads
and kept in shared memory.
Every product and sum is f32 on the CUDA cores, and every decay is the exp
of a sum of the ``dt A`` it spans, or a product of such factors, as in the
plain version; the sums run in other orders, so the two agree to f32
round-off.

Routing: the wrapper :func:`fused_ssd_scan` refuses what the kernel does
not take on any device, sends a CPU tensor to the plain version, and
launches the kernel for a CUDA one.  The kernel has no backward, and the
decoder calls the wrapper only for CUDA tensors where autograd records
nothing.  The recorder's counter ``launches.ssd_scan`` counts its calls
(``utils.profiling``), one per Mamba-2 mixer.
"""

from __future__ import annotations

import ctypes

import torch

from dhr_tpu_torch.ops import _build
from dhr_tpu_torch.utils import profiling

# (head dim, state, chunk, heads a group): NVIDIA-Nemotron-3-Nano-30B-A3B's
# and DecoderConfig.tiny_nemotron_h's
SHAPES = ((64, 128, 128, 8), (8, 16, 16, 2))
DTYPES = (torch.bfloat16, torch.float32)


def _check(x, dt, A, B, C, D, chunk):
    """Raise naming what the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} must be (Bt, L, h, P)")
    Bt, L, h, P = x.shape
    if B.dim() != 4 or B.shape[:2] != x.shape[:2]:
        raise ValueError(f"B {tuple(B.shape)} must be (Bt, L, g, N) with "
                         f"x's (Bt, L) = {tuple(x.shape[:2])}")
    if C.shape != B.shape:
        raise ValueError(f"C {tuple(C.shape)} must match B's "
                         f"{tuple(B.shape)}")
    if dt.shape != x.shape[:3]:
        raise ValueError(f"dt {tuple(dt.shape)} must be x's (Bt, L, h) = "
                         f"{tuple(x.shape[:3])}")
    for name, t in (("A", A), ("D", D)):
        if t.shape != (h,):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({h},)")
    g, N = B.shape[2:]
    if g == 0 or h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    if (P, N, chunk, h // g) not in SHAPES:
        raise ValueError(f"(head dim, state, chunk, heads a group) = "
                         f"{(P, N, chunk, h // g)}: the kernel takes "
                         f"{SHAPES}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C dtypes {x.dtype}, {B.dtype}, {C.dtype}: "
                        f"the kernel takes one of {DTYPES} for all three")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes "
                            "float32")
    if len({t.device for t in (x, dt, A, B, C, D)}) != 1:
        raise ValueError("all inputs must lie on one device")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C, D)):
        raise RuntimeError("the SSD scan's kernel has no backward: call it "
                           "with autograd off")


def fused_ssd_scan(x, dt, A, B, C, D, chunk: int = 128) -> torch.Tensor:
    """``y`` ``(Bt, L, h, P)`` in ``x``'s dtype: Mamba-2's SSD recurrence
    (see the module docstring), K8 on the card, the plain
    ``decoder.ssd_scan`` on the CPU.  Raises on a shape other than
    :data:`SHAPES`, another dtype, mismatched shapes, a device mix, or
    autograd on."""
    _check(x, dt, A, B, C, D, chunk)
    dev = x.device
    if dev.type == "cpu":
        # the decoder imports this module, so its plain scan is taken here
        from dhr_tpu_torch.models.decoder import ssd_scan
        return ssd_scan(x, dt, A, B, C, D, chunk)
    if dev.type != "cuda":
        raise ValueError(f"fused_ssd_scan runs on cuda or cpu, not {dev}")
    Bt, L, h, P = x.shape
    g, N = B.shape[2:]
    y = torch.empty(Bt, L, h, P, dtype=x.dtype, device=dev)
    if Bt == 0 or L == 0:
        return y
    lib = _build.load("ssd_scan")
    work = torch.empty(Bt * h * _work_floats(lib)(P, N, chunk, h // g, L),
                       dtype=torch.float32, device=dev)
    A, D = A.contiguous(), D.contiguous()
    strides = (ctypes.c_longlong * 15)(
        *x.stride(), *B.stride(), *C.stride(), *dt.stride())
    err = _launcher(lib)(
        x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
        A.data_ptr(), D.data_ptr(), work.data_ptr(), y.data_ptr(), strides,
        Bt, L, h, g, P, N, chunk, _build.KIND[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    profiling.count("launches.ssd_scan")
    return y


def _work_floats(lib):
    fn = lib.ssd_scan_work_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong]
        fn.restype = ctypes.c_longlong
    return fn


def _launcher(lib):
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.POINTER(ctypes.c_longlong),
                          ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
