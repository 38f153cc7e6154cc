"""Inputs of the MLA core and its f64 evaluation, shared by
``tests/test_torch_mla_attention.py`` and ``chip_smoke.py``'s K6 phase.

``mla_inputs`` builds what the decoder's ``MLA.forward`` hands the core
(``ops/mla_attention.py``); ``f64_core`` evaluates the same function in
f64 from those values.  Neither imports JAX.
"""

from __future__ import annotations

import torch

from dhr_tpu_torch.models import decoder as dec
from dhr_tpu_torch.ops.mla_attention import apply_rope, causal_bias


def mla_inputs(lengths, heads, dims, seed=0, rank=16, dtype=torch.bfloat16,
               device="cpu"):
    """``q``, ``kv``, ``k_pe`` (a view of the last ``d_rope`` columns of a
    ``(B, L, rank + d_rope)`` plane, as the layer splits it), YaRN's
    ``cos`` / ``sin`` of DeepSeek-V2-Lite at ``d_rope`` and the
    right-padded int64 mask of the rows' ``lengths`` (``L`` their
    largest); N(0, 1) values drawn in f32 from ``seed``, then cast to
    ``dtype``."""
    dn, dr, dv = dims
    B, L = len(lengths), int(max(lengths))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randn(B, L, heads * (dn + dr), generator=g, device=device)
    kv = torch.randn(B, L, heads * (dn + dv), generator=g, device=device)
    a = torch.randn(B, L, rank + dr, generator=g, device=device)
    cos, sin = dec.rotary(dec.DecoderConfig.deepseek_v2_lite(
        qk_rope_head_dim=dr), L, device)
    k_pe = a.to(dtype).split([rank, dr], dim=-1)[1]
    lens = torch.as_tensor([int(n) for n in lengths], device=device)
    mask = (torch.arange(L, device=device)[None] < lens[:, None]).long()
    return q.to(dtype), kv.to(dtype), k_pe, cos, sin, mask


def f64_core(q, kv, k_pe, cos, sin, mask, heads, dims, scale):
    """The MLA core in f64 from the inputs' values, the rope rounded to
    the inputs' dtype as both versions round it; a query with no visible
    key gives zeros."""
    dn, dr, dv = dims
    B, L, _ = q.shape
    qh = q.view(B, L, heads, dn + dr).transpose(1, 2)
    kh = kv.view(B, L, heads, dn + dv).transpose(1, 2)
    q_pe = apply_rope(qh[..., dn:], cos, sin).double()      # (B, n, L, dr)
    k_r = apply_rope(k_pe[:, None], cos, sin).double()      # (B, 1, L, dr)
    s = (qh[..., :dn].double() @ kh[..., :dn].double().transpose(-1, -2)
         + q_pe @ k_r.transpose(-1, -2)) * scale
    s = s.masked_fill(causal_bias(mask, torch.float32) != 0, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return (p @ kh[..., dn:].double()).transpose(1, 2).reshape(
        B, L, heads * dv)
