"""Per-dimension symmetric int8 quantization of index value planes.

A frozen copy of ``scales_from_absmax`` and ``quantize_with_scales`` from
``dhr_tpu_torch/ops/quantize.py``: 1 byte a dim with one f32 scale per dim
(``dequant = values_i8 * scales``).
"""

from __future__ import annotations

import torch


def scales_from_absmax(absmax: torch.Tensor) -> torch.Tensor:
    """Per-dim scales from a per-dim absolute maximum (f32)."""
    absmax = absmax.float()
    return torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))


def quantize_with_scales(values: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """Round ``values / scales`` to int8 in [-127, 127] (half to even)."""
    return torch.clamp(
        torch.round(values.float() / scales), -127, 127).to(torch.int8)
