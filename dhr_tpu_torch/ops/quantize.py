"""Per-dimension symmetric int8 quantization of index value planes.

Port of ``dhr_tpu/ops/quantize.py``: 1 byte/dim values with one f32 scale
per dim; the scale folds into the query so the corpus stays int8 on the
device (``dequant = values_i8 * scales``).
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_per_dim_np(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side ``(N, d)`` float -> (int8 ``(N, d)``, f32 scales ``(d,)``)."""
    v32 = values.astype(np.float32)
    absmax = np.max(np.abs(v32), axis=0)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(v32 / scales), -127, 127).astype(np.int8)
    return q, scales


def scales_from_absmax(absmax: torch.Tensor) -> torch.Tensor:
    """Per-dim scales from a per-dim absolute maximum (f32)."""
    absmax = absmax.float()
    return torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))


def quantize_with_scales(values: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """Round ``values / scales`` to int8 in [-127, 127] (half to even)."""
    return torch.clamp(
        torch.round(values.float() / scales), -127, 127).to(torch.int8)


def quantize_per_dim(values: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side twin of :func:`quantize_per_dim_np`."""
    scales = scales_from_absmax(values.float().abs().amax(dim=0))
    return quantize_with_scales(values, scales), scales
