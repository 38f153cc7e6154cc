"""Device resolution: the port runs on the GPU unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA device; a CUDA request without a GPU raises.

    The CPU is used only when the caller names it (tests, ``--device cpu``):
    a search that silently ran on the CPU would report CPU numbers under a
    GPU entry point.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dhr_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
