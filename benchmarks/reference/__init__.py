"""Plain PyTorch references of what the cells compute, in f32 with TF32 off.

They import nothing of the program and nothing of JAX, and take nothing the
program has made: only the inputs the benchmark generated.
"""

import torch


def no_tf32() -> None:
    """f32 matmuls and convolutions in f32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
