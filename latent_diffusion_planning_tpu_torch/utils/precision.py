"""Float32 math on the card for the nets trained and run in full fp32.

PyTorch lets cuDNN's convolutions use TF32 by default (a 10-bit mantissa).
The VAE and the DP agent's ResNet encoder feed their features through a
min/max normalization or straight into the action U-Net's condition, so
they encode, decode and train with TF32 off: the CPU's parity bars against
the JAX package then carry to the card.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_math():
    """cuDNN convolutions and cuBLAS products in full fp32 (TF32 off)
    inside the block; the previous settings after it."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
