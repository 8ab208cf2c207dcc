"""Time-step embeddings for the diffusion networks.

Counterpart of ``latent_diffusion_planning_tpu/models/nets/embeddings.py``.
Note the two orders: the sinusoidal embedding is ``[sin, cos]``, the Fourier
features are ``[cos, sin]``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x·tanh(softplus(x))``; on a bf16 tensor op by op, each rounded to
    bf16, with softplus as ``jnp.logaddexp(x, 0)`` spells it (max(x, 0) +
    log1p(exp(-|x|))): what XLA computes for the JAX package's bf16 nets."""
    if x.dtype == torch.bfloat16:
        sp = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
        return x * torch.tanh(sp)
    return x * torch.tanh(F.softplus(x))


def sinusoidal_freqs(dim: int, device=None) -> torch.Tensor:
    half = dim // 2
    return torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / (half - 1))


class SinusoidalPosEmb(nn.Module):
    """``[sin(t·f), cos(t·f)]`` with f = exp(-ln(1e4)·i/(half-1))."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        ang = t.float()[..., None] * sinusoidal_freqs(self.dim, t.device)
        return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


class FourierFeatures(nn.Module):
    """``[cos(2π x Wᵀ), sin(2π x Wᵀ)]``; W is (output_size/2, in_features)
    when learnable, else the sinusoidal frequencies scale x directly."""

    def __init__(self, output_size: int = 64, learnable: bool = True,
                 in_features: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.output_size = output_size
        self.learnable = learnable
        if learnable:
            self.kernel = nn.Parameter(torch.randn(
                output_size // 2, in_features, generator=generator) * 0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.learnable:
            f = 2.0 * math.pi * x @ self.kernel.t()
        else:
            f = x * sinusoidal_freqs(self.output_size, x.device)
        return torch.cat([torch.cos(f), torch.sin(f)], -1)
