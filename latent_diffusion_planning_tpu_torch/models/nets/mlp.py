"""MLP family: cond MLP, residual MLP trunk and the diffusion IDM head.

Counterpart of ``latent_diffusion_planning_tpu/models/nets/mlp.py``. The IDM
(``MLPDiffusion``) composes: Fourier time features → cond MLP → concat
[action, state, cond] → residual trunk → action. LayerNorm eps is 1e-6 (the
Flax default), not torch's 1e-5. Dropout is not ported: inference never
uses it, and the fused sampler refuses a net that has it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from . import init
from .embeddings import FourierFeatures, mish

LN_EPS = 1e-6


def activation(name: str):
    if name == "relu":
        return F.relu
    if name == "mish":
        return mish
    if name == "gelu":
        # flax.linen.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "swish":
        return F.silu
    raise ValueError(f"unknown activation {name!r}")


class MLP(nn.Module):
    """Dense stack with an activation between layers, none after the last
    (the JAX MLP's LayerNorm, dropout and final-activation options are not
    ported: the IDM's cond MLP uses none of them). Every Dense draws
    xavier-uniform, the JAX MLP's default ``kernel_init``."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 activation_name: str = "relu",
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [in_dim, *hidden_dims]
        self.dense = nn.ModuleList(
            init.layer(nn.Linear, a, b, init="xavier", generator=generator)
            for a, b in zip(dims[:-1], dims[1:]))
        self.act = activation(activation_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense in self.dense[:-1]:
            x = self.act(dense(x))
        return self.dense[-1](x)


class MLPResNetBlock(nn.Module):
    """Pre-norm residual block: LN → Dense(4h) → act → Dense(h) + skip."""

    def __init__(self, features: int, activation_name: str = "relu",
                 use_layer_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm = (nn.LayerNorm(features, eps=LN_EPS) if use_layer_norm
                     else nn.Identity())
        self.dense0 = init.layer(nn.Linear, features, 4 * features,
                                 generator=generator)
        self.dense1 = init.layer(nn.Linear, 4 * features, features,
                                 generator=generator)
        self.act = activation(activation_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.dense1(self.act(self.dense0(self.norm(x))))


class MLPResNet(nn.Module):
    def __init__(self, in_dim: int, n_blocks: int, out_dim: int,
                 hidden_dim: int = 256, activation_name: str = "relu",
                 use_layer_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense0 = init.layer(nn.Linear, in_dim, hidden_dim, init="xavier",
                                 generator=generator)
        self.blocks = nn.ModuleList(
            MLPResNetBlock(hidden_dim, activation_name, use_layer_norm,
                           generator)
            for _ in range(n_blocks))
        self.dense1 = init.layer(nn.Linear, hidden_dim, out_dim,
                                 init="xavier", generator=generator)
        self.act = activation(activation_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense0(x)
        for blk in self.blocks:
            x = blk(x)
        return self.dense1(self.act(x))


class MLPDiffusion(nn.Module):
    """Diffusion MLP for the inverse dynamics model: ε(s, a_t, t)."""

    def __init__(self, s_dim: int, out_dim: int, time_dim: int = 64,
                 cond_hidden_dims: Sequence[int] = (128, 128),
                 cond_activation: str = "swish", n_blocks: int = 3,
                 hidden_dim: int = 256, use_layer_norm: bool = True,
                 dropout_rate: float | None = None,
                 learnable_time: bool = True,
                 generator: torch.Generator | None = None):
        """Weights as the Flax module initialises them, drawn from
        ``generator``."""
        super().__init__()
        if dropout_rate:
            raise NotImplementedError("dropout is not ported (inference only)")
        self.s_dim, self.out_dim = s_dim, out_dim
        self.time_dim = time_dim
        self.cond_activation = cond_activation
        self.use_layer_norm = use_layer_norm
        self.learnable_time = learnable_time
        self.time = FourierFeatures(time_dim, learnable_time,
                                    generator=generator)
        self.cond = MLP(time_dim, cond_hidden_dims, cond_activation,
                        generator=generator)
        self.trunk = MLPResNet(out_dim + s_dim + cond_hidden_dims[-1],
                               n_blocks, out_dim, hidden_dim,
                               use_layer_norm=use_layer_norm,
                               generator=generator)

    def forward(self, s: torch.Tensor, a: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, device=s.device).float().reshape(-1, 1)
        t = t.expand(s.shape[0], 1)
        cond = self.cond(self.time(t))
        return self.trunk(torch.cat([a, s, cond], -1))
