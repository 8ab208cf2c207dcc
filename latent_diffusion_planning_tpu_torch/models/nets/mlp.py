"""MLP family: cond MLP, residual MLP trunk and the diffusion IDM head.

Counterpart of ``latent_diffusion_planning_tpu/models/nets/mlp.py``. The IDM
(``MLPDiffusion``) composes: Fourier time features → cond MLP → concat
[action, state, cond] → residual trunk → action. LayerNorm eps is 1e-6 (the
Flax default), not torch's 1e-5.

Options as the Flax modules take them:

- ``MLP``: ``kernel_init`` (xavier, kaiming, lecun), ``activate_final``,
  ``use_layer_norm``, ``dropout_rate`` and ``tanh_output``, each at the
  Flax position (Dense → dropout → LayerNorm → activation).
- ``MLPResNetBlock``: a Dense projection of the residual (Flax's
  ``Dense_2``) where the input is not ``features`` wide.
- ``dropout_rate`` in the trunk (before each block's LayerNorm) acts only
  under ``training=True`` with an explicit ``torch.Generator``; the agents,
  like the JAX agents, never pass ``training=True``, so a net built with a
  rate trains and samples exactly as one without, and kernel A takes it.
- ``compute_dtype`` ("bfloat16") in the trunk: fp32 parameters, products in
  bf16 (inputs, kernels and biases cast), LayerNorm in fp32, the output
  layer in fp32, as Flax's ``dtype=`` / ``param_dtype=float32`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from . import init
from .embeddings import FourierFeatures, mish

LN_EPS = 1e-6
KERNEL_INITS = {"xavier": "xavier", "kaiming": "kaiming_uniform",
                "lecun": "lecun"}


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


def compute_dtype_of(name) -> torch.dtype | None:
    """The product type a ``compute_dtype`` config value names: None for
    float32 (the nets' own fp32 path), torch.bfloat16 for bf16; anything
    else raises."""
    if name is None or isinstance(name, torch.dtype):
        dt = name
    else:
        dt = getattr(torch, str(name).removeprefix("jnp."), None)
    if dt in (None, torch.float32):
        return None
    if dt == torch.bfloat16:
        return dt
    raise ValueError(f"compute_dtype must be float32 or bfloat16, not "
                     f"{name!r}")


def dense(lin: nn.Linear, x: torch.Tensor,
          dt: torch.dtype | None) -> torch.Tensor:
    """``lin(x)``, or with ``dt`` its product in that type: input, kernel
    and bias cast, the parameters staying fp32 (Flax's ``dtype=``). As XLA
    computes it, the product is rounded to ``dt`` and the bias added in
    ``dt`` (a second rounding)."""
    if dt is None:
        return lin(x)
    y = F.linear(x.to(dt), lin.weight.to(dt))
    return y if lin.bias is None else y + lin.bias.to(dt)


def dropout(x: torch.Tensor, rate: float | None, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: with ``training`` each element is kept with
    probability 1 - rate (a uniform draw from ``generator`` below it) and
    scaled by 1 / (1 - rate); otherwise ``x`` as it is."""
    if not rate or not training:
        return x
    if generator is None:
        raise ValueError("dropout under training=True needs an explicit "
                         "torch.Generator")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class MLP(nn.Module):
    """Dense stack: after every layer but the last (and after the last with
    ``activate_final``) dropout, LayerNorm and the activation, each where
    asked for; ``tanh_output`` ends in tanh. Every Dense draws from
    ``kernel_init`` (xavier-uniform by default, as the JAX MLP)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 activation_name: str = "relu",
                 generator: torch.Generator | None = None, *,
                 kernel_init: str = "xavier", activate_final: bool = False,
                 use_layer_norm: bool = False,
                 dropout_rate: float | None = None,
                 tanh_output: bool = False):
        super().__init__()
        if kernel_init not in KERNEL_INITS:
            raise ValueError(f"unknown init {kernel_init!r}")
        dims = [in_dim, *hidden_dims]
        self.dense = nn.ModuleList(
            init.layer(nn.Linear, a, b, init=KERNEL_INITS[kernel_init],
                       generator=generator)
            for a, b in zip(dims[:-1], dims[1:]))
        self.act = activation(activation_name)
        self.activate_final = activate_final
        self.dropout_rate = dropout_rate
        self.tanh_output = tanh_output
        n_act = len(hidden_dims) - (0 if activate_final else 1)
        self.norms = nn.ModuleList(
            nn.LayerNorm(h, eps=LN_EPS) for h in hidden_dims[:n_act]
        ) if use_layer_norm else None

    @property
    def plain(self) -> bool:
        """Dense, activation, …, Dense: the cond MLP ``MLPDiffusion`` builds
        (dropout aside, which acts only in training)."""
        return (self.norms is None and not self.activate_final
                and not self.tanh_output)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        n = len(self.dense)
        for i, lin in enumerate(self.dense):
            x = lin(x)
            if i < n - 1 or self.activate_final:
                x = dropout(x, self.dropout_rate, training, generator)
                if self.norms is not None:
                    x = self.norms[i](x)
                x = self.act(x)
        return torch.tanh(x) if self.tanh_output else x


class MLPResNetBlock(nn.Module):
    """Pre-norm residual block: [dropout] → LN → Dense(4h) → act →
    Dense(h) + skip; the skip goes through a Dense when the input is not
    ``features`` wide."""

    def __init__(self, features: int, activation_name: str = "relu",
                 use_layer_norm: bool = True,
                 generator: torch.Generator | None = None, *,
                 in_features: int | None = None,
                 dropout_rate: float | None = None,
                 compute_dtype=None):
        super().__init__()
        cin = features if in_features is None else in_features
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.norm = (nn.LayerNorm(cin, eps=LN_EPS) if use_layer_norm
                     else nn.Identity())
        self.dense0 = init.layer(nn.Linear, cin, 4 * features,
                                 generator=generator)
        self.dense1 = init.layer(nn.Linear, 4 * features, features,
                                 generator=generator)
        self.proj = (init.layer(nn.Linear, cin, features, generator=generator)
                     if cin != features else None)
        self.act = activation(activation_name)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        residual = x
        x = dropout(x, self.dropout_rate, training, generator)
        if dt is not None and not isinstance(self.norm, nn.Identity):
            x = x.float()            # LayerNorm in fp32
        x = self.norm(x)
        x = dense(self.dense1, self.act(dense(self.dense0, x, dt)), dt)
        if self.proj is not None:
            residual = dense(self.proj, residual, dt)
        return residual + x


class MLPResNet(nn.Module):
    def __init__(self, in_dim: int, n_blocks: int, out_dim: int,
                 hidden_dim: int = 256, activation_name: str = "relu",
                 use_layer_norm: bool = True,
                 generator: torch.Generator | None = None, *,
                 dropout_rate: float | None = None, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.dense0 = init.layer(nn.Linear, in_dim, hidden_dim, init="xavier",
                                 generator=generator)
        self.blocks = nn.ModuleList(
            MLPResNetBlock(hidden_dim, activation_name, use_layer_norm,
                           generator, dropout_rate=dropout_rate,
                           compute_dtype=compute_dtype)
            for _ in range(n_blocks))
        self.dense1 = init.layer(nn.Linear, hidden_dim, out_dim,
                                 init="xavier", generator=generator)
        self.act = activation(activation_name)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = dense(self.dense0, x, self.compute_dtype)
        for blk in self.blocks:
            x = blk(x, training, generator)
        x = self.act(x)
        if self.compute_dtype is not None:
            x = x.float()            # the output layer in fp32
        return self.dense1(x)


class MLPDiffusion(nn.Module):
    """Diffusion MLP for the inverse dynamics model: ε(s, a_t, t)."""

    def __init__(self, s_dim: int, out_dim: int, time_dim: int = 64,
                 cond_hidden_dims: Sequence[int] = (128, 128),
                 cond_activation: str = "swish", n_blocks: int = 3,
                 hidden_dim: int = 256, use_layer_norm: bool = True,
                 dropout_rate: float | None = None,
                 learnable_time: bool = True,
                 generator: torch.Generator | None = None,
                 compute_dtype=None):
        """Weights as the Flax module initialises them, drawn from
        ``generator``; ``dropout_rate`` and ``compute_dtype`` reach the
        trunk, as in the Flax module."""
        super().__init__()
        self.s_dim, self.out_dim = s_dim, out_dim
        self.time_dim = time_dim
        self.cond_activation = cond_activation
        self.use_layer_norm = use_layer_norm
        self.learnable_time = learnable_time
        self.dropout_rate = dropout_rate
        self.time = FourierFeatures(time_dim, learnable_time,
                                    generator=generator)
        self.cond = MLP(time_dim, cond_hidden_dims, cond_activation,
                        generator=generator)
        self.trunk = MLPResNet(out_dim + s_dim + cond_hidden_dims[-1],
                               n_blocks, out_dim, hidden_dim,
                               use_layer_norm=use_layer_norm,
                               generator=generator, dropout_rate=dropout_rate,
                               compute_dtype=compute_dtype)

    def forward(self, s: torch.Tensor, a: torch.Tensor, t: torch.Tensor,
                training: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        t = torch.as_tensor(t, device=s.device).float().reshape(-1, 1)
        t = t.expand(s.shape[0], 1)
        cond = self.cond(self.time(t), training, generator)
        return self.trunk(torch.cat([a, s, cond], -1), training, generator)
