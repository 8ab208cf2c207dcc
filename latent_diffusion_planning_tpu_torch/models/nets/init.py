"""Flax's initializers for torch layers.

Flax's ``nn.Dense``, ``nn.Conv`` and ``nn.ConvTranspose`` default to
lecun-normal kernels and zero biases; the JAX nets ask for xavier-uniform
or, in the ResNet, kaiming-normal in places. Torch's layers default to
U(±1/√fan_in) for weights and biases alike, a spread √3 narrower, so every
port net builds its layers through ``layer`` here instead.

Fans are Flax's, from its kernel layouts: Dense (in, out); Conv (k…, in,
out), so fan_in = in·∏k; ConvTranspose (k…, in, out) likewise. Torch stores
a transposed conv's weight as (in, out, k…), where its own fan_in would be
out·∏k: ``fans`` reads each layout as Flax would.

Every draw comes from the ``generator`` handed in (the global torch RNG
where it is None); ``layer`` builds the module without torch's own draws.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils import skip_init

# the standard deviation of a unit normal truncated at ±2
TRUNC_STD = 0.87962566103423978


def fans(module: nn.Module) -> tuple[int, int]:
    """(fan_in, fan_out) of a Linear, Conv or ConvTranspose layer's kernel
    as Flax lays it out."""
    w = module.weight
    if isinstance(module, nn.Linear):
        return w.shape[1], w.shape[0]
    taps = math.prod(w.shape[2:])
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        cin, cout = w.shape[0], w.shape[1]
    else:
        cout, cin = w.shape[0], w.shape[1]
    return cin * taps, cout * taps


def trunc_normal_(w: torch.Tensor, std: float,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """A normal of standard deviation ``std`` truncated at ±2·``std``."""
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """``variance_scaling(1, "fan_in", "truncated_normal")``."""
    return trunc_normal_(w, math.sqrt(1.0 / fan_in) / TRUNC_STD, generator)


def kaiming_normal_(w: torch.Tensor, fan_in: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """``variance_scaling(2, "fan_in", "truncated_normal")``."""
    return trunc_normal_(w, math.sqrt(2.0 / fan_in) / TRUNC_STD, generator)


def xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """``variance_scaling(1, "fan_avg", "uniform")``: U(±√(6/(in+out)))."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(w, -bound, bound, generator=generator)


def kaiming_uniform_(w: torch.Tensor, fan_in: int,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """``variance_scaling(2, "fan_in", "uniform")``: U(±√(6/fan_in))."""
    bound = math.sqrt(6.0 / fan_in)
    return nn.init.uniform_(w, -bound, bound, generator=generator)


def xavier_normal_(w: torch.Tensor, fan_in: int, fan_out: int,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """``variance_scaling(1, "fan_avg", "truncated_normal")``."""
    return trunc_normal_(w, math.sqrt(2.0 / (fan_in + fan_out)) / TRUNC_STD,
                         generator)


def init_(module: nn.Module, kind: str = "lecun",
          generator: torch.Generator | None = None) -> nn.Module:
    """Draw ``module``'s weight as Flax's ``kind`` initializer would and
    zero its bias."""
    fan_in, fan_out = fans(module)
    with torch.no_grad():
        if kind == "lecun":
            lecun_normal_(module.weight, fan_in, generator)
        elif kind == "xavier":
            xavier_uniform_(module.weight, fan_in, fan_out, generator)
        elif kind == "kaiming_normal":
            kaiming_normal_(module.weight, fan_in, generator)
        elif kind == "kaiming_uniform":
            kaiming_uniform_(module.weight, fan_in, generator)
        elif kind == "xavier_normal":
            xavier_normal_(module.weight, fan_in, fan_out, generator)
        elif kind == "zeros":
            module.weight.zero_()
        else:
            raise ValueError(f"unknown init {kind!r}")
        if module.bias is not None:
            module.bias.zero_()
    return module


def layer(cls: type[nn.Module], *args, init: str = "lecun",
          generator: torch.Generator | None = None, **kwargs) -> nn.Module:
    """``cls(*args, **kwargs)`` initialised as Flax's ``init`` would, on the
    default device (under ``torch.device("meta")`` a net of shapes only,
    with nothing drawn)."""
    kwargs.setdefault("device", torch.get_default_device())
    return init_(skip_init(cls, *args, **kwargs), init, generator)
