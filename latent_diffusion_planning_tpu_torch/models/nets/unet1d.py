"""1-D conditional U-Net, the denoiser of plans and action chunks.

Counterpart of ``latent_diffusion_planning_tpu/models/nets/unet1d.py``. The
public layout is the JAX package's (B, T, C); inside, the net runs in
torch's (B, C, T). With ``downsample=False`` (LDP-hier's planner and chunk
IDM) there is no strided conv and no transposed conv: every level runs at
the full length, which may then be any length. Two Flax semantics of the
downsampling net are reproduced exactly:

- the stride-2 k=3 downsample pads (0, 1) (Flax ``SAME``), not (1, 1):
  ``y[t'] = Σ_j x[2t'+j] w[j]``;
- the k=4 s=2 ConvTranspose maps ``x[t] w[j] → y[2t+2-j]``. Torch's
  ``conv_transpose1d`` maps ``x[t] w[j] → y[2t+j-p]``, so the bridge stores
  the taps flipped and the layer uses padding 1.

GroupNorm eps is 1e-6 (Flax), and FiLM is ``scale·h + bias`` with
``[scale, bias] = Dense(mish(cond))``.

``compute_dtype="bfloat16"`` computes as the Flax module does with it: fp32
parameters; every conv and Dense in bf16 (input, kernel and bias cast,
result bf16), GroupNorm and the Mish after it in fp32 and cast back, FiLM,
the residual and the skips in bf16, the final 1×1 conv in fp32. Kernel B
does not read it: it samples with its own weight type (``fused_dtype``), as
the JAX kernel does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from . import init
from .embeddings import SinusoidalPosEmb, mish
from .mlp import compute_dtype_of, dense

GN_EPS = 1e-6


def conv(mod: nn.Module, x: torch.Tensor, dt: torch.dtype | None,
         **kw) -> torch.Tensor:
    """``mod(x)`` (a Conv1d or ConvTranspose1d), or with ``dt`` in that
    type: input and kernel cast, the product rounded to ``dt`` and the bias
    added in ``dt``, as XLA computes Flax's ``dtype=``; parameters staying
    fp32."""
    if dt is None:
        return mod(x)
    fn = (F.conv_transpose1d if isinstance(mod, nn.ConvTranspose1d)
          else F.conv1d)
    y = fn(x.to(dt), mod.weight.to(dt), None, mod.stride, mod.padding, **kw)
    return y if mod.bias is None else y + mod.bias.to(dt)[:, None]


class ConvBlock1D(nn.Module):
    """Conv1d(k, SAME) → GroupNorm → Mish."""

    def __init__(self, cin: int, channels: int, kernel_size: int = 5,
                 n_groups: int = 8, generator: torch.Generator | None = None,
                 compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.conv = init.layer(nn.Conv1d, cin, channels, kernel_size,
                               padding=kernel_size // 2, generator=generator)
        self.norm = nn.GroupNorm(n_groups, channels, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return mish(self.norm(self.conv(x)))
        return mish(self.norm(conv(self.conv, x, dt).float())).to(dt)


class FiLMResBlock1D(nn.Module):
    def __init__(self, cin: int, channels: int, cond_dim: int,
                 kernel_size: int = 5, n_groups: int = 8,
                 generator: torch.Generator | None = None,
                 compute_dtype=None):
        super().__init__()
        self.channels = channels
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.block0 = ConvBlock1D(cin, channels, kernel_size, n_groups,
                                  generator, compute_dtype)
        self.film = init.layer(nn.Linear, cond_dim, 2 * channels,
                               init="xavier", generator=generator)
        self.block1 = ConvBlock1D(channels, channels, kernel_size, n_groups,
                                  generator, compute_dtype)
        self.proj = (init.layer(nn.Conv1d, cin, channels, 1,
                                generator=generator)
                     if cin != channels else None)

    def forward(self, x: torch.Tensor, mcond: torch.Tensor) -> torch.Tensor:
        """x: (B, Cin, T); mcond: mish(cond), (B, cond_dim)."""
        dt = self.compute_dtype
        h = self.block0(x)
        film = dense(self.film, mcond, dt)[:, :, None]
        h = film[:, :self.channels] * h + film[:, self.channels:]
        h = self.block1(h)
        return h + (conv(self.proj, x, dt) if self.proj is not None else x)


class ConditionalUnet1D(nn.Module):
    """ε(sample (B, T, input_dim), timestep, global_cond (B, Dc))."""

    def __init__(self, input_dim: int, global_cond_dim: int,
                 diffusion_step_embed_dim: int = 256,
                 down_dims: Sequence[int] = (256, 512, 1024),
                 kernel_size: int = 5, n_groups: int = 8,
                 downsample: bool = True,
                 generator: torch.Generator | None = None,
                 compute_dtype=None):
        """Weights as the Flax module initialises them (convs lecun-normal,
        Denses xavier-uniform, biases 0), drawn from ``generator``;
        ``compute_dtype`` as in the module note."""
        super().__init__()
        d = diffusion_step_embed_dim
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.input_dim = input_dim
        self.global_cond_dim = global_cond_dim
        self.dsed = d
        self.down_dims = tuple(down_dims)
        self.kernel_size = kernel_size
        self.n_groups = n_groups
        self.downsample = bool(downsample)
        self.time_emb = SinusoidalPosEmb(d)
        self.time_dense0 = init.layer(nn.Linear, d, 4 * d, init="xavier",
                                      generator=generator)
        self.time_dense1 = init.layer(nn.Linear, 4 * d, d, init="xavier",
                                      generator=generator)
        cond_dim = d + global_cond_dim

        def block(cin: int, ch: int) -> FiLMResBlock1D:
            return FiLMResBlock1D(cin, ch, cond_dim, kernel_size, n_groups,
                                  generator, compute_dtype)

        blocks = []
        cin = input_dim
        for ch in self.down_dims:
            blocks += [block(cin, ch), block(ch, ch)]
            cin = ch
        mid = self.down_dims[-1]
        blocks += [block(mid, mid) for _ in range(2)]
        for ch, skip in zip(reversed(self.down_dims[:-1]),
                            reversed(self.down_dims[1:])):
            blocks += [block(cin + skip, ch), block(ch, ch)]
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        resampled = self.down_dims[:-1] if self.downsample else ()
        self.downs = nn.ModuleList(
            init.layer(nn.Conv1d, ch, ch, 3, stride=2, generator=generator)
            for ch in resampled)
        # Flax's ConvTranspose kernel is (4, in, out): fan_in 4·in
        self.ups = nn.ModuleList(
            init.layer(nn.ConvTranspose1d, ch, ch, 4, stride=2, padding=1,
                       generator=generator)
            for ch in reversed(resampled))
        self.final_block = ConvBlock1D(self.down_dims[0], self.down_dims[0],
                                       kernel_size, n_groups, generator,
                                       compute_dtype)
        self.final_conv = init.layer(nn.Conv1d, self.down_dims[0], input_dim,
                                     1, generator=generator)

    def forward(self, sample: torch.Tensor, timestep: torch.Tensor,
                global_cond: torch.Tensor) -> torch.Tensor:
        B, T, _ = sample.shape
        factor = 2 ** (len(self.down_dims) - 1) if self.downsample else 1
        if T % factor:
            raise ValueError(f"sequence length {T} must be divisible by "
                             f"{factor} (downsample levels)")
        dt = self.compute_dtype
        # the activations' type: fp32 (fp64 in checks), or bf16
        dtype = dt or self.final_conv.weight.dtype
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        temb = self.time_emb(t.expand(B))
        if dt is None:
            temb = temb.to(dtype)
        temb = dense(self.time_dense1, mish(dense(self.time_dense0, temb, dt)),
                     dt)
        mcond = mish(torch.cat([temb, global_cond.to(dtype)], -1))

        x = sample.to(dtype).transpose(1, 2)
        blocks = iter(self.blocks)
        skips = []
        L = len(self.down_dims)
        for i in range(L):
            x = next(blocks)(x, mcond)
            x = next(blocks)(x, mcond)
            skips.append(x)
            if self.downsample and i < L - 1:
                x = conv(self.downs[i], F.pad(x, (0, 1)), dt)
        x = next(blocks)(x, mcond)
        x = next(blocks)(x, mcond)
        for j in range(L - 1):
            x = torch.cat([x, skips.pop()], 1)
            x = next(blocks)(x, mcond)
            x = next(blocks)(x, mcond)
            if self.downsample:
                x = conv(self.ups[j], x, dt)
        x = self.final_block(x)
        if dt is not None:
            x = x.float()                  # the final 1x1 conv in fp32
        return self.final_conv(x).transpose(1, 2)


def unet_from_config(cfg, input_dim: int, global_cond_dim: int,
                     generator: torch.Generator | None = None
                     ) -> ConditionalUnet1D:
    """A U-Net from a net section of an agent config (the yaml's keys, the
    Flax module's defaults where a key is missing)."""
    return ConditionalUnet1D(
        input_dim, global_cond_dim, cfg.get("diffusion_step_embed_dim", 256),
        tuple(cfg.get("down_dims", (256, 512, 1024))),
        cfg.get("kernel_size", 5), cfg.get("n_groups", 8),
        cfg.get("downsample", True), generator,
        cfg.get("compute_dtype", "float32"))
