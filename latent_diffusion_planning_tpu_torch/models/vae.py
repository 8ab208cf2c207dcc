"""KL autoencoder for 64×64 camera frames: the encoder path.

Counterpart of ``latent_diffusion_planning_tpu/models/vae.py``'s ``KLVAE``
encoder (patch stem, ResBlock2D, stride-2 downsample, mid self-attention,
quant_conv). Public functions take and return NHWC like the JAX package;
inside, the net runs NCHW. The decoder, which only plan visualization needs,
is not ported yet.

This is plain network code: on the card its convolutions go to cuDNN. It
runs in float32 with TF32 off (``encode``), because the latents pass through
a min/max normalization into the planner's condition and TF32's 10-bit
mantissa would move them by about 1e-3.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

GN_EPS = 1e-6


class ResBlock2D(nn.Module):
    def __init__(self, cin: int, channels: int, norm_groups: int = 32):
        super().__init__()
        self.norm0 = nn.GroupNorm(min(norm_groups, cin), cin, eps=GN_EPS)
        self.conv0 = nn.Conv2d(cin, channels, 3, padding=1)
        self.norm1 = nn.GroupNorm(min(norm_groups, channels), channels,
                                  eps=GN_EPS)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.shortcut = (nn.Conv2d(cin, channels, 1) if cin != channels
                         else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv0(F.silu(self.norm0(x)))
        h = self.conv1(F.silu(self.norm1(h)))
        return (self.shortcut(x) if self.shortcut is not None else x) + h


class MidAttention(nn.Module):
    """Single-head self-attention over the bottleneck grid, as explicit
    matmuls and a softmax."""

    def __init__(self, channels: int, norm_groups: int = 32):
        super().__init__()
        self.norm = nn.GroupNorm(min(norm_groups, channels), channels,
                                 eps=GN_EPS)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).flatten(2).transpose(1, 2)           # (B, HW, C)
        q, k, v = self.q(h), self.k(h), self.v(h)
        attn = torch.softmax(q @ k.transpose(1, 2) / C ** 0.5, dim=-1)
        out = self.out(attn @ v)                               # (B, HW, C)
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class Encoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], latent_channels: int,
                 in_channels: int = 3, layers_per_block: int = 2,
                 norm_groups: int = 32, use_mid_attention: bool = True,
                 patch_size: int = 1, downsample_pad: str = "same"):
        super().__init__()
        boc = list(block_out_channels)
        self.downsample_pad = downsample_pad
        if patch_size > 1:
            self.stem = nn.Conv2d(in_channels, boc[0], patch_size,
                                  stride=patch_size)
        else:
            self.stem = nn.Conv2d(in_channels, boc[0], 3, padding=1)
        levels = []
        cin = boc[0]
        for i, ch in enumerate(boc):
            blocks = []
            for _ in range(layers_per_block):
                blocks.append(ResBlock2D(cin, ch, norm_groups))
                cin = ch
            levels.append(nn.ModuleList(blocks))
        self.levels = nn.ModuleList(levels)
        self.downs = nn.ModuleList(nn.Conv2d(ch, ch, 3, stride=2)
                                   for ch in boc[:-1])
        top = boc[-1]
        self.mid0 = ResBlock2D(top, top, norm_groups)
        self.attn = MidAttention(top, norm_groups) if use_mid_attention else None
        self.mid1 = ResBlock2D(top, top, norm_groups)
        self.norm_out = nn.GroupNorm(min(norm_groups, top), top, eps=GN_EPS)
        self.conv_out = nn.Conv2d(top, 2 * latent_channels, 3, padding=1)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.stem(x)
        for i, blocks in enumerate(self.levels):
            for blk in blocks:
                x = blk(x)
            if i < len(self.downs):
                # "same" pads 1 on every side; "diffusers" pads (0, 1)
                pad = (1, 1, 1, 1) if self.downsample_pad == "same" else (0, 1, 0, 1)
                x = self.downs[i](F.pad(x, pad))
        x = self.mid0(x)
        if self.attn is not None:
            x = self.attn(x)
        x = self.mid1(x)
        x = self.conv_out(F.silu(self.norm_out(x)))
        x = self.quant_conv(x)
        mean, logvar = torch.chunk(x, 2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


class KLVAE(nn.Module):
    """The autoencoder's encoder; images NHWC in [-1, 1]."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 256, 256,
                                                            256, 256),
                 in_channels: int = 3, out_channels: int = 3,
                 latent_channels: int = 4, layers_per_block: int = 2,
                 norm_groups: int = 32, use_mid_attention: bool = True,
                 patch_size: int = 1, downsample_pad: str = "same"):
        super().__init__()
        self.latent_channels = latent_channels
        self.encoder = Encoder(block_out_channels, latent_channels, in_channels,
                               layers_per_block, norm_groups, use_mid_attention,
                               patch_size, downsample_pad)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, C) → (mean, logvar), each (B, h, w, latent_channels)."""
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            mean, logvar = self.encoder(x.float().permute(0, 3, 1, 2))
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        return mean.permute(0, 2, 3, 1), logvar.permute(0, 2, 3, 1)
