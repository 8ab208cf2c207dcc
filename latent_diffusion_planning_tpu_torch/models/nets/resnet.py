"""Vision encoder: ResNet-V1 with pluggable pooling heads.

Counterpart of ``latent_diffusion_planning_tpu/models/nets/resnet.py``:
basic and bottleneck blocks with GroupNorm (4 groups, eps 1e-5) or
LayerNorm over channels, bias-free convs, a 7×7 stride-2 stem and a 3×3
stride-2 max-pool, the pooling heads (spatial softmax keypoints, spatial
learned embeddings, avg, max, none), optional spatial-coordinate channels,
a ``feature_layers`` MLP and the sigmoid, tanh and simnorm output heads.
The DP baseline's encoder is ResNet-18 + GroupNorm + spatial softmax.

The encoder takes and returns NHWC like the JAX one; inside, the convs run
NCHW. Padding follows ``lax.padtype_to_pads``: Flax's ``"SAME"`` pads a
stride-2 window over an even size by (0, 1), not (1, 1), so every conv and
the pool take their pads from ``same_pads``; torch's symmetric
``padding=1`` gives the same shapes with windows one pixel off.

FiLM and multiplicative conditioning on a ``cond_var`` (B, cond_dim) after
every block, as the Flax encoder: ``x·(1 + mult) + add`` from two Denses
that start at zero (``FilmConditioning``), and ``x·gate`` from a Dense drawn
xavier-normal; torch needs ``cond_dim`` when the encoder is built.
``compute_dtype="bfloat16"`` computes as the Flax encoder does with it: fp32
parameters, every conv in bf16 (input and kernel cast), the norms in fp32
and their outputs fp32 (the stem's activation cast back to bf16 before the
max-pool), the conditioning, the pooling and the heads in fp32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from . import init
from .mlp import MLP, activation, compute_dtype_of

NORM_EPS = 1e-5
GROUPS = 4


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) pads of a ``"SAME"`` window, as ``lax.padtype_to_pads``
    computes them: the output is ceil(size / stride) and the odd pixel of
    padding goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> tuple[torch.Tensor, tuple[int, int]]:
    """``x`` padded for a ``"SAME"`` window, or, where the pads are
    symmetric, unpadded with the pad the op should apply itself."""
    (h0, h1), (w0, w1) = (same_pads(x.shape[-2], kernel, stride),
                          same_pads(x.shape[-1], kernel, stride))
    if h0 == h1 and w0 == w1:
        return x, (h0, w0)
    return F.pad(x, (w0, w1, h0, h1), value=value), (0, 0)


class SameConv2d(nn.Conv2d):
    """Bias-free conv with Flax's ``"SAME"`` padding, in ``compute_dtype``
    (None: the weight's own type)."""

    compute_dtype = None

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 device=None):
        super().__init__(cin, cout, kernel, stride, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _pad_same(x, self.kernel_size[0], self.stride[0])
        w = self.weight
        if self.compute_dtype is not None:
            x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
        return F.conv2d(x, w, None, self.stride, pad)


def same_conv(cin: int, cout: int, kernel: int, stride: int = 1,
              generator: torch.Generator | None = None,
              compute_dtype=None) -> SameConv2d:
    """A ``SameConv2d`` drawn as Flax's ``kaiming_normal`` (a normal
    truncated at ±2σ, variance 2 / fan_in)."""
    conv = init.layer(SameConv2d, cin, cout, kernel, stride,
                      init="kaiming_normal", generator=generator)
    conv.compute_dtype = compute_dtype_of(compute_dtype)
    return conv


class ChannelLayerNorm(nn.Module):
    """Flax's LayerNorm on NHWC: over the channels of each pixel."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), self.weight.shape, self.weight,
                         self.bias, NORM_EPS)
        return y.permute(0, 3, 1, 2)


class Fp32GroupNorm(nn.GroupNorm):
    """GroupNorm of a bf16 input in fp32 (Flax's ``dtype=float32``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class Fp32ChannelLayerNorm(ChannelLayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def make_norm(kind: str, channels: int, fp32_input: bool = False
              ) -> nn.Module:
    """The block norm; ``fp32_input`` (bf16 compute) casts its input to
    fp32 first."""
    if kind == "group":
        cls = Fp32GroupNorm if fp32_input else nn.GroupNorm
        return cls(GROUPS, channels, eps=NORM_EPS)
    if kind == "layer":
        return (Fp32ChannelLayerNorm if fp32_input
                else ChannelLayerNorm)(channels)
    raise ValueError(f"unsupported norm {kind!r}")


class FilmConditioning(nn.Module):
    """FiLM: ``x·(1 + mult) + add`` per channel, from two Denses of the
    condition that start at zero (the Flax module's ``Dense_0`` is add,
    ``Dense_1`` mult)."""

    def __init__(self, channels: int, cond_dim: int):
        super().__init__()
        self.add = init.layer(nn.Linear, cond_dim, channels, init="zeros")
        self.mult = init.layer(nn.Linear, cond_dim, channels, init="zeros")

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """x: NCHW."""
        cond = cond.float()
        return (x * (1.0 + self.mult(cond)[:, :, None, None])
                + self.add(cond)[:, :, None, None])


class ResNetBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, norm: str,
                 act: str, generator: torch.Generator | None = None,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        conv = lambda *a, **k: same_conv(*a, **k, compute_dtype=dt)
        nrm = lambda c: make_norm(norm, c, dt is not None)
        self.conv0 = conv(cin, filters, 3, stride, generator)
        self.norm0 = nrm(filters)
        self.conv1 = conv(filters, filters, 3, generator=generator)
        self.norm1 = nrm(filters)
        self.act = activation(act)
        self.proj = self.norm_proj = None
        if stride != 1 or cin != filters:
            self.proj = conv(cin, filters, 1, stride, generator)
            self.norm_proj = nrm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        if self.proj is not None:
            x = self.norm_proj(self.proj(x))
        return self.act(x + y)


class BottleneckResNetBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, norm: str,
                 act: str, generator: torch.Generator | None = None,
                 compute_dtype=None):
        super().__init__()
        dt = compute_dtype_of(compute_dtype)
        conv = lambda *a, **k: same_conv(*a, **k, compute_dtype=dt)
        nrm = lambda c: make_norm(norm, c, dt is not None)
        self.conv0 = conv(cin, filters, 1, generator=generator)
        self.norm0 = nrm(filters)
        self.conv1 = conv(filters, filters, 3, stride, generator)
        self.norm1 = nrm(filters)
        self.conv2 = conv(filters, 4 * filters, 1, generator=generator)
        self.norm2 = nrm(4 * filters)
        nn.init.zeros_(self.norm2.weight)
        self.act = activation(act)
        self.proj = self.norm_proj = None
        if stride != 1 or cin != 4 * filters:
            self.proj = conv(cin, 4 * filters, 1, stride, generator)
            self.norm_proj = nrm(4 * filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.norm0(self.conv0(x)))
        y = self.act(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        if self.proj is not None:
            x = self.norm_proj(self.proj(x))
        return self.act(x + y)


BLOCKS = {"ResNetBlock": ResNetBlock,
          "BottleneckResNetBlock": BottleneckResNetBlock}


def spatial_coordinates(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` with normalized (x, y) coordinate channels appended."""
    h, w = x.shape[-3], x.shape[-2]
    ys = torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1)
    return torch.cat([x, grid.expand(*x.shape[:-3], h, w, 2)], -1)


class SpatialSoftmax(nn.Module):
    """Expected (x, y) keypoint of each channel → (B, 2C): all expected-x,
    then all expected-y. The grid is the JAX one's literally,
    ``meshgrid(linspace(H), linspace(W))`` in ``xy`` indexing, flattened.
    A temperature of -1 makes it a learned parameter."""

    def __init__(self, temperature: float = 1.0):
        super().__init__()
        self.temperature = temperature
        if temperature == -1:
            self.softmax_temperature = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW features."""
        B, C, H, W = x.shape
        pos_x, pos_y = torch.meshgrid(
            torch.linspace(-1.0, 1.0, H, device=x.device),
            torch.linspace(-1.0, 1.0, W, device=x.device), indexing="xy")
        temp = (self.softmax_temperature if self.temperature == -1
                else self.temperature)
        attn = torch.softmax(x.float().reshape(B, C, H * W) / temp, -1)
        ex = (pos_x.reshape(-1) * attn).sum(-1)
        ey = (pos_y.reshape(-1) * attn).sum(-1)
        return torch.cat([ex, ey], -1)


class SpatialLearnedEmbeddings(nn.Module):
    """Learned spatial pooling: ``num_features`` attention maps per channel
    → (B, C·num_features). The kernel keeps the JAX layout (H, W, C, F)."""

    def __init__(self, height: int, width: int, channels: int,
                 num_features: int = 8,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(height, width, channels,
                                               num_features))
        init.lecun_normal_(self.kernel.data, height * width * channels,
                           generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW features."""
        return torch.einsum("bchw,hwcf->bcf", x, self.kernel).reshape(
            x.shape[0], -1)


class ResNetEncoder(nn.Module):
    """ResNet-V1 feature extractor over NHWC images of ``image_shape``
    (H, W, C), the size the spatial heads and the feature MLP are built
    for."""

    def __init__(self, image_shape: Sequence[int],
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block_cls: str = "ResNetBlock", n_filters: int = 64,
                 norm: str = "group", act: str = "relu",
                 pooling_method: str = "spatial_softmax",
                 softmax_temperature: float = 1.0, n_spatial_blocks: int = 8,
                 feature_layers: Sequence[int] = (),
                 add_spatial_coordinates: bool = False,
                 use_film: bool = False, use_multiplicative_cond: bool = False,
                 use_sigmoid: bool = False, use_tanh: bool = False,
                 use_simnorm: bool = False, use_simnorm_rescale: bool = False,
                 simnorm_dim: int = 8, compute_dtype: str = "float32",
                 generator: torch.Generator | None = None,
                 cond_dim: int | None = None):
        super().__init__()
        if (use_film or use_multiplicative_cond) and not cond_dim:
            raise ValueError("FiLM and multiplicative conditioning need the "
                             "condition's width (cond_dim) to build their "
                             "Denses")
        self.compute_dtype = dt = compute_dtype_of(compute_dtype)
        self.use_film = use_film
        self.use_multiplicative_cond = use_multiplicative_cond
        if sum([use_sigmoid, use_tanh, use_simnorm, use_simnorm_rescale]) > 1:
            raise ValueError("at most one output head")
        if pooling_method not in ("spatial_softmax",
                                  "spatial_learned_embeddings", "avg", "max",
                                  "none"):
            raise ValueError(f"unknown pooling {pooling_method!r}")
        H, W, C = (int(v) for v in image_shape)
        self.pooling_method = pooling_method
        self.add_spatial_coordinates = add_spatial_coordinates
        self.use_sigmoid, self.use_tanh = use_sigmoid, use_tanh
        self.use_simnorm = use_simnorm or use_simnorm_rescale
        self.use_simnorm_rescale = use_simnorm_rescale
        self.simnorm_dim = simnorm_dim
        cin = C + 2 if add_spatial_coordinates else C
        self.conv_init = init.layer(nn.Conv2d, cin, n_filters, 7, 2,
                                    padding=3, bias=False,
                                    init="kaiming_normal", generator=generator)
        self.norm_init = make_norm(norm, n_filters, dt is not None)
        self.act = activation(act)
        H, W = (H + 6 - 7) // 2 + 1, (W + 6 - 7) // 2 + 1     # the stem
        H, W = -(-H // 2), -(-W // 2)                         # the pool
        block = BLOCKS[block_cls]
        blocks, widths = [], []
        cin = n_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                filters = n_filters * 2 ** i
                blocks.append(block(cin, filters, stride, norm, act,
                                    generator, compute_dtype))
                cin = filters * block.expansion
                widths.append(cin)
                H, W = -(-H // stride), -(-W // stride)
        self.blocks = nn.ModuleList(blocks)
        self.films = (nn.ModuleList(FilmConditioning(c, cond_dim)
                                    for c in widths) if use_film else None)
        self.gates = (nn.ModuleList(
            init.layer(nn.Linear, cond_dim, c, init="xavier_normal",
                       generator=generator) for c in widths)
            if use_multiplicative_cond else None)
        self.pool = None
        if pooling_method == "spatial_softmax":
            self.pool = SpatialSoftmax(softmax_temperature)
            feat = 2 * cin
        elif pooling_method == "spatial_learned_embeddings":
            self.pool = SpatialLearnedEmbeddings(H, W, cin, n_spatial_blocks,
                                                 generator)
            feat = cin * n_spatial_blocks
        else:
            feat = cin
        self.mlp = (MLP(feat, feature_layers, generator=generator)
                    if feature_layers else None)
        # features an image gives once flattened
        self.n_features = ((feature_layers[-1] if feature_layers else feat)
                           * (H * W if pooling_method == "none" else 1))

    def forward(self, x: torch.Tensor,
                cond_var: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, H, W, C) → (B, n_features), or (B, h, w, channels) with
        ``pooling_method="none"``; ``cond_var`` (B, cond_dim) feeds FiLM
        and the multiplicative gates."""
        if (self.films is not None or self.gates is not None) and (
                cond_var is None):
            raise ValueError("FiLM and multiplicative conditioning need "
                             "cond_var")
        dt = self.compute_dtype
        x = x.float()
        if self.add_spatial_coordinates:
            x = spatial_coordinates(x)
        # NCHW-contiguous: a permuted NHWC tensor carries channels-last
        # strides into the convs, and the CPU backward of the stride-2
        # blocks then crashes with several threads (torch 2.13 CPU build)
        x = x.permute(0, 3, 1, 2).contiguous()
        if dt is None:
            x = self.act(self.norm_init(self.conv_init(x)))
        else:
            x = F.conv2d(x.to(dt), self.conv_init.weight.to(dt), None,
                         self.conv_init.stride, self.conv_init.padding)
            x = self.act(self.norm_init(x)).to(dt)
        x, pad = _pad_same(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x, 3, 2, pad)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if self.films is not None:
                x = self.films[i](x.float(), cond_var)
            if self.gates is not None:
                x = x.float() * self.gates[i](cond_var.float())[:, :, None,
                                                                None]
        if dt is not None:
            x = x.float()
        if self.pool is not None:
            x = self.pool(x)
        elif self.pooling_method == "avg":
            x = x.mean((-2, -1))
        elif self.pooling_method == "max":
            x = x.amax((-2, -1))
        else:
            x = x.permute(0, 2, 3, 1)
        if self.mlp is not None:
            x = self.mlp(x)
        if self.use_sigmoid:
            x = torch.sigmoid(x)
        if self.use_tanh:
            x = torch.tanh(x)
        if self.use_simnorm:
            shape = x.shape
            x = torch.softmax(x.reshape(*shape[:-1], -1, self.simnorm_dim), -1)
            if self.use_simnorm_rescale:
                x = 2.0 * x - 1.0
            x = x.reshape(shape)
        return x
