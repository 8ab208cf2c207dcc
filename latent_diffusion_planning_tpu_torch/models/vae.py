"""KL autoencoder (β-VAE) for 64×64 camera frames, and its trainer.

Counterpart of ``latent_diffusion_planning_tpu/models/vae.py``: ``KLVAE``
(patch stem, ResBlock2D, stride-2 downsample, mid self-attention,
quant_conv; the decoder's post_quant_conv, nearest 2× upsampling and
pixel-shuffle head), ``kl_divergence``, ``latent_grid_shape`` and
``VAEModel`` (recon MSE + β·KL on the first frame of every rgb key, Adam
with the warmup-cosine schedule, EMA weights for inference). Public
functions take and return NHWC like the JAX package; inside, the nets run
NCHW.

This is plain network code: on the card its convolutions go to cuDNN. The
VAE runs in float32 with TF32 off (``fp32_math``) when it encodes, decodes
and trains, because its latents pass through a min/max normalization into
the planner's condition and TF32's 10-bit mantissa would move them by about
1e-3; the latents a trained VAE gives are those of the function it was
trained as.

``compute_dtype="bfloat16"`` (``model.vae.compute_dtype``) computes as the
Flax module does with it: fp32 parameters; the convs of the stem, the
``ResBlock2D``s, the downsamples and upsamples in bf16 (input, kernel and
bias cast, result bf16); the ``ResBlock2D`` GroupNorms with fp32 statistics
and a bf16 result, as Flax's ``dtype=compute_dtype`` there; the mid
attention, the output GroupNorms and the last convs (``conv_out``,
``quant_conv``, ``post_quant_conv``) in fp32.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .. import resolve_device
from ..ops import normalize as nz
from .nets import init
from .nets.mlp import compute_dtype_of
from ..parallel import mesh as meshlib
from ..train.state import TrainState
from ..utils.precision import fp32_math

GN_EPS = 1e-6


def conv2d(mod: nn.Conv2d, x: torch.Tensor, dt: torch.dtype | None
           ) -> torch.Tensor:
    """``mod(x)``, or with ``dt`` in that type: input and kernel cast, the
    product rounded to ``dt`` and the bias added in ``dt``, as XLA computes
    Flax's ``dtype=``."""
    if dt is None:
        return mod(x)
    y = F.conv2d(x.to(dt), mod.weight.to(dt), None, mod.stride, mod.padding)
    return y if mod.bias is None else y + mod.bias.to(dt)[:, None, None]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x / (1 + exp(-x))`` op by op, each rounded to the input's type, as
    XLA computes ``nn.silu`` on bf16."""
    return x * (1 / (1 + torch.exp(-x)))


class ResBlock2D(nn.Module):
    compute_dtype = None   # set by the encoder and decoder

    def __init__(self, cin: int, channels: int, norm_groups: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm0 = nn.GroupNorm(min(norm_groups, cin), cin, eps=GN_EPS)
        self.conv0 = init.layer(nn.Conv2d, cin, channels, 3, padding=1,
                                generator=generator)
        self.norm1 = nn.GroupNorm(min(norm_groups, channels), channels,
                                  eps=GN_EPS)
        self.conv1 = init.layer(nn.Conv2d, channels, channels, 3, padding=1,
                                generator=generator)
        self.shortcut = (init.layer(nn.Conv2d, cin, channels, 1,
                                    generator=generator)
                         if cin != channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            h = self.conv0(F.silu(self.norm0(x)))
            h = self.conv1(F.silu(self.norm1(h)))
            return (self.shortcut(x) if self.shortcut is not None else x) + h
        h = conv2d(self.conv0, silu(self.norm0(x.float()).to(dt)), dt)
        h = conv2d(self.conv1, silu(self.norm1(h.float()).to(dt)), dt)
        x = conv2d(self.shortcut, x, dt) if self.shortcut is not None else x
        return x.to(dt) + h


class MidAttention(nn.Module):
    """Single-head self-attention over the bottleneck grid, as explicit
    matmuls and a softmax."""

    def __init__(self, channels: int, norm_groups: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm = nn.GroupNorm(min(norm_groups, channels), channels,
                                 eps=GN_EPS)
        self.q, self.k, self.v, self.out = (
            init.layer(nn.Linear, channels, channels, generator=generator)
            for _ in range(4))

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
                 patch_size: int = 1, downsample_pad: str = "same",
                 generator: torch.Generator | None = None):
        super().__init__()
        boc = list(block_out_channels)
        self.downsample_pad = downsample_pad
        if patch_size > 1:
            self.stem = init.layer(nn.Conv2d, in_channels, boc[0],
                                   patch_size, stride=patch_size,
                                   generator=generator)
        else:
            self.stem = init.layer(nn.Conv2d, in_channels, boc[0], 3,
                                   padding=1, generator=generator)
        levels = []
        cin = boc[0]
        for i, ch in enumerate(boc):
            blocks = []
            for _ in range(layers_per_block):
                blocks.append(ResBlock2D(cin, ch, norm_groups, generator))
                cin = ch
            levels.append(nn.ModuleList(blocks))
        self.levels = nn.ModuleList(levels)
        self.downs = nn.ModuleList(
            init.layer(nn.Conv2d, ch, ch, 3, stride=2, generator=generator)
            for ch in boc[:-1])
        top = boc[-1]
        self.mid0 = ResBlock2D(top, top, norm_groups, generator)
        self.attn = (MidAttention(top, norm_groups, generator)
                     if use_mid_attention else None)
        self.mid1 = ResBlock2D(top, top, norm_groups, generator)
        self.norm_out = nn.GroupNorm(min(norm_groups, top), top, eps=GN_EPS)
        self.conv_out = init.layer(nn.Conv2d, top, 2 * latent_channels, 3,
                                   padding=1, generator=generator)
        self.quant_conv = init.layer(nn.Conv2d, 2 * latent_channels,
                                     2 * latent_channels, 1,
                                     generator=generator)

    def forward(self, x: torch.Tensor, dt: torch.dtype | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        x = conv2d(self.stem, x, dt)
        for i, blocks in enumerate(self.levels):
            for blk in blocks:
                x = blk(x)
            if i < len(self.downs):
                # "same" pads 1 on every side; "diffusers" pads (0, 1)
                pad = (1, 1, 1, 1) if self.downsample_pad == "same" else (0, 1, 0, 1)
                x = conv2d(self.downs[i], F.pad(x, pad), dt)
        x = self.mid0(x)
        if self.attn is not None:
            x = self.attn(x.float())
            if dt is not None:
                x = x.to(dt)
        x = self.mid1(x)
        x = F.silu(self.norm_out(x.float()))
        if dt is not None:
            x = x.to(dt).float()
        x = self.conv_out(x)
        x = self.quant_conv(x)
        mean, logvar = torch.chunk(x, 2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int], latent_channels: int,
                 out_channels: int = 3, layers_per_block: int = 2,
                 norm_groups: int = 32, use_mid_attention: bool = True,
                 patch_size: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        boc = list(block_out_channels)
        top = boc[-1]
        self.patch_size = patch_size
        self.out_channels = out_channels
        self.post_quant_conv = init.layer(nn.Conv2d, latent_channels,
                                          latent_channels, 1,
                                          generator=generator)
        self.conv_in = init.layer(nn.Conv2d, latent_channels, top, 3,
                                  padding=1, generator=generator)
        self.mid0 = ResBlock2D(top, top, norm_groups, generator)
        self.attn = (MidAttention(top, norm_groups, generator)
                     if use_mid_attention else None)
        self.mid1 = ResBlock2D(top, top, norm_groups, generator)
        levels = []
        cin = top
        for ch in reversed(boc):
            blocks = []
            for _ in range(layers_per_block + 1):
                blocks.append(ResBlock2D(cin, ch, norm_groups, generator))
                cin = ch
            levels.append(nn.ModuleList(blocks))
        self.levels = nn.ModuleList(levels)
        self.ups = nn.ModuleList(
            init.layer(nn.Conv2d, ch, ch, 3, padding=1, generator=generator)
            for ch in list(reversed(boc))[:-1])
        bottom = boc[0]
        self.norm_out = nn.GroupNorm(min(norm_groups, bottom), bottom,
                                     eps=GN_EPS)
        # patch_size > 1: p·p·C channels per cell, pixel-shuffled out
        self.conv_out = init.layer(nn.Conv2d, bottom,
                                   out_channels * patch_size ** 2, 3,
                                   padding=1, generator=generator)

    def forward(self, z: torch.Tensor, dt: torch.dtype | None = None
                ) -> torch.Tensor:
        x = conv2d(self.conv_in, self.post_quant_conv(z), dt)
        x = self.mid0(x)
        if self.attn is not None:
            x = self.attn(x.float())
            if dt is not None:
                x = x.to(dt)
        x = self.mid1(x)
        for i, blocks in enumerate(self.levels):
            for blk in blocks:
                x = blk(x)
            if i < len(self.ups):
                # exactly 2×: jax.image.resize's "nearest" repeats each cell
                x = conv2d(self.ups[i], F.interpolate(x, scale_factor=2.0,
                                                      mode="nearest"), dt)
        x = F.silu(self.norm_out(x.float()))
        if dt is not None:
            x = x.to(dt).float()
        x = self.conv_out(x)
        p = self.patch_size
        if p > 1:
            # the JAX head's channel index is (py·p + px)·C + c (its reshape
            # to (B, H, W, p, p, C)); pixel_shuffle would read c·p² + py·p +
            # px, so the shuffle is spelled out
            B, _, H, W = x.shape
            C = self.out_channels
            x = x.reshape(B, p, p, C, H, W).permute(0, 3, 4, 1, 5, 2).reshape(
                B, C, H * p, W * p)
        return x


class KLVAE(nn.Module):
    """The autoencoder; images NHWC in [-1, 1]. Every conv and Dense starts
    as Flax's default does (lecun-normal, bias 0), drawn from
    ``generator``."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 256, 256,
                                                            256, 256),
                 in_channels: int = 3, out_channels: int = 3,
                 latent_channels: int = 4, layers_per_block: int = 2,
                 norm_groups: int = 32, use_mid_attention: bool = True,
                 patch_size: int = 1, downsample_pad: str = "same",
                 generator: torch.Generator | None = None,
                 compute_dtype="float32"):
        super().__init__()
        self.compute_dtype = compute_dtype_of(compute_dtype)
        self.latent_channels = latent_channels
        self.in_channels = in_channels
        self.n_downsample = (patch_size.bit_length() - 1
                             + len(block_out_channels) - 1)
        self.encoder = Encoder(block_out_channels, latent_channels, in_channels,
                               layers_per_block, norm_groups, use_mid_attention,
                               patch_size, downsample_pad, generator)
        self.decoder = Decoder(block_out_channels, latent_channels,
                               out_channels, layers_per_block, norm_groups,
                               use_mid_attention, patch_size, generator)
        for m in self.modules():
            if isinstance(m, ResBlock2D):
                m.compute_dtype = self.compute_dtype

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, C) → (mean, logvar), each (B, h, w, latent_channels)."""
        with fp32_math():
            mean, logvar = self.encoder(x.float().permute(0, 3, 1, 2),
                                        self.compute_dtype)
        return mean.permute(0, 2, 3, 1), logvar.permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, h, w, latent_channels) → images (B, H, W, C)."""
        with fp32_math():
            x = self.decoder(z.float().permute(0, 3, 1, 2),
                             self.compute_dtype)
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, eps: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(reconstruction, mean, logvar); the decoder reads the posterior
        sample ``mean + exp(logvar / 2) · eps`` (NHWC like the mean), or the
        mean when ``eps`` is None."""
        mean, logvar = self.encode(x)
        z = mean if eps is None else mean + torch.exp(0.5 * logvar) * eps
        return self.decode(z), mean, logvar


def kl_divergence(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, I)) per sample, summed over latent dims."""
    return 0.5 * torch.sum(torch.square(mean) + torch.exp(logvar) - 1.0
                           - logvar, dim=tuple(range(1, mean.ndim)))


def latent_grid_shape(feature_dim: int) -> tuple[int, int, int]:
    """A flat latent feature dim's (h, w, c) grid."""
    table = {16: (2, 2, 4), 32: (2, 2, 8), 36: (3, 3, 4), 64: (4, 4, 4)}
    if feature_dim not in table:
        raise ValueError(f"unsupported vae_feature_dim {feature_dim}")
    return table[feature_dim]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

# VAEModel.create's keyword defaults in the JAX package
VAE_DEFAULTS = dict(name="klvae", use_kl=True, beta=1e-5, data_name="",
                    lr=1e-4, end_lr=1e-6, warmup_steps=1000,
                    decay_steps=300_000, ema_decay=0.99, image_size=64)


class VAEModel:
    """Trains a ``KLVAE`` on the first frame of every rgb obs key with recon
    MSE + β·KL; the EMA weights (when ``ema_decay`` > 0) serve encoding,
    decoding and sampling.

    The posterior sample's noise ε (NHWC, one row per image: the rgb keys'
    frames stacked key after key) comes from ``generator``, or
    ``draws={"eps": ...}`` hands it in; ``sample`` takes its prior draws
    the same way.
    """

    LOSS_KEYS = ("loss", "loss_mse", "loss_kl")

    def __init__(self, vae: KLVAE, obs_normalization: Any, config: Mapping,
                 device: torch.device):
        self.device = device
        self.vae = vae.to(device)
        c = {**VAE_DEFAULTS, **{k: v for k, v in config.items()
                                if k in VAE_DEFAULTS}}
        self.config = dict(c, rgb_obs=tuple(config["rgb_obs"]))
        self.obs_normalization = nz.stats_to_tensors(obs_normalization, device)
        self.vae_state = TrainState(
            self.vae, lr=c["lr"], end_lr=c["end_lr"],
            warmup_steps=c["warmup_steps"], decay_steps=c["decay_steps"],
            ema_decay=c["ema_decay"])

    @classmethod
    def create(cls, config: Mapping, *, seed: int = 0,
               device: torch.device | str | None = None) -> "VAEModel":
        """From a model config dict (``configs.lift_vae_train_config()``'s
        ``model``: ``vae``, ``rgb_obs``, ``obs_normalization``, ``beta``,
        the optimizer keys) with weights drawn from ``seed``."""
        dev = resolve_device(device)
        vae = KLVAE(**config.get("vae", {}),
                    generator=torch.Generator().manual_seed(seed))
        return cls(vae, config["obs_normalization"], config, dev)

    @property
    def inference_vae(self) -> KLVAE:
        return self.vae_state.inference_module

    def weights_changed(self) -> None:
        """Nothing is cached from the weights (the agents' hook)."""

    # -- losses -----------------------------------------------------------
    def _images(self, batch_obs: Mapping) -> torch.Tensor:
        return torch.cat([batch_obs[k][:, 0] for k in self.config["rgb_obs"]])

    def loss(self, batch: Mapping, eps: torch.Tensor):
        """(loss, metrics) on a normalized batch; ``eps`` as in the class
        note."""
        imgs = self._images(batch["obs"])
        rec, mean, logvar = self.vae(imgs, eps)
        mse = torch.mean(torch.square(imgs - rec))
        kl = (torch.mean(kl_divergence(mean, logvar)) if self.config["use_kl"]
              else torch.zeros((), device=self.device))
        loss = mse + self.config["beta"] * kl
        metrics = dict(loss=loss, loss_mse=mse, loss_kl=kl,
                       img_min=imgs.min(), img_max=imgs.max(),
                       z_min=mean.min(), z_max=mean.max(), z_mean=mean.mean(),
                       z_std=mean.std(correction=0))
        return loss, {k: v.detach() for k, v in metrics.items()}

    def _prepare(self, batch: Mapping) -> dict:
        return {"obs": nz.normalize_tree(
            {k: batch["obs"][k].to(self.device) for k in self.config["rgb_obs"]},
            self.obs_normalization["obs"])}

    def _eps(self, batch: Mapping, generator, draws) -> torch.Tensor:
        given = (draws or {}).get("eps")
        if given is not None:
            return torch.as_tensor(given, device=self.device).float()
        # one draw per key, each of the global batch's rows under
        # meshlib.sharded_draws
        return torch.cat([meshlib.draw_rows(lambda m: torch.randn(
            (m, *self.latent_hw()), generator=generator, device=self.device),
            batch["obs"][k].shape[0]) for k in self.config["rgb_obs"]])

    def backward(self, batch: Mapping,
                 generator: torch.Generator | None = None,
                 draws: Mapping | None = None) -> dict:
        """Forward and one backward pass on a raw batch ``{"obs": {rgb key:
        (B, H, h, w, c)}}`` (frame 0 of each window); leaves the gradients
        in the VAE's ``.grad`` and returns the metrics."""
        batch = self._prepare(batch)
        with fp32_math():
            loss, metrics = self.loss(batch, self._eps(batch, generator, draws))
            loss.backward()
        return metrics

    def apply_gradients(self) -> dict:
        """The optimizer step; returns the learning rate it applied and the
        step count before it."""
        metrics = {"vae_lr": self.vae_state.lr(),
                   "vae_step": self.vae_state.step}
        self.vae_state.apply_gradients()
        return metrics

    def update(self, batch: Mapping, step: int | None = None,
               generator: torch.Generator | None = None,
               draws: Mapping | None = None) -> dict:
        """``backward`` then ``apply_gradients``; ``step`` is taken for the
        Workspace's call and unused."""
        metrics = self.backward(batch, generator, draws)
        metrics.update(self.apply_gradients())
        return metrics

    @torch.no_grad()
    def get_metrics(self, batch: Mapping,
                    generator: torch.Generator | None = None,
                    draws: Mapping | None = None) -> dict:
        batch = self._prepare(batch)
        return self.loss(batch, self._eps(batch, generator, draws))[1]

    # -- inference ----------------------------------------------------------
    @torch.no_grad()
    def encode_mode(self, imgs: torch.Tensor) -> torch.Tensor:
        """Latent mean of normalized [-1, 1] NHWC images."""
        return self.inference_vae.encode(imgs.to(self.device))[0]

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.inference_vae.decode(z.to(self.device))

    def _unnormalize(self, imgs: torch.Tensor) -> torch.Tensor:
        key = self.config["rgb_obs"][0]
        return nz.unnormalize_tree(
            {key: imgs}, {key: self.obs_normalization["obs"][key]})[key]

    def reconstruct(self, batch: Mapping) -> torch.Tensor:
        """The first frame of the first rgb key of a raw batch, through the
        encoder's mean and the decoder, back in the key's units."""
        key = self.config["rgb_obs"][0]
        obs = nz.normalize_tree(
            {key: batch["obs"][key][:, 0].to(self.device)},
            {key: self.obs_normalization["obs"][key]})[key]
        return self._unnormalize(self.decode(self.encode_mode(obs)))

    def sample(self, n: int, generator: torch.Generator | None = None,
               z: torch.Tensor | None = None) -> torch.Tensor:
        """Decoded prior samples z ~ N(0, I) (``z`` hands them in)."""
        if z is None:
            z = torch.randn((n, *self.latent_hw()), generator=generator,
                            device=self.device)
        return self._unnormalize(self.decode(z))

    def latent_hw(self) -> tuple[int, int, int]:
        s = self.config["image_size"] // (2 ** self.vae.n_downsample)
        return (s, s, self.vae.latent_channels)

    # -- persistence --------------------------------------------------------
    def get_params(self) -> dict:
        """``{vae_params, vae_ema_params}`` state dicts: the form an LDP or
        DPVAE workspace's ``vae_pretrain_path`` reads."""
        ema = self.vae_state.ema
        return {"vae_params": self.vae.state_dict(),
                "vae_ema_params": None if ema is None else ema.state_dict()}

    def state_dict(self) -> dict:
        return {"vae": self.vae_state.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.vae_state.load_state_dict(state["vae"])
