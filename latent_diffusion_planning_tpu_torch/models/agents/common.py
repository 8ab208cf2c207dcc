"""Shared agent machinery: observation conditioning, the VAE latent codec
and kernel B's route for the agents that diffuse action sequences.

Counterpart of ``latent_diffusion_planning_tpu/models/agents/common.py``
(and of ``models/agents/dp.py``'s ``_fused_action_ddim``, which DP and DPVAE
share). A batch is ``{"obs": {key: (B, H, ...)}, "actions": (B, T, A)}``;
the conditioning vector per timestep is the rgb features first, then the
lowdim keys, in config order.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import torch

from ...ops import diffusion as dlib
from ...ops import normalize as nz
from ...ops.kernels import diffusion_unet1d as kunet
from ..nets.unet1d import ConditionalUnet1D
from ..vae import KLVAE, latent_grid_shape


def obs_cond_from_features(batch_obs: Mapping[str, torch.Tensor],
                           rgb_obs: Sequence[str],
                           lowdim_obs: Sequence[str]) -> torch.Tensor:
    """Concat per-timestep rgb feature vectors + lowdim obs → (B, H, D)."""
    ref = batch_obs[rgb_obs[0]] if rgb_obs else batch_obs[lowdim_obs[0]]
    B, H = ref.shape[:2]
    parts = [batch_obs[k].reshape(B, H, -1).float()
             for k in (*rgb_obs, *lowdim_obs)]
    return torch.cat(parts, -1)


def obs_dims(shape_meta: Mapping[str, Any], rgb_obs: Sequence[str],
             lowdim_obs: Sequence[str], rgb_feature_dim: int) -> tuple[int, int]:
    """(obs_dim, action_dim) for the given key selection."""
    lowdim = sum(math.prod(shape_meta["all_shapes"][k]) for k in lowdim_obs)
    return lowdim + rgb_feature_dim * len(rgb_obs), int(shape_meta["ac_dim"])


def transition_pairs(obs_emb: torch.Tensor, obs_horizon: int) -> torch.Tensor:
    """(s_t, s_{t+1}) pairs over the window tail → (B·(H-obs_horizon), 2D):
    the IDM's training inputs."""
    pair = torch.cat([obs_emb[:, obs_horizon - 1:-1], obs_emb[:, obs_horizon:]],
                     -1)
    return pair.reshape(-1, pair.shape[-1])


def consecutive_pairs(plan: torch.Tensor) -> torch.Tensor:
    """(s_t, s_{t+1}) pairs along a plan → (B·(T-1), 2D)."""
    pair = torch.cat([plan[:, :-1], plan[:, 1:]], -1)
    return pair.reshape(-1, pair.shape[-1])


class VAECodec:
    """Moves obs between image and normalized latent space with a frozen
    VAE."""

    def __init__(self, vae: KLVAE, rgb_obs: Sequence[str],
                 vae_feature_dim: int):
        self.vae = vae
        self.rgb_obs = tuple(rgb_obs)   # e.g. ("latent_agentview_image",)
        self.vae_feature_dim = vae_feature_dim

    @torch.no_grad()
    def encode_obs(self, batch_obs: Mapping[str, torch.Tensor],
                   obs_normalization: Any) -> dict:
        """Encode each raw rgb key whose ``latent_<key>`` is an agent input;
        keys already in latent form pass through."""
        out = {}
        for key, val in batch_obs.items():
            latent_key = f"latent_{key}"
            if latent_key not in self.rgb_obs:
                out[key] = val
                continue
            B, H = val.shape[:2]
            mean, _ = self.vae.encode(val.reshape((-1,) + val.shape[2:]))
            feats = mean.reshape(B, H, -1)
            out[latent_key] = nz.normalize_tree(
                {latent_key: feats},
                {latent_key: obs_normalization["obs"][latent_key]})[latent_key]
        return out

    @torch.no_grad()
    def decode_features(self, feats: torch.Tensor,
                        obs_normalization: Any) -> torch.Tensor:
        """(B, T, obs_dim) normalized features → the decoded images of their
        first rgb key's latents, (B, T, h, w, c) in [-1, 1]."""
        B, T = feats.shape[:2]
        h, w, c = latent_grid_shape(self.vae_feature_dim)
        z = feats[:, :, :self.vae_feature_dim].reshape(B * T, h, w, c)
        key = self.rgb_obs[0]
        z = nz.unnormalize_tree({key: z},
                                {key: obs_normalization["obs"][key]})[key]
        rec = self.vae.decode(z)
        return rec.reshape(B, T, *rec.shape[1:])


def prepare_batch(batch: Mapping[str, Any], obs_normalization: Any) -> dict:
    """Normalize a raw batch (obs and, when present, actions)."""
    out = {"obs": nz.normalize_tree(batch["obs"], obs_normalization["obs"])}
    if "actions" in batch:
        out["actions"] = nz.normalize_tree({"actions": batch["actions"]},
                                           obs_normalization)["actions"]
    return out


def debug_obs_metrics(batch_obs: Mapping[str, torch.Tensor]) -> dict:
    """Per-key min/max gauges."""
    out = {}
    for k, v in batch_obs.items():
        out[f"{k}_min"] = v.min()
        out[f"{k}_max"] = v.max()
    return out


def check_action_weights(weights, action_dim: int):
    """None (no weighting) or a validated length-``action_dim`` tuple of
    positive per-channel action loss weights."""
    if weights is None:
        return None
    w = tuple(float(v) for v in weights)
    if len(w) != action_dim:
        raise ValueError(f"action_loss_weights has {len(w)} entries for "
                         f"{action_dim}-dim actions")
    if min(w) <= 0:
        raise ValueError(f"action_loss_weights must be positive: {w}")
    return w


def weight_action_channels(sq_err: torch.Tensor, weights) -> torch.Tensor:
    """Weight the last (action channel) axis by ``weights`` normalized to
    mean 1, so the loss scale is the same with and without weighting."""
    if not weights:
        return sq_err
    w = torch.tensor(weights, dtype=sq_err.dtype, device=sq_err.device)
    return sq_err * (w * (w.numel() / w.sum()))


# ---------------------------------------------------------------------------
# the reverse processes the kernels run
# ---------------------------------------------------------------------------

def strided_ddim(steps: int | None, sched: dlib.DiffusionSchedule) -> bool:
    """Whether ``steps`` asks for strided DDIM (fewer steps than trained);
    otherwise the full ancestral DDPM process runs, as the JAX package's
    default configurations (``inference_steps: null``) sample."""
    return bool(steps and steps < sched.num_steps)


def coef_table(sched: dlib.DiffusionSchedule, steps: int | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(timesteps, coefs) on the host: strided η=0 DDIM when ``steps`` asks
    for it, else the full DDPM process (fixed_small variance)."""
    host = sched.to("cpu")
    if strided_ddim(steps, sched):
        return dlib.ddim_coef_table(host, steps)
    return dlib.ddpm_coef_table(host)


def step_noise(steps: int | None, sched: dlib.DiffusionSchedule,
               given: torch.Tensor | None, shape: tuple,
               generator: torch.Generator | None,
               device: torch.device) -> torch.Tensor | None:
    """The per-step noise of a reverse process on samples of ``shape``:
    None for DDIM; for DDPM ``given`` (handed in through ``draws=``) or one
    standard normal draw per step from ``generator``,
    (num_steps, *shape)."""
    if strided_ddim(steps, sched):
        return None
    if given is not None:
        return given
    return torch.randn((sched.num_steps,) + tuple(shape), generator=generator,
                       device=device)


# ---------------------------------------------------------------------------
# kernel B over an action U-Net (DP, DPVAE)
# ---------------------------------------------------------------------------

def fused_weight_dtype(name: str) -> torch.dtype:
    """The weight type kernel B runs for an agent's ``fused_dtype``
    (``"bfloat16"``, ``"float16"`` or ``"float32"``, the JAX kernel's
    three); anything else raises with the reason."""
    dtype = getattr(torch, str(name), None)
    if dtype not in kunet.WEIGHT_DTYPES:
        raise ValueError(f"fused_dtype must be float16, float32 or bfloat16 "
                         f"(kernel B's weight types), not {name!r}")
    return dtype


class ActionSampler:
    """The reverse process of an action U-Net through kernel B
    (``fused_unet1d_ddim_sample``, with weights of ``fused_dtype``) on the
    card and its plain twin on the CPU: strided η=0 DDIM when
    ``inference_steps`` is below the train steps, else the full DDPM
    process with per-step noise. The coefficient table is made once on the
    device; the kernel's packed weights are made at the first sample on the
    card and dropped by ``weights_changed``."""

    def __init__(self, sched: dlib.DiffusionSchedule,
                 inference_steps: int | None, device: torch.device,
                 fused_dtype: str = "bfloat16"):
        self.sched = sched
        self.inference_steps = inference_steps
        self.device = device
        self.fused_dtype = fused_dtype
        self._table = None
        self._pack = None

    def check(self, net: ConditionalUnet1D, pred_horizon: int,
              fused_dtype: str) -> None:
        """Raise, with the reason, for what kernel B cannot run."""
        dtype = fused_weight_dtype(fused_dtype)
        kunet.check_supported(net, pred_horizon, dtype)
        kunet.choose_tile(net, pred_horizon, dtype=dtype)

    def weights_changed(self) -> None:
        self._pack = None

    def table(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._table is None:
            ts, coefs = coef_table(self.sched, self.inference_steps)
            self._table = (ts.to(self.device, torch.int32),
                           coefs.to(self.device))
        return self._table

    def __call__(self, net: ConditionalUnet1D, cond: torch.Tensor,
                 x_init: torch.Tensor,
                 generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
        """cond (B, Dc), x_init (B, T, A) → (B, T, A) normalized actions;
        ``noise`` (num_steps, B, T, A) is DDPM's per-step noise, drawn from
        ``generator`` when not given."""
        sched = self.sched
        clip = sched.clip_range if sched.clip_sample else 1e9
        noise = step_noise(self.inference_steps, sched, noise,
                           tuple(x_init.shape), generator, x_init.device)
        on_card = x_init.device.type == "cuda"
        # the weight type matters on the card only (the CPU runs the twin)
        dtype = (fused_weight_dtype(self.fused_dtype) if on_card
                 else kunet.WEIGHT_DTYPE)
        if on_card and self._pack is None:
            self._pack = kunet.pack_params(net, dtype).to(x_init.device)
        ts, coefs = self.table()
        return kunet.fused_unet1d_ddim_sample(
            net, cond, x_init, ts, coefs, noise, clip_range=clip,
            packed=self._pack if on_card else None, dtype=dtype)
