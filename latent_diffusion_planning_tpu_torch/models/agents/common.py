"""Shared agent machinery: observation conditioning and the VAE latent codec.

Counterpart of ``latent_diffusion_planning_tpu/models/agents/common.py``. A
batch is ``{"obs": {key: (B, H, ...)}, "actions": (B, T, A)}``; the
conditioning vector per timestep is the rgb features first, then the lowdim
keys, in config order.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import torch

from ...ops import normalize as nz
from ..vae import KLVAE


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
    """Moves rgb obs into normalized latent space with a frozen VAE."""

    def __init__(self, vae: KLVAE, rgb_obs: Sequence[str]):
        self.vae = vae
        self.rgb_obs = tuple(rgb_obs)   # e.g. ("latent_agentview_image",)

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
