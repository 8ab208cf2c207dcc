"""Diffusion Policy over frozen VAE latents (the DPVAE baseline).

Counterpart of ``latent_diffusion_planning_tpu/models/agents/dp_vae.py``:
an action-sequence U-Net conditioned on the flat observation features of
the first ``obs_horizon`` steps (the frozen VAE's normalized latents of the
camera frame, then the lowdim keys), no learned vision encoder. Training is
the ε-loss on the window's normalized actions, one backward pass through
autograd, then Adam with the warmup-cosine schedule and an EMA copy
(``train/state.py``); with ``random_shift`` > 0 the raw image keys of a
batch are shifted DrQ-style first. Sampling runs the reverse process
through kernel B on the card (``common.ActionSampler``): strided DDIM when
``inference_steps`` is below ``n_diffusion_steps``, else the full DDPM
process with per-step noise (``dp_repr_agent.yaml``'s ``inference_steps:
null``, 100 steps); it keeps the first ``action_horizon`` actions;
``use_ema`` samples the EMA weights.

On the card a configuration kernel B does not take raises, with the reason,
when the agent is built: a ``fused_dtype`` other than bfloat16, float16 or
float32 (kernel B's three weight types), a prediction horizon not divisible by the U-Net's stride, or widths the
kernel refuses. On the CPU DDIM and DDPM run through the kernel's plain
twin.

Random draws come from a ``torch.Generator``; ``draws=`` hands them in
instead, so tests can pass JAX's: ``t`` (B,) and ``noise`` (B, T, A) for
the loss, ``shift`` {image key: (B·T, 2)} for the random shift, ``x_init``
(B, pred_horizon, A) and, under DDPM, ``step_noise`` (n_diffusion_steps,
B, pred_horizon, A) for sampling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch

from ... import resolve_device
from ...ops import augment
from ...ops import diffusion as dlib
from ...ops import normalize as nz
from ...train.state import TrainState, global_norm
from ..nets.unet1d import ConditionalUnet1D, unet_from_config
from ..vae import KLVAE
from ...parallel import mesh as meshlib
from . import common


@dataclass(frozen=True)
class DPVAEConfig:
    lowdim_obs: tuple
    rgb_obs: tuple
    obs_horizon: int
    pred_horizon: int
    action_horizon: int
    obs_dim: int
    action_dim: int
    vae_feature_dim: int
    inference_steps: int | None
    random_shift: int = 0
    use_ema: bool = False
    fused_dtype: str = "bfloat16"
    action_loss_weights: tuple | None = None


# optimizer keys of the agent config and their defaults (JAX ``create``)
OPTIMIZER_DEFAULTS = dict(lr=1e-4, end_lr=1e-6, warmup_steps=1000,
                          decay_steps=500_000, ema_decay=0.75)


class DPVAEAgent:
    """Action U-Net + frozen VAE, on one device."""

    LOSS_KEYS = ("loss",)

    def __init__(self, planner: ConditionalUnet1D, vae: KLVAE,
                 sched: dlib.DiffusionSchedule, obs_normalization: Any,
                 config: DPVAEConfig, device: torch.device,
                 optimizer: Mapping | None = None):
        self.device = device
        self.planner = planner.to(device).eval()
        self.vae = vae.to(device).eval().requires_grad_(False)
        self.sched = sched.to(device)
        self.obs_normalization = nz.stats_to_tensors(obs_normalization, device)
        self.config = config
        self.codec = common.VAECodec(self.vae, config.rgb_obs,
                                     config.vae_feature_dim)
        o = {**OPTIMIZER_DEFAULTS, **(optimizer or {})}
        self.planner_state = TrainState(
            self.planner, lr=o["lr"], end_lr=o["end_lr"],
            warmup_steps=o["warmup_steps"], decay_steps=o["decay_steps"],
            ema_decay=o["ema_decay"])
        self.sampler = common.ActionSampler(self.sched,
                                            config.inference_steps, device,
                                            config.fused_dtype)
        if device.type == "cuda":
            self._check_kernels()

    def weights_changed(self) -> None:
        """Drop kernel B's packed weights; the next sample on the card
        repacks from the current ones."""
        self.sampler.weights_changed()

    def _check_kernels(self) -> None:
        self.sampler.check(self._sampling_net(), self.config.pred_horizon,
                           self.config.fused_dtype)

    def _sampling_net(self) -> ConditionalUnet1D:
        ema = self.planner_state.ema
        return ema if self.config.use_ema and ema is not None else self.planner

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, config: Mapping, shape_meta: Mapping, *, seed: int = 0,
               device: torch.device | str | None = None) -> "DPVAEAgent":
        """Build from an agent config dict (the ``agent`` of
        ``configs.lift_dp_vae_train_config()``) with weights drawn from
        ``seed``."""
        dev = resolve_device(device)
        generator = torch.Generator().manual_seed(seed)
        obs_dim, action_dim = common.obs_dims(
            shape_meta, config["rgb_obs"], config["lowdim_obs"],
            config.get("vae_feature_dim", 16))
        planner = unet_from_config(
            config["planner"], action_dim,
            obs_dim * config.get("obs_horizon", 1), generator)
        vae = KLVAE(**config.get("vae", {}), generator=generator)
        return cls.assemble(planner, vae, config, obs_dim, action_dim, dev)

    @classmethod
    def assemble(cls, planner, vae, config: Mapping, obs_dim: int,
                 action_dim: int, device: torch.device) -> "DPVAEAgent":
        cfg = DPVAEConfig(
            lowdim_obs=tuple(config["lowdim_obs"]),
            rgb_obs=tuple(config["rgb_obs"]),
            obs_horizon=config.get("obs_horizon", 1),
            pred_horizon=config.get("pred_horizon", 16),
            action_horizon=config.get("action_horizon", 8),
            obs_dim=obs_dim, action_dim=action_dim,
            vae_feature_dim=config.get("vae_feature_dim", 16),
            inference_steps=config.get("inference_steps"),
            random_shift=config.get("random_shift", 0),
            use_ema=bool(config.get("use_ema", False)),
            fused_dtype=config.get("fused_dtype", "bfloat16"),
            action_loss_weights=common.check_action_weights(
                config.get("action_loss_weights"), action_dim))
        sched = dlib.DiffusionSchedule.create(
            config.get("n_diffusion_steps", 100), "squaredcos_cap_v2",
            prediction_type=config.get("prediction_type", "epsilon"),
            clip_sample=True)
        return cls(planner, vae, sched, config["obs_normalization"], cfg,
                   device, {k: config[k] for k in OPTIMIZER_DEFAULTS
                            if k in config})

    # ------------------------------------------------------------------
    def _obs_cond(self, batch_obs: Mapping) -> torch.Tensor:
        """Flat (B, obs_horizon · obs_dim) conditioning."""
        c = self.config
        window = {k: v[:, :c.obs_horizon] for k, v in batch_obs.items()}
        emb = common.obs_cond_from_features(window, c.rgb_obs, c.lowdim_obs)
        return emb.reshape(emb.shape[0], -1)

    def _draw(self, draws: Mapping | None, key: str, make) -> torch.Tensor:
        given = (draws or {}).get(key)
        if given is None:
            return make()
        t = torch.as_tensor(given, device=self.device)
        return t.float() if t.is_floating_point() else t.long()

    def _to_device(self, batch: Mapping) -> dict:
        out = {"obs": {k: v.to(self.device) for k, v in batch["obs"].items()}}
        if "actions" in batch:
            out["actions"] = batch["actions"].to(self.device)
        return out

    def _augment(self, batch: dict, generator, draws) -> dict:
        """DrQ random shift of every raw image key (B, T, H, W, C)."""
        pad = self.config.random_shift
        if pad <= 0:
            return batch
        obs = dict(batch["obs"])
        shifts = (draws or {}).get("shift") or {}
        for key, v in obs.items():
            if v.ndim == 5:
                B, T, H, W, C = v.shape
                obs[key] = augment.random_shift(
                    v.reshape(-1, H, W, C), pad, shifts.get(key),
                    generator).reshape(B, T, H, W, C)
        return {**batch, "obs": obs}

    def _prepare(self, batch: Mapping) -> dict:
        batch = common.prepare_batch(batch, self.obs_normalization)
        batch["obs"] = self.codec.encode_obs(batch["obs"],
                                             self.obs_normalization)
        return batch

    def _loss(self, batch: Mapping, generator=None, draws=None):
        """(loss, metrics) on a prepared batch; detached metrics."""
        actions = batch["actions"]
        obs_emb = self._obs_cond(batch["obs"])
        B = actions.shape[0]
        t = self._draw(draws, "t", lambda: meshlib.draw_rows(
            lambda m: torch.randint(0, self.sched.num_steps, (m,),
                                    generator=generator, device=self.device),
            B))
        noise = self._draw(draws, "noise", lambda: meshlib.draw_rows(
            lambda m: torch.randn((m, *actions.shape[1:]),
                                  generator=generator, device=self.device),
            B))
        noisy = self.sched.add_noise(actions, noise, t)
        pred = self.planner(noisy, t, obs_emb)
        sq = torch.square(pred - self.sched.training_target(actions, noise, t))
        loss = torch.mean(common.weight_action_channels(
            sq, self.config.action_loss_weights))
        metrics = dict(loss=loss.detach(), obs_min=obs_emb.min(),
                       obs_max=obs_emb.max(), obs_mean=obs_emb.mean(),
                       obs_std=obs_emb.std(correction=0),
                       action_min=actions.min(), action_max=actions.max())
        metrics.update(common.debug_obs_metrics(batch["obs"]))
        return loss, metrics

    def backward(self, batch: Mapping, generator=None, draws=None) -> dict:
        """Forward and one backward pass on a raw batch; leaves the
        gradients in the planner's ``.grad``."""
        batch = self._prepare(self._augment(self._to_device(batch), generator,
                                            draws))
        loss, metrics = self._loss(batch, generator, draws)
        loss.backward()
        metrics["g_norm"] = global_norm(
            [p.grad for p in self.planner.parameters()]).to(self.device)
        return metrics

    def apply_gradients(self) -> dict:
        state = self.planner_state
        metrics = {"planner_lr": state.lr(), "planner_step": state.step}
        state.apply_gradients()
        self.weights_changed()
        return metrics

    def update(self, batch: Mapping, step: int = 0,
               generator: torch.Generator | None = None,
               draws: Mapping | None = None) -> dict:
        """One train step on a raw batch ``{"obs": {k: (B, H, ...)},
        "actions": (B, T, A)}``; updates the agent in place and returns its
        metrics. ``step`` is taken for the Workspace's call and unused."""
        metrics = self.backward(batch, generator, draws)
        metrics.update(self.apply_gradients())
        return metrics

    @torch.no_grad()
    def get_metrics(self, batch: Mapping,
                    generator: torch.Generator | None = None,
                    draws: Mapping | None = None) -> dict:
        return self._loss(self._prepare(self._to_device(batch)), generator,
                          draws)[1]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample(self, batch: Mapping, generator: torch.Generator | None = None,
               draws: Mapping | None = None) -> tuple[torch.Tensor, dict]:
        """((B, action_horizon, A) unnormalized actions, obs metrics)."""
        c = self.config
        batch = self._to_device(batch)
        if "actions" in batch:
            batch = common.prepare_batch(batch, self.obs_normalization)
        else:
            batch = {"obs": nz.normalize_tree(batch["obs"],
                                              self.obs_normalization["obs"])}
        obs_emb = self._obs_cond(self.codec.encode_obs(
            batch["obs"], self.obs_normalization))
        B = obs_emb.shape[0]
        x_init = self._draw(draws, "x_init", lambda: torch.randn(
            (B, c.pred_horizon, c.action_dim), generator=generator,
            device=self.device))
        acts = self.sampler(self._sampling_net(), obs_emb, x_init, generator,
                            self._draw(draws, "step_noise", lambda: None))
        acts = nz.unnormalize_actions(acts[:, :c.action_horizon],
                                      self.obs_normalization)
        metrics = dict(obs_min=obs_emb.min(), obs_max=obs_emb.max(),
                       obs_mean=obs_emb.mean(),
                       obs_std=obs_emb.std(correction=0))
        return acts, metrics

    def sample_action(self, batch: Mapping,
                      generator: torch.Generator | None = None,
                      draws: Mapping | None = None) -> torch.Tensor:
        return self.sample(batch, generator, draws)[0]

    # ------------------------------------------------------------------
    def get_params(self) -> dict:
        """``{planner_params, planner_ema_params, vae_params}`` state dicts
        (the frozen VAE rides along, so a snapshot is self-contained)."""
        ema = self.planner_state.ema
        return {"planner_params": self.planner.state_dict(),
                "planner_ema_params": None if ema is None else ema.state_dict(),
                "vae_params": self.vae.state_dict()}

    def state_dict(self) -> dict:
        return {"planner": self.planner_state.state_dict(),
                "vae": self.vae.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.planner_state.load_state_dict(state["planner"])
        self.vae.load_state_dict(state["vae"])
        self.weights_changed()
