"""Diffusion Policy (the DP baseline): ResNet encoders trained end to end
with an action U-Net.

Counterpart of ``latent_diffusion_planning_tpu/models/agents/dp.py``: one
ResNet encoder per camera (or one ``shared`` by all), whose features of the
first ``obs_horizon`` frames, followed by the lowdim keys, condition a
``ConditionalUnet1D`` that denoises the window's normalized actions.
Training is the ε-loss, one backward pass through both nets, then Adam with
the warmup-cosine schedule on each net's own train state and an EMA copy of
each (``planner_ema_decay``, ``encoder_ema_decay``); no clip. Sampling runs
the reverse process through kernel B on the card (``common.ActionSampler``):
strided DDIM when ``inference_steps`` is below ``n_diffusion_steps``, else
the full DDPM process with per-step noise (``dp_agent.yaml``'s
``inference_steps: null``, 100 steps); it keeps the first
``action_horizon`` actions;
``use_ema`` samples the EMA encoders and planner. The encoders and the
planner compute in fp32 with TF32 off (``fp32_math``), in training and in
sampling.

The condition's order is the JAX one: features before lowdim; the lowdim
keys joined on the last axis, then flattened time-major; with a shared
encoder the cameras' frames joined on the time axis before they are
encoded.

On the card a configuration kernel B does not take raises, with the reason,
when the agent is built. On the CPU DDIM and DDPM run through the kernel's
plain twin.

Random draws come from a ``torch.Generator``; ``draws=`` hands them in
instead, so tests can pass JAX's: ``t`` (B,) and ``noise`` (B, T, A) for
the loss, ``x_init`` (B, pred_horizon, A) and, under DDPM, ``step_noise``
(n_diffusion_steps, B, pred_horizon, A) for sampling.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import torch

from ... import resolve_device
from ...ops import diffusion as dlib
from ...ops import normalize as nz
from ...train.state import TrainState, global_norm
from ...utils.precision import fp32_math
from ..nets.resnet import ResNetEncoder
from ..nets.unet1d import ConditionalUnet1D, unet_from_config
from ...parallel import mesh as meshlib
from . import common


@dataclass(frozen=True)
class DPConfig:
    lowdim_obs: tuple
    rgb_obs: tuple
    obs_horizon: int
    pred_horizon: int
    action_horizon: int
    action_dim: int
    cond_dim: int
    inference_steps: int | None
    shared_encoder: bool = False
    use_ema: bool = False
    fused_dtype: str = "bfloat16"
    action_loss_weights: tuple | None = None


# optimizer keys of the agent config and their defaults (JAX ``create``)
OPTIMIZER_DEFAULTS = dict(lr=1e-4, end_lr=1e-6, warmup_steps=1000,
                          decay_steps=500_000, planner_ema_decay=0.75,
                          encoder_ema_decay=0.75)


def build_nets(config: Mapping, shape_meta: Mapping,
               generator: torch.Generator | None = None
               ) -> tuple[ConditionalUnet1D, dict[str, ResNetEncoder]]:
    """The action U-Net and the encoders (per ``rgb_obs`` key, or
    ``shared``) with weights drawn from ``generator``."""
    rgb_obs = tuple(config["rgb_obs"])
    shared = bool(config.get("shared_encoder", False))
    shapes = shape_meta["all_shapes"]
    enc_cfg = {k: v for k, v in config.get("encoder", {}).items()
               if k not in ("_target_", "_defer_")}
    encoders = {key: ResNetEncoder(shapes[rgb_obs[0] if key == "shared"
                                          else key], **enc_cfg,
                                   generator=generator)
                for key in (["shared"] if shared else rgb_obs)}
    if shared:
        vision = encoders["shared"].n_features * len(rgb_obs)
    else:
        vision = sum(e.n_features for e in encoders.values())
    lowdim = sum(math.prod(shapes[k]) for k in config["lowdim_obs"])
    cond_dim = (vision + lowdim) * config.get("obs_horizon", 1)
    planner = unet_from_config(config["planner"], int(shape_meta["ac_dim"]),
                               cond_dim, generator)
    return planner, encoders


class DPAgent:
    """Action U-Net + trained ResNet encoders, on one device."""

    LOSS_KEYS = ("loss",)

    def __init__(self, planner: ConditionalUnet1D,
                 encoders: Mapping[str, ResNetEncoder],
                 sched: dlib.DiffusionSchedule, obs_normalization: Any,
                 config: DPConfig, device: torch.device,
                 optimizer: Mapping | None = None):
        self.device = device
        self.planner = planner.to(device).eval()
        self.encoders = {k: e.to(device).eval() for k, e in encoders.items()}
        self.sched = sched.to(device)
        self.obs_normalization = nz.stats_to_tensors(obs_normalization, device)
        self.config = config
        o = {**OPTIMIZER_DEFAULTS, **(optimizer or {})}
        sched_kw = dict(lr=o["lr"], end_lr=o["end_lr"],
                        warmup_steps=o["warmup_steps"],
                        decay_steps=o["decay_steps"])
        self.planner_state = TrainState(self.planner, **sched_kw,
                                        ema_decay=o["planner_ema_decay"])
        self.encoder_states = {
            k: TrainState(e, **sched_kw, ema_decay=o["encoder_ema_decay"])
            for k, e in self.encoders.items()}
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

    def _sampling_encoders(self) -> dict:
        if not self.config.use_ema:
            return self.encoders
        return {k: s.inference_module for k, s in self.encoder_states.items()}

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, config: Mapping, shape_meta: Mapping, *, seed: int = 0,
               device: torch.device | str | None = None) -> "DPAgent":
        """Build from an agent config dict (the ``agent`` of
        ``configs.lift_dp_train_config()``) with weights drawn from
        ``seed``."""
        dev = resolve_device(device)
        planner, encoders = build_nets(config, shape_meta,
                                       torch.Generator().manual_seed(seed))
        return cls.assemble(planner, encoders, config, shape_meta, dev)

    @classmethod
    def assemble(cls, planner, encoders, config: Mapping,
                 shape_meta: Mapping, device: torch.device) -> "DPAgent":
        action_dim = int(shape_meta["ac_dim"])
        cfg = DPConfig(
            lowdim_obs=tuple(config["lowdim_obs"]),
            rgb_obs=tuple(config["rgb_obs"]),
            obs_horizon=config.get("obs_horizon", 1),
            pred_horizon=config.get("pred_horizon", 16),
            action_horizon=config.get("action_horizon", 8),
            action_dim=action_dim, cond_dim=planner.global_cond_dim,
            inference_steps=config.get("inference_steps"),
            shared_encoder=bool(config.get("shared_encoder", False)),
            use_ema=bool(config.get("use_ema", False)),
            fused_dtype=config.get("fused_dtype", "bfloat16"),
            action_loss_weights=common.check_action_weights(
                config.get("action_loss_weights"), action_dim))
        sched = dlib.DiffusionSchedule.create(
            config.get("n_diffusion_steps", 100), "squaredcos_cap_v2",
            prediction_type=config.get("prediction_type", "epsilon"),
            clip_sample=True)
        return cls(planner, encoders, sched, config["obs_normalization"], cfg,
                   device, {k: config[k] for k in OPTIMIZER_DEFAULTS
                            if k in config})

    # ------------------------------------------------------------------
    def _obs_cond(self, encoders: Mapping[str, ResNetEncoder],
                  batch_obs: Mapping) -> torch.Tensor:
        """Flat (B, obs_horizon · (vision + lowdim)) conditioning of
        normalized obs."""
        c = self.config
        oh = c.obs_horizon
        low = [batch_obs[k][:, :oh].float() for k in c.lowdim_obs]
        ref = batch_obs[(c.rgb_obs or c.lowdim_obs)[0]]
        B = ref.shape[0]
        low = (torch.cat(low, -1).reshape(B, -1) if low
               else ref.new_zeros((B, 0)))
        if c.shared_encoder:
            imgs = torch.cat([batch_obs[k][:, :oh] for k in c.rgb_obs], 1)
            feats = encoders["shared"](
                imgs.reshape((-1,) + imgs.shape[-3:])).reshape(B, -1)
        else:
            feats = torch.cat([encoders[k](batch_obs[k][:, :oh].reshape(
                (-1,) + batch_obs[k].shape[-3:])).reshape(B, -1)
                for k in c.rgb_obs], -1)
        return torch.cat([feats, low], -1)

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

    def _loss(self, batch: Mapping, generator=None, draws=None):
        """(loss, metrics) on a prepared batch; detached metrics."""
        actions = batch["actions"]
        obs_emb = self._obs_cond(self.encoders, batch["obs"])
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
        emb = obs_emb.detach()
        metrics = dict(loss=loss.detach(), obs_min=emb.min(),
                       obs_max=emb.max(), obs_mean=emb.mean(),
                       obs_std=emb.std(correction=0),
                       action_min=actions.min(), action_max=actions.max())
        return loss, metrics

    def _params(self) -> list[torch.nn.Parameter]:
        return [*self.planner.parameters(),
                *(p for e in self.encoders.values() for p in e.parameters())]

    def backward(self, batch: Mapping, generator=None, draws=None) -> dict:
        """Forward and one backward pass on a raw batch; leaves the
        gradients in the planner's and the encoders' ``.grad``."""
        batch = common.prepare_batch(self._to_device(batch),
                                     self.obs_normalization)
        with fp32_math():
            loss, metrics = self._loss(batch, generator, draws)
            loss.backward()
        metrics["g_norm"] = global_norm(
            [p.grad for p in self._params()]).to(self.device)
        return metrics

    def apply_gradients(self) -> dict:
        state = self.planner_state
        metrics = {"planner_lr": state.lr(), "planner_step": state.step}
        state.apply_gradients()
        for k, st in self.encoder_states.items():
            metrics[f"enc_{k}_lr"] = st.lr()
            st.apply_gradients()
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
        batch = common.prepare_batch(self._to_device(batch),
                                     self.obs_normalization)
        with fp32_math():
            return self._loss(batch, generator, draws)[1]

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
        with fp32_math():
            obs_emb = self._obs_cond(self._sampling_encoders(), batch["obs"])
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
        metrics.update(common.debug_obs_metrics(batch["obs"]))
        return acts, metrics

    def sample_action(self, batch: Mapping,
                      generator: torch.Generator | None = None,
                      draws: Mapping | None = None) -> torch.Tensor:
        return self.sample(batch, generator, draws)[0]

    # ------------------------------------------------------------------
    def get_params(self) -> dict:
        """The JAX keys: ``planner_params``, ``encoder_params``
        ``{<key>_params}`` and their ``_ema_`` twins, as state dicts."""
        ema = lambda s: None if s.ema is None else s.ema.state_dict()
        return {
            "planner_params": self.planner.state_dict(),
            "encoder_params": {f"{k}_params": e.state_dict()
                               for k, e in self.encoders.items()},
            "planner_ema_params": ema(self.planner_state),
            "encoder_ema_params": {f"{k}_params": ema(s)
                                   for k, s in self.encoder_states.items()}}

    def state_dict(self) -> dict:
        return {"planner": self.planner_state.state_dict(),
                "encoders": {k: s.state_dict()
                             for k, s in self.encoder_states.items()}}

    def load_state_dict(self, state: Mapping) -> None:
        self.planner_state.load_state_dict(state["planner"])
        for k, s in self.encoder_states.items():
            s.load_state_dict(state["encoders"][k])
        self.weights_changed()
