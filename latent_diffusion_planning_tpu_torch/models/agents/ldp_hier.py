"""Hierarchical LDP: a strided latent planner and a chunk-decoding U-Net IDM.

Counterpart of ``latent_diffusion_planning_tpu/models/agents/ldp_hier.py``.
The planner learns every ``idm_horizon``-th future latent of the window
(``obs_emb[:, obs_horizon::k]``); the IDM is a ``ConditionalUnet1D`` that
denoises a (k, A) action chunk conditioned on a strided (s, s') latent pair
(s at ``obs_horizon - 1``, ``+ k``, ...), weighted by
``action_loss_weights``. At inference the planner plans P = pred_horizon //
idm_horizon latents; the IDM decodes one chunk between each two consecutive
latents of [current latent, plan[:action_horizon]], and the chunks are
flattened (B·K, k, A) → (B, K·k, A). The rest (VAE, normalization,
training step, gates, mixed batches, persistence) is ``LDPAgent``'s.

Both nets of the recipe and of ``ldp_hier_agent.yaml`` set ``downsample:
false``. On the card both run through kernel B, which takes U-Nets that do
not downsample, with strided DDIM or, when the inference steps are unset
or not below the train steps (the yaml's default), the full DDPM process
with per-step noise; on the CPU through its plain twin. The yaml's planner
[256,512,1024] at the window's 16 latents (``sample_plan_stats``)
outgrows a block's shared memory; kernel B runs it in its wide mode
(fp32 buffers and skips in global memory). Where the JAX agent samples a
net with its XLA scan, this agent raises on CUDA, with the reason, when it
is built: a ``fused_dtype`` other than bfloat16, float16 or float32, or widths
kernel B refuses even in wide mode.

Behaviours of the JAX agent reproduced as they are:
- ``pred_plan[:, :action_horizon]`` keeps all P latents when P is shorter
  (the recipe: 2 < 4), so a decision decodes P chunks, P·k = 8 actions, of
  which the engine runs the first ``action_horizon``;
- the planner's targets start at ``obs_horizon`` (latents 1 and 5 for k 4)
  while the IDM's pairs start at ``obs_horizon - 1`` (0 → 4, 4 → 8);
- ``sample_action`` decodes consecutive, not strided, pairs of the window's
  latents, and ``sample_plan_stats`` (``LDPAgent``'s) plans at the window's
  length against its consecutive future latents;
- ``sample_viz``'s ``plan_mse`` compares the P-long plan with the window's
  latents after ``obs_horizon``, which only lines up when the window holds
  ``obs_horizon + P`` steps (JAX fails to broadcast otherwise; this agent
  raises, saying so).

Random draws come from a ``torch.Generator``; ``draws=`` hands them in
instead, so tests can pass JAX's: for sampling ``planner`` (B, P, obs_dim)
and ``idm`` (B·K, k, A), and under DDPM ``planner_step_noise`` (num_steps,
B, P, obs_dim) and ``idm_step_noise`` (num_steps, B·K, k, A); for the
losses ``plan_t`` (B,), ``plan_noise`` (B,
P', obs_dim) with P' the strided targets, ``idm_t`` (B·K,) and
``idm_noise`` (B·K, k, A) with K the chunks of the IDM's batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

from ...ops import normalize as nz
from ...ops.kernels import diffusion_unet1d as kunet
from ..nets.unet1d import unet_from_config
from ..vae import KLVAE
from . import common
from .ldp import LDPAgent, LDPConfig


@dataclass(frozen=True)
class LDPHierConfig(LDPConfig):
    # actions one IDM sample decodes: a chunk between latents k apart
    idm_horizon: int = 4


class LDPHierAgent(LDPAgent):
    """Strided planner U-Net + chunk IDM U-Net + frozen VAE, on one device."""

    @classmethod
    def _create(cls, config: Mapping, shape_meta: Mapping, dev: torch.device,
                generator: torch.Generator) -> "LDPHierAgent":
        obs_dim, action_dim = common.obs_dims(
            shape_meta, config["rgb_obs"], config["lowdim_obs"],
            config["vae_feature_dim"])
        planner = unet_from_config(config["planner"], obs_dim,
                                   obs_dim * config["obs_horizon"], generator)
        # chunk-decoding U-Net: sample (N, idm_horizon, A), cond (N, 2D)
        idm = unet_from_config(config["idm_net"], action_dim, 2 * obs_dim,
                               generator)
        vae = KLVAE(**config.get("vae", {}), generator=generator)
        return cls.assemble(planner, idm, vae, config, obs_dim, action_dim,
                            dev)

    @classmethod
    def _agent_config(cls, config: Mapping, obs_dim: int,
                      action_dim: int) -> LDPHierConfig:
        k = config.get("idm_horizon", 4)
        if config["action_horizon"] % k:
            raise ValueError("action_horizon must be a multiple of idm_horizon "
                             f"({config['action_horizon']} % {k})")
        base = super()._agent_config(config, obs_dim, action_dim)
        return LDPHierConfig(**vars(base), idm_horizon=k)

    @property
    def plan_length(self) -> int:
        """P: the latents one decision plans."""
        return self.config.pred_horizon // self.config.idm_horizon

    def _check_kernels(self) -> None:
        """Raise, with the reason, for what kernel B cannot run on either
        net at any length it is called at (called when the agent is built
        on the card): the planner plans P latents a decision and the
        window's ``pred_horizon`` in ``sample_plan_stats``; a net that does
        not downsample keeps full-length skips, so its shared memory grows
        with the length (where no tile fits, kernel B's wide mode moves the
        fp32 buffers and skips, and where need be the operand buffers, to
        global memory)."""
        c = self.config
        dtype = common.fused_weight_dtype(c.fused_dtype)
        for name, lengths in (("planner", (self.plan_length, c.pred_horizon)),
                              ("idm", (c.idm_horizon,))):
            for T in lengths:
                kunet.check_supported(getattr(self, name), T, dtype)
                kunet.choose_tile(getattr(self, name), T, dtype=dtype)

    # ------------------------------------------------------------------
    # losses (strided)
    # ------------------------------------------------------------------
    def _plan_target(self, obs_emb: torch.Tensor) -> torch.Tensor:
        c = self.config
        return obs_emb[:, c.obs_horizon::c.idm_horizon]

    def _idm_target(self, actions: torch.Tensor) -> torch.Tensor:
        """The window's actions after ``obs_horizon - 1`` as (B·K, k, A)
        chunks."""
        c = self.config
        return actions[:, c.obs_horizon - 1:-1].reshape(
            -1, c.idm_horizon, actions.shape[-1])

    def _strided_pairs(self, obs_emb: torch.Tensor) -> torch.Tensor:
        """(s, s') latent pairs ``idm_horizon`` apart → (B·K, 2D)."""
        oh, k = self.config.obs_horizon, self.config.idm_horizon
        pairs = torch.cat([obs_emb[:, oh - 1:-1:k], obs_emb[:, oh - 1 + k::k]],
                          -1)
        return pairs.reshape(-1, pairs.shape[-1])

    def _idm_loss(self, net, obs_emb: torch.Tensor, actions: torch.Tensor,
                  t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        sched = self.idm_sched
        acts = self._idm_target(actions)
        noisy = sched.add_noise(acts, noise, t)
        pred = net(noisy, t, self._strided_pairs(obs_emb))
        sq = torch.square(pred - sched.training_target(acts, noise, t))
        return torch.mean(common.weight_action_channels(
            sq, self.config.action_loss_weights))

    # ------------------------------------------------------------------
    # inference (chunked IDM)
    # ------------------------------------------------------------------
    def _idm_decode(self, pairs, x_init, generator, draws=None):
        raise NotImplementedError("LDP-hier decodes action chunks with a "
                                  "U-Net IDM (_decode_chunks)")

    def _decode_chunks(self, latents: torch.Tensor,
                       generator: torch.Generator | None,
                       draws: Mapping | None) -> torch.Tensor:
        """A chunk between each two consecutive latents of (B, L, D) →
        (B, (L-1)·k, A) unnormalized actions."""
        c = self.config
        pairs = common.consecutive_pairs(latents)
        x_init = self._draw(draws, "idm", lambda: self._randn(
            (pairs.shape[0], c.idm_horizon, c.action_dim), generator))
        chunks = self._unet_sample("idm", c.idm_inference_steps, pairs,
                                   x_init, generator, draws)
        return nz.unnormalize_actions(
            chunks.reshape(latents.shape[0], -1, c.action_dim),
            self.obs_normalization)

    def _plan_decision(self, obs_emb: torch.Tensor,
                       generator: torch.Generator | None,
                       draws: Mapping | None):
        """(the P-long plan, [current latent, plan[:action_horizon]])."""
        c = self.config
        B = obs_emb.shape[0]
        cond = obs_emb[:, :c.obs_horizon].reshape(B, -1)
        x_plan = self._draw(draws, "planner", lambda: self._randn(
            (B, self.plan_length, c.obs_dim), generator))
        pred_plan = self._plan(cond, x_plan, generator, draws)
        plan = torch.cat([obs_emb[:, c.obs_horizon - 1:c.obs_horizon],
                          pred_plan[:, :c.action_horizon]], 1)
        return pred_plan, plan

    @torch.no_grad()
    def sample_fast(self, batch: Mapping, generator: torch.Generator | None = None,
                    draws: Mapping | None = None) -> torch.Tensor:
        """Plan P strided latents and decode a chunk toward each → (B, P·k,
        A) unnormalized actions (no plan-image decode)."""
        obs_emb = self._obs_cond(self._prepare_eval_batch(batch)["obs"])
        _, plan = self._plan_decision(obs_emb, generator, draws)
        return self._decode_chunks(plan, generator, draws)

    @torch.no_grad()
    def sample_action(self, batch: Mapping,
                      generator: torch.Generator | None = None,
                      draws: Mapping | None = None) -> torch.Tensor:
        """IDM-only decode of a chunk between each two consecutive observed
        latents → (B, (H-1)·k, A)."""
        obs_emb = self._obs_cond(self._prepare_eval_batch(batch)["obs"])
        return self._decode_chunks(obs_emb, generator, draws)

    @torch.no_grad()
    def sample_viz(self, batch: Mapping,
                   generator: torch.Generator | None = None,
                   draws: Mapping | None = None) -> tuple[torch.Tensor, dict]:
        """``sample_fast``'s actions and {plan_viz: the planned latents
        decoded to images, each repeated ``idm_horizon`` times (B, P·k, h,
        w, c) in [-1, 1]; plan (B, P+1, obs_dim); plan_mse when the window
        extends past obs_horizon}."""
        c = self.config
        obs_emb = self._obs_cond(self._prepare_eval_batch(batch)["obs"])
        pred_plan, plan = self._plan_decision(obs_emb, generator, draws)
        frames = self.codec.decode_features(plan[:, 1:], self.obs_normalization)
        metrics = {"plan_viz": frames.repeat_interleave(c.idm_horizon, 1),
                   "plan": plan}
        acts = self._decode_chunks(plan, generator, draws)
        if obs_emb.shape[1] > c.obs_horizon:
            future = obs_emb[:, c.obs_horizon:]
            if future.shape[1] != pred_plan.shape[1]:
                raise ValueError(
                    "plan_mse compares the plan with the window's next "
                    "latents, as the JAX agent does: the window must hold "
                    f"obs_horizon + {pred_plan.shape[1]} steps, not "
                    f"{obs_emb.shape[1]}")
            metrics["plan_mse"] = torch.mean(torch.square(pred_plan - future))
        return acts, metrics
