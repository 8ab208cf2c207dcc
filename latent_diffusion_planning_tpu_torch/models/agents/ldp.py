"""LDP agent, inference only: latent diffusion planner + inverse dynamics.

Counterpart of ``latent_diffusion_planning_tpu/models/agents/ldp.py``'s
inference path (``sample_fast``, ``sample_action``, ``_plan``,
``_idm_decode``). Per decision: encode the camera frame with the VAE,
reverse-diffuse a latent plan with the planner U-Net (kernel B on the card),
decode actions from consecutive latent pairs with the MLP IDM (kernel A),
unnormalize.

Where the JAX agent drops to its XLA scan when a kernel cannot take a
configuration, this agent raises on CUDA with the reason: DDPM planning
(the U-Net kernel is DDIM only), a plan length not divisible by the U-Net
stride, or an IDM the MLP kernel does not take (non-swish cond MLP, no
LayerNorm, fixed time features); on the CPU those run through the plain
versions. Non-ε prediction raises on every device: the samplers' coefficient
tables assume ε, and no config of the port uses another.

Random draws come from a ``torch.Generator``; ``draws=`` hands in the
planner's initial sample (B, pred_horizon, obs_dim) and the IDM's
(B·pred_horizon, action_dim) instead, so tests can pass JAX's draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch

from ... import resolve_device
from ...ops import diffusion as dlib
from ...ops import normalize as nz
from ...ops.kernels import diffusion_mlp as kmlp
from ...ops.kernels import diffusion_unet1d as kunet
from ..nets.mlp import MLPDiffusion
from ..nets.unet1d import ConditionalUnet1D
from ..vae import KLVAE
from . import common


@dataclass(frozen=True)
class LDPConfig:
    lowdim_obs: tuple
    rgb_obs: tuple
    obs_horizon: int
    pred_horizon: int
    action_horizon: int
    obs_dim: int
    action_dim: int
    vae_feature_dim: int
    planner_inference_steps: int | None
    idm_inference_steps: int | None
    fused_dtype: str = "bfloat16"


def _ddim(steps: int | None, sched: dlib.DiffusionSchedule) -> bool:
    return bool(steps and steps < sched.num_steps)


class LDPAgent:
    """Planner U-Net + MLP IDM + frozen VAE encoder, on one device."""

    def __init__(self, planner: ConditionalUnet1D, idm: MLPDiffusion,
                 vae: KLVAE, planner_sched: dlib.DiffusionSchedule,
                 idm_sched: dlib.DiffusionSchedule, obs_normalization: Any,
                 config: LDPConfig, device: torch.device):
        self.device = device
        self.planner = planner.to(device).eval()
        self.idm = idm.to(device).eval()
        self.vae = vae.to(device).eval()
        self.planner_sched = planner_sched
        self.idm_sched = idm_sched
        self.obs_normalization = nz.stats_to_tensors(obs_normalization, device)
        self.config = config
        self.codec = common.VAECodec(self.vae, config.rgb_obs)
        for name, sched in (("planner", planner_sched), ("idm", idm_sched)):
            if sched.prediction_type != "epsilon":
                raise ValueError(f"the {name} samplers need ε prediction, "
                                 f"got {sched.prediction_type!r}")
        # coefficient tables on the agent's device, made once: a table made
        # on the host per decision would cost a host-to-device copy that
        # waits for the stream
        self._tables: dict = {}
        self._planner_packed = self._idm_packed = None
        if device.type == "cuda":
            self._check_kernels()
            self._planner_packed = kunet.pack_params(self.planner).to(device)
            self._idm_packed = kmlp.pack_params(self.idm).to(device)

    def _check_kernels(self) -> None:
        """Raise, with the reason, for a configuration the kernels cannot
        run (called when the agent is built on the card)."""
        c = self.config
        if not _ddim(c.planner_inference_steps, self.planner_sched):
            raise ValueError("the fused planner sampler is DDIM only: set "
                             "planner_inference_steps < the train steps")
        if getattr(torch, c.fused_dtype) != kunet.WEIGHT_DTYPE:
            raise ValueError("the fused planner kernel reads bf16 weights")
        kunet.check_supported(self.planner, c.pred_horizon)
        kmlp.check_supported(self.idm)

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, config: Mapping, shape_meta: Mapping, *, seed: int = 0,
               device: torch.device | str | None = None) -> "LDPAgent":
        """Build from an agent config dict (``configs.BENCH_AGENT``'s keys)
        with weights drawn from ``seed``."""
        dev = resolve_device(device)
        torch.manual_seed(seed)
        obs_dim, action_dim = common.obs_dims(
            shape_meta, config["rgb_obs"], config["lowdim_obs"],
            config["vae_feature_dim"])
        oh = config["obs_horizon"]
        p = config["planner"]
        planner = ConditionalUnet1D(
            obs_dim, obs_dim * oh, p.get("diffusion_step_embed_dim", 256),
            p.get("down_dims", (256, 512, 1024)), p.get("kernel_size", 5),
            p.get("n_groups", 8))
        i = config["idm_net"]
        idm = MLPDiffusion(2 * obs_dim, action_dim, i.get("time_dim", 64),
                           i.get("cond_hidden_dims", (128, 128)),
                           i.get("cond_activation", "swish"),
                           i.get("n_blocks", 3), i.get("hidden_dim", 256),
                           i.get("use_layer_norm", True),
                           i.get("dropout_rate"), i.get("learnable_time", True))
        vae = KLVAE(**config.get("vae", {}))
        return cls.assemble(planner, idm, vae, config, obs_dim, action_dim,
                            dev)

    @classmethod
    def assemble(cls, planner, idm, vae, config: Mapping, obs_dim: int,
                 action_dim: int, device: torch.device) -> "LDPAgent":
        cfg = LDPConfig(
            lowdim_obs=tuple(config["lowdim_obs"]),
            rgb_obs=tuple(config["rgb_obs"]),
            obs_horizon=config["obs_horizon"],
            pred_horizon=config["pred_horizon"],
            action_horizon=config["action_horizon"],
            obs_dim=obs_dim, action_dim=action_dim,
            vae_feature_dim=config["vae_feature_dim"],
            planner_inference_steps=config.get("planner_inference_steps"),
            idm_inference_steps=config.get("idm_inference_steps"),
            fused_dtype=config.get("fused_dtype", "bfloat16"))
        sched = lambda n, pt: dlib.DiffusionSchedule.create(
            n, "squaredcos_cap_v2", prediction_type=pt, clip_sample=True)
        return cls(planner, idm, vae,
                   sched(config.get("planner_n_diffusion_steps", 100),
                         config.get("planner_prediction_type", "epsilon")),
                   sched(config.get("idm_n_diffusion_steps", 100),
                         config.get("idm_prediction_type", "epsilon")),
                   config["obs_normalization"], cfg, device)

    # ------------------------------------------------------------------
    def _clip(self, sched: dlib.DiffusionSchedule) -> float:
        return sched.clip_range if sched.clip_sample else 1e9

    def _table(self, sched: dlib.DiffusionSchedule, steps: int | None):
        """(timesteps, coefs) of the strided DDIM process when ``steps`` asks
        for one, else of the full DDPM process, on the agent's device."""
        key = (id(sched), steps)
        if key not in self._tables:
            ts, coefs = (dlib.ddim_coef_table(sched, steps)
                         if _ddim(steps, sched) else dlib.ddpm_coef_table(sched))
            self._tables[key] = (ts.to(self.device, torch.int32),
                                 coefs.to(self.device))
        return self._tables[key]

    def _randn(self, shape, generator: torch.Generator | None) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    def _idm_decode(self, pairs: torch.Tensor, x_init: torch.Tensor,
                    generator: torch.Generator | None) -> torch.Tensor:
        """Reverse-diffuse actions for (s, s') pairs → (N, A), normalized."""
        c, sched = self.config, self.idm_sched
        shape = (pairs.shape[0], c.action_dim)
        ts, coefs = self._table(sched, c.idm_inference_steps)
        noise = None
        if not _ddim(c.idm_inference_steps, sched):
            noise = self._randn((ts.shape[0],) + shape, generator)
        return kmlp.fused_mlp_diffusion_sample(
            self.idm, pairs, x_init, ts, coefs, noise,
            clip_range=self._clip(sched), packed=self._idm_packed)

    def _plan(self, cond: torch.Tensor, x_init: torch.Tensor,
              generator: torch.Generator | None) -> torch.Tensor:
        """Reverse-diffuse a latent plan (B, pred_horizon, obs_dim)."""
        c, sched = self.config, self.planner_sched
        if not _ddim(c.planner_inference_steps, sched):
            # DDPM planning: plain loop (CPU only; refused on the card)
            noise = self._randn((sched.num_steps,) + tuple(x_init.shape),
                                generator)
            return dlib.sample_ddpm(
                sched, lambda x, t: self.planner(x, t, cond), x_init, noise)
        ts, coefs = self._table(sched, c.planner_inference_steps)
        return kunet.fused_unet1d_ddim_sample(
            self.planner, cond, x_init, ts, coefs,
            clip_range=self._clip(sched), packed=self._planner_packed)

    def _prepare_eval_batch(self, batch: Mapping) -> dict:
        batch = {k: {kk: vv.to(self.device) for kk, vv in v.items()}
                 if isinstance(v, Mapping) else v.to(self.device)
                 for k, v in batch.items()}
        if "actions" in batch:
            batch = common.prepare_batch(batch, self.obs_normalization)
        else:
            batch = {"obs": nz.normalize_tree(batch["obs"],
                                              self.obs_normalization["obs"])}
        batch["obs"] = self.codec.encode_obs(batch["obs"],
                                             self.obs_normalization)
        return batch

    def _obs_cond(self, batch_obs) -> torch.Tensor:
        return common.obs_cond_from_features(batch_obs, self.config.rgb_obs,
                                             self.config.lowdim_obs)

    @torch.no_grad()
    def sample_fast(self, batch: Mapping, generator: torch.Generator | None = None,
                    draws: Mapping | None = None) -> torch.Tensor:
        """Plan and decode the full pred_horizon chunk → (B, pred_horizon, A)
        unnormalized actions (no plan-image decode)."""
        c = self.config
        obs_emb = self._obs_cond(self._prepare_eval_batch(batch)["obs"])
        B = obs_emb.shape[0]
        cond = obs_emb[:, :c.obs_horizon].reshape(B, -1)
        draws = draws or {}
        x_plan = draws.get("planner")
        x_plan = (self._randn((B, c.pred_horizon, c.obs_dim), generator)
                  if x_plan is None else torch.as_tensor(
                      x_plan, dtype=torch.float32, device=self.device))
        pred_plan = self._plan(cond, x_plan, generator)
        plan = torch.cat([obs_emb[:, c.obs_horizon - 1:c.obs_horizon],
                          pred_plan], 1)
        pairs = common.consecutive_pairs(plan)
        x_idm = draws.get("idm")
        x_idm = (self._randn((pairs.shape[0], c.action_dim), generator)
                 if x_idm is None else torch.as_tensor(
                     x_idm, dtype=torch.float32, device=self.device))
        acts = self._idm_decode(pairs, x_idm, generator).reshape(
            B, -1, c.action_dim)
        return nz.unnormalize_actions(acts, self.obs_normalization)

    @torch.no_grad()
    def sample_action(self, batch: Mapping,
                      generator: torch.Generator | None = None,
                      draws: Mapping | None = None) -> torch.Tensor:
        """IDM-only decode over consecutive observed latents."""
        obs_emb = self._obs_cond(self._prepare_eval_batch(batch)["obs"])
        B = obs_emb.shape[0]
        pairs = common.consecutive_pairs(obs_emb)
        x_idm = (draws or {}).get("idm")
        x_idm = (self._randn((pairs.shape[0], self.config.action_dim),
                             generator)
                 if x_idm is None else torch.as_tensor(
                     x_idm, dtype=torch.float32, device=self.device))
        acts = self._idm_decode(pairs, x_idm, generator).reshape(
            B, -1, self.config.action_dim)
        return nz.unnormalize_actions(acts, self.obs_normalization)
