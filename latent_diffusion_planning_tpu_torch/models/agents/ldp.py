"""LDP agent: latent diffusion planner + inverse dynamics, training and
inference.

Counterpart of ``latent_diffusion_planning_tpu/models/agents/ldp.py``.
Inference (``sample_fast``, ``sample_action``, ``sample_plan_stats``): encode
the camera frame with the VAE, reverse-diffuse a latent plan with the
planner U-Net (kernel B on the card), decode actions from consecutive latent
pairs with the MLP IDM (kernel A), unnormalize. ``sample_viz`` also decodes
the executed part of the plan back to images with the VAE's decoder, and
``sample_action_from_plan`` decodes actions toward a given plan.

Training (``update``): the planner's ε-loss on the window's future latents
and the IDM's on its (s, s') pairs, summed, one backward pass through
autograd, then each net's own optimizer step (``train/state.py``: Adam,
warmup-cosine, optional clipping, EMA). ``update_mixed`` takes a second
batch: the planner trains on the first (expert) one, the IDM on the second
(mixed) one's encoded observations and actions. The VAE stays frozen. The
kernels read the nets from packed copies of their weights; an update marks
those stale and they are rebuilt at the next sample on the card.

Both nets sample with strided DDIM when their ``*_inference_steps`` are
below the train steps, else with the full ancestral DDPM process (the JAX
package's default configurations: ``null``, 100 steps), and both ways run
through the kernels on the card: the planner through B, the IDM through A,
DDPM with one noise draw per step. Kernel B runs the planner with the
weight type ``fused_dtype`` names (bfloat16, float16 or float32, the JAX
kernel's three), kernel A every MLP IDM the JAX package builds (any cond MLP and
activation, fixed or learnable time features, LayerNorm or none, any hidden
width up to 1024, any condition width). Where the JAX agent drops to its
XLA scan when a kernel cannot take a configuration, this agent raises on
CUDA with the reason (a plan length not divisible by the U-Net stride, a
``fused_dtype`` of none of those types); on the CPU those run through the plain
versions. Every
prediction type (ε, sample, v) runs through the kernels: their coefficient
tables hold x0 = clip(c1 (cx x - c2 y)) for the net's output y
(``ops/diffusion.py``); the ALOHA recipe's planner predicts x0.

Random draws come from a ``torch.Generator``; ``draws=`` hands them in
instead, so tests can pass JAX's: for sampling the planner's initial sample
``planner`` (B, pred_horizon, obs_dim) and the IDM's ``idm`` (one row per
decoded pair), and under DDPM their per-step noise ``planner_step_noise``
(num_steps, B, pred_horizon, obs_dim) and ``idm_step_noise`` (num_steps,
N, action_dim); for the losses ``plan_t`` (B,), ``plan_noise`` (B,
H-obs_horizon, obs_dim), ``idm_t`` (N,) and ``idm_noise`` (N, action_dim)
with N the transition pairs of the IDM's batch (the mixed one in
``update_mixed``).
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
from ...train.state import TrainState, global_norm
from ..nets.mlp import MLPDiffusion
from ..nets.unet1d import ConditionalUnet1D, unet_from_config
from ..vae import KLVAE
from ...parallel import mesh as meshlib
from . import common


_TRAIN_FIELDS = ("use_planner", "use_idm", "alpha_planner", "alpha_idm",
                 "update_planner_every", "update_idm_every",
                 "update_idm_after", "update_planner_until",
                 "update_planner_after")


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
    # training (LDPAgent.create's keyword defaults in the JAX package)
    use_planner: bool = True
    use_idm: bool = True
    alpha_planner: float = 1.0
    alpha_idm: float = 1.0
    action_loss_weights: tuple | None = None
    update_planner_every: int = 1
    update_idm_every: int = 1
    update_idm_after: int = 0
    update_planner_until: int = -1
    update_planner_after: int = 0


# optimizer keys of the agent config and their defaults (JAX ``create``)
OPTIMIZER_DEFAULTS = dict(lr=1e-4, end_lr=1e-6, idm_lr=1e-4, idm_end_lr=1e-6,
                          warmup_steps=1000, decay_steps=500_000,
                          grad_clip=None, ema_decay=0.0)


class LDPAgent:
    """Planner U-Net + MLP IDM + frozen VAE, on one device."""

    LOSS_KEYS = ("plan_loss", "idm_loss", "loss")

    def __init__(self, planner: ConditionalUnet1D, idm: MLPDiffusion,
                 vae: KLVAE, planner_sched: dlib.DiffusionSchedule,
                 idm_sched: dlib.DiffusionSchedule, obs_normalization: Any,
                 config: LDPConfig, device: torch.device,
                 optimizer: Mapping | None = None):
        self.device = device
        self.planner = planner.to(device).eval()
        self.idm = idm.to(device).eval()
        self.vae = vae.to(device).eval().requires_grad_(False)
        # schedule tables on the device: the losses index them per step
        self.planner_sched = planner_sched.to(device)
        self.idm_sched = idm_sched.to(device)
        self.obs_normalization = nz.stats_to_tensors(obs_normalization, device)
        self.config = config
        self.codec = common.VAECodec(self.vae, config.rgb_obs,
                                     config.vae_feature_dim)
        # coefficient tables on the agent's device, made once: a table made
        # on the host per decision would cost a host-to-device copy that
        # waits for the stream
        self._tables: dict = {}
        o = {**OPTIMIZER_DEFAULTS, **(optimizer or {})}
        train = lambda net, lr, end_lr: TrainState(
            net, lr=lr, end_lr=end_lr, warmup_steps=o["warmup_steps"],
            decay_steps=o["decay_steps"], grad_clip=o["grad_clip"],
            ema_decay=o["ema_decay"])
        self.planner_state = train(self.planner, o["lr"], o["end_lr"])
        self.idm_state = train(self.idm, o["idm_lr"], o["idm_end_lr"])
        # the kernels' packed weights, built at the first sample on the card
        # and dropped whenever the weights change (weights_changed)
        self._packs: dict = {}
        if device.type == "cuda":
            self._check_kernels()

    def weights_changed(self) -> None:
        """Drop the kernels' packed weights; the next sample on the card
        repacks from the current ones."""
        self._packs.clear()

    def _inference_net(self, name: str):
        """The net the samplers run: the EMA copy when one is tracked."""
        state = getattr(self, f"{name}_state")
        return state.ema if state.ema is not None else getattr(self, name)

    def _packed(self, name: str):
        """The named net's packed weights for its kernel (B for a U-Net, A
        for the MLP), on the card; None on the CPU."""
        if self.device.type != "cuda":
            return None
        if name not in self._packs:
            net = self._inference_net(name)
            if isinstance(net, ConditionalUnet1D):
                pack = kunet.pack_params(net, self._fused_dtype())
            else:
                pack = kmlp.pack_params(net)
            self._packs[name] = pack.to(self.device)
        return self._packs[name]

    def _check_kernels(self) -> None:
        """Raise, with the reason, for a configuration the kernels cannot
        run (called when the agent is built on the card)."""
        c = self.config
        dtype = common.fused_weight_dtype(c.fused_dtype)
        kunet.check_supported(self.planner, c.pred_horizon, dtype)
        kunet.choose_tile(self.planner, c.pred_horizon, dtype=dtype)
        kmlp.check_supported(self.idm)

    def _fused_dtype(self) -> torch.dtype:
        """Kernel B's weight type (``fused_dtype``) on the card; bf16 names
        the default where the plain twin runs."""
        if self.device.type != "cuda":
            return kunet.WEIGHT_DTYPE
        return common.fused_weight_dtype(self.config.fused_dtype)

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, config: Mapping, shape_meta: Mapping, *, seed: int = 0,
               device: torch.device | str | None = None) -> "LDPAgent":
        """Build from an agent config dict (``configs.BENCH_AGENT``'s keys,
        plus the JAX ``create``'s training keywords: ``lr``, ``warmup_steps``,
        ``update_*_every`` and so on) with weights drawn from ``seed``."""
        return cls._create(config, shape_meta, resolve_device(device),
                           torch.Generator().manual_seed(seed))

    @classmethod
    def _create(cls, config: Mapping, shape_meta: Mapping, dev: torch.device,
                generator: torch.Generator) -> "LDPAgent":
        obs_dim, action_dim = common.obs_dims(
            shape_meta, config["rgb_obs"], config["lowdim_obs"],
            config["vae_feature_dim"])
        oh = config["obs_horizon"]
        planner = unet_from_config(config["planner"], obs_dim, obs_dim * oh,
                                   generator)
        i = config["idm_net"]
        idm = MLPDiffusion(2 * obs_dim, action_dim, i.get("time_dim", 64),
                           i.get("cond_hidden_dims", (128, 128)),
                           i.get("cond_activation", "swish"),
                           i.get("n_blocks", 3), i.get("hidden_dim", 256),
                           i.get("use_layer_norm", True),
                           i.get("dropout_rate"), i.get("learnable_time", True),
                           generator, i.get("compute_dtype", "float32"))
        vae = KLVAE(**config.get("vae", {}), generator=generator)
        return cls.assemble(planner, idm, vae, config, obs_dim, action_dim,
                            dev)

    @classmethod
    def assemble(cls, planner, idm, vae, config: Mapping, obs_dim: int,
                 action_dim: int, device: torch.device) -> "LDPAgent":
        cfg = cls._agent_config(config, obs_dim, action_dim)
        sched = lambda n, pt: dlib.DiffusionSchedule.create(
            n, "squaredcos_cap_v2", prediction_type=pt, clip_sample=True)
        return cls(planner, idm, vae,
                   sched(config.get("planner_n_diffusion_steps", 100),
                         config.get("planner_prediction_type", "epsilon")),
                   sched(config.get("idm_n_diffusion_steps", 100),
                         config.get("idm_prediction_type", "epsilon")),
                   config["obs_normalization"], cfg, device,
                   {k: config[k] for k in OPTIMIZER_DEFAULTS if k in config})

    @classmethod
    def _agent_config(cls, config: Mapping, obs_dim: int,
                      action_dim: int) -> LDPConfig:
        return LDPConfig(
            lowdim_obs=tuple(config["lowdim_obs"]),
            rgb_obs=tuple(config["rgb_obs"]),
            obs_horizon=config["obs_horizon"],
            pred_horizon=config["pred_horizon"],
            action_horizon=config["action_horizon"],
            obs_dim=obs_dim, action_dim=action_dim,
            vae_feature_dim=config["vae_feature_dim"],
            planner_inference_steps=config.get("planner_inference_steps"),
            idm_inference_steps=config.get("idm_inference_steps"),
            fused_dtype=config.get("fused_dtype", "bfloat16"),
            action_loss_weights=common.check_action_weights(
                config.get("action_loss_weights"), action_dim),
            **{f: config[f] for f in _TRAIN_FIELDS if f in config})

    # ------------------------------------------------------------------
    def _clip(self, sched: dlib.DiffusionSchedule) -> float:
        return sched.clip_range if sched.clip_sample else 1e9

    def _table(self, sched: dlib.DiffusionSchedule, steps: int | None):
        """(timesteps, coefs) of the strided DDIM process when ``steps`` asks
        for one, else of the full DDPM process, on the agent's device."""
        key = (id(sched), steps)
        if key not in self._tables:
            ts, coefs = common.coef_table(sched, steps)
            self._tables[key] = (ts.to(self.device, torch.int32),
                                 coefs.to(self.device))
        return self._tables[key]

    def _randn(self, shape, generator: torch.Generator | None) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    def _draw(self, draws: Mapping | None, key: str, make) -> torch.Tensor:
        """``draws[key]`` on the device (float32, or int64 for timesteps)
        when handed in, else ``make()``."""
        given = (draws or {}).get(key)
        if given is None:
            return make()
        t = torch.as_tensor(given, device=self.device)
        return t.float() if t.is_floating_point() else t.long()

    def _idm_decode(self, pairs: torch.Tensor, x_init: torch.Tensor,
                    generator: torch.Generator | None,
                    draws: Mapping | None = None) -> torch.Tensor:
        """Reverse-diffuse actions for (s, s') pairs → (N, A), normalized,
        through kernel A (DDPM's per-step noise ``draws["idm_step_noise"]``
        when handed in)."""
        c, sched = self.config, self.idm_sched
        ts, coefs = self._table(sched, c.idm_inference_steps)
        noise = common.step_noise(
            c.idm_inference_steps, sched,
            self._draw(draws, "idm_step_noise", lambda: None),
            (pairs.shape[0], c.action_dim), generator, self.device)
        return kmlp.fused_mlp_diffusion_sample(
            self._inference_net("idm"), pairs, x_init, ts, coefs, noise,
            clip_range=self._clip(sched), packed=self._packed("idm"))

    def _unet_sample(self, name: str, steps: int | None, cond: torch.Tensor,
                     x_init: torch.Tensor, generator: torch.Generator | None,
                     draws: Mapping | None = None) -> torch.Tensor:
        """Reverse-diffuse x_init (B, T, C) with the U-Net ``name`` on
        condition ``cond`` through kernel B: strided DDIM, or DDPM with
        per-step noise (``draws[f"{name}_step_noise"]`` when handed in)."""
        sched = getattr(self, f"{name}_sched")
        ts, coefs = self._table(sched, steps)
        noise = common.step_noise(
            steps, sched, self._draw(draws, f"{name}_step_noise",
                                     lambda: None),
            tuple(x_init.shape), generator, self.device)
        return kunet.fused_unet1d_ddim_sample(
            self._inference_net(name), cond, x_init, ts, coefs, noise,
            clip_range=self._clip(sched), packed=self._packed(name),
            dtype=self._fused_dtype())

    def _plan(self, cond: torch.Tensor, x_init: torch.Tensor,
              generator: torch.Generator | None,
              draws: Mapping | None = None) -> torch.Tensor:
        """Reverse-diffuse a latent plan as long as x_init (B, T,
        obs_dim)."""
        return self._unet_sample("planner", self.config.planner_inference_steps,
                                 cond, x_init, generator, draws)

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
        x_plan = self._draw(draws, "planner", lambda: self._randn(
            (B, c.pred_horizon, c.obs_dim), generator))
        pred_plan = self._plan(cond, x_plan, generator, draws)
        plan = torch.cat([obs_emb[:, c.obs_horizon - 1:c.obs_horizon],
                          pred_plan], 1)
        pairs = common.consecutive_pairs(plan)
        x_idm = self._draw(draws, "idm", lambda: self._randn(
            (pairs.shape[0], c.action_dim), generator))
        acts = self._idm_decode(pairs, x_idm, generator, draws).reshape(
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
        x_idm = self._draw(draws, "idm", lambda: self._randn(
            (pairs.shape[0], self.config.action_dim), generator))
        acts = self._idm_decode(pairs, x_idm, generator, draws).reshape(
            B, -1, self.config.action_dim)
        return nz.unnormalize_actions(acts, self.obs_normalization)

    @torch.no_grad()
    def sample_plan_stats(self, batch: Mapping,
                          generator: torch.Generator | None = None,
                          draws: Mapping | None = None) -> dict:
        """Sampled-plan MSE against the window's true future latents, the
        persistence baseline (repeat the current latent) and the target's
        variance: a plan_mse far above plan_target_var says the reverse
        process does not contract to the data."""
        c = self.config
        obs_emb = self._obs_cond(self._prepare_eval_batch(batch)["obs"])
        B = obs_emb.shape[0]
        cond = obs_emb[:, :c.obs_horizon].reshape(B, -1)
        target = obs_emb[:, c.obs_horizon:]
        x_plan = self._draw(draws, "planner",
                            lambda: self._randn(target.shape, generator))
        plan = self._plan(cond, x_plan, generator, draws)
        return {
            "plan_mse": torch.mean(torch.square(plan - target)),
            "plan_mse_persist": torch.mean(torch.square(
                obs_emb[:, c.obs_horizon - 1:c.obs_horizon] - target)),
            "plan_target_var": torch.var(target, correction=0),
        }

    @torch.no_grad()
    def sample_viz(self, batch: Mapping,
                   generator: torch.Generator | None = None,
                   draws: Mapping | None = None) -> tuple[torch.Tensor, dict]:
        """Plan, decode the current latent and the plan's first
        ``action_horizon`` latents to images, and the actions between them →
        ((B, action_horizon, A) unnormalized actions, {plan_viz (B, ah+1, h,
        w, c) in [-1, 1], plan (B, ah+1, obs_dim), and plan_mse against the
        window's future latents when the window extends past obs_horizon}).
        """
        c = self.config
        obs_emb = self._obs_cond(self._prepare_eval_batch(batch)["obs"])
        B = obs_emb.shape[0]
        cond = obs_emb[:, :c.obs_horizon].reshape(B, -1)
        x_plan = self._draw(draws, "planner", lambda: self._randn(
            (B, c.pred_horizon, c.obs_dim), generator))
        pred_plan = self._plan(cond, x_plan, generator, draws)
        plan = torch.cat([obs_emb[:, c.obs_horizon - 1:c.obs_horizon],
                          pred_plan[:, :c.action_horizon]], 1)
        metrics = {"plan_viz": self.codec.decode_features(
            plan, self.obs_normalization), "plan": plan}
        pairs = common.consecutive_pairs(plan)
        x_idm = self._draw(draws, "idm", lambda: self._randn(
            (pairs.shape[0], c.action_dim), generator))
        acts = self._idm_decode(pairs, x_idm, generator, draws).reshape(
            B, -1, c.action_dim)
        if obs_emb.shape[1] > c.obs_horizon:
            metrics["plan_mse"] = torch.mean(torch.square(
                pred_plan - obs_emb[:, c.obs_horizon:]))
        return nz.unnormalize_actions(acts, self.obs_normalization), metrics

    @torch.no_grad()
    def sample_action_from_plan(self, batch: Mapping, next_plan: torch.Tensor,
                                generator: torch.Generator | None = None,
                                draws: Mapping | None = None) -> torch.Tensor:
        """Actions from each observed latent toward ``next_plan`` (B, H,
        obs_dim) normalized latents → (B, H, A) unnormalized."""
        start = self._obs_cond(self._prepare_eval_batch(batch)["obs"])
        B = start.shape[0]
        pair = torch.cat([start, next_plan.to(self.device).float()], -1)
        pairs = pair.reshape(-1, pair.shape[-1])
        x_idm = self._draw(draws, "idm", lambda: self._randn(
            (pairs.shape[0], self.config.action_dim), generator))
        acts = self._idm_decode(pairs, x_idm, generator, draws).reshape(
            B, -1, self.config.action_dim)
        return nz.unnormalize_actions(acts, self.obs_normalization)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _plan_target(self, obs_emb: torch.Tensor) -> torch.Tensor:
        """The latents the planner learns to plan: the window's future."""
        return obs_emb[:, self.config.obs_horizon:]

    def _idm_target(self, actions: torch.Tensor) -> torch.Tensor:
        """The actions the IDM learns to decode: one per transition pair,
        (N, A)."""
        oh = self.config.obs_horizon
        return actions[:, oh - 1:-1].reshape(-1, actions.shape[-1])

    def _plan_loss(self, net, obs_emb: torch.Tensor, t: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
        oh, sched = self.config.obs_horizon, self.planner_sched
        target = self._plan_target(obs_emb)
        noisy = sched.add_noise(target, noise, t)
        cond = obs_emb[:, :oh].reshape(obs_emb.shape[0], -1)
        pred = net(noisy, t, cond)
        return torch.mean(torch.square(
            pred - sched.training_target(target, noise, t)))

    def _idm_loss(self, net, obs_emb: torch.Tensor, actions: torch.Tensor,
                  t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        oh, sched = self.config.obs_horizon, self.idm_sched
        pairs = common.transition_pairs(obs_emb, oh)
        acts = self._idm_target(actions)
        noisy = sched.add_noise(acts, noise, t)
        pred = net(pairs, noisy, t)
        sq = torch.square(pred - sched.training_target(acts, noise, t))
        return torch.mean(common.weight_action_channels(
            sq, self.config.action_loss_weights))

    def _loss_draws(self, obs_emb: torch.Tensor, actions: torch.Tensor,
                    generator: torch.Generator | None,
                    draws: Mapping | None) -> dict:
        """Each loss's timesteps and noise: handed in, or drawn; the
        planner's sized by its target, the IDM's by its batch's targets."""
        plan_shape = self._plan_target(obs_emb).shape
        idm_shape = self._idm_target(actions).shape
        # under meshlib.sharded_draws: the global batch's draws, this rank's
        # rows
        randint = lambda hi, n: meshlib.draw_rows(lambda m: torch.randint(
            0, hi, (m,), generator=generator, device=self.device), n)
        randn = lambda shape: meshlib.draw_rows(lambda m: self._randn(
            (m, *shape[1:]), generator), shape[0])
        return {
            "plan_t": self._draw(draws, "plan_t", lambda: randint(
                self.planner_sched.num_steps, plan_shape[0])),
            "plan_noise": self._draw(draws, "plan_noise",
                                     lambda: randn(plan_shape)),
            "idm_t": self._draw(draws, "idm_t", lambda: randint(
                self.idm_sched.num_steps, idm_shape[0])),
            "idm_noise": self._draw(draws, "idm_noise",
                                    lambda: randn(idm_shape)),
        }

    def _loss(self, batch: Mapping, use_planner: bool, use_idm: bool,
              generator: torch.Generator | None = None,
              draws: Mapping | None = None,
              mixed_batch: Mapping | None = None):
        """(summed loss, metrics) on a prepared (normalized, encoded) batch
        and, when given, a prepared mixed batch that the IDM reads instead;
        the metrics are detached tensors on the device."""
        c = self.config
        obs_emb = self._obs_cond(batch["obs"])
        idm_batch = batch if mixed_batch is None else mixed_batch
        idm_emb = (obs_emb if mixed_batch is None
                   else self._obs_cond(mixed_batch["obs"]))
        actions = idm_batch["actions"]
        d = self._loss_draws(obs_emb, actions, generator, draws)
        metrics = dict(
            emb_min=obs_emb.min(), emb_max=obs_emb.max(),
            emb_mean=obs_emb.mean(), emb_std=obs_emb.std(correction=0),
            action_min=actions.min(), action_max=actions.max())
        metrics.update(common.debug_obs_metrics(batch["obs"]))
        zero = torch.zeros((), device=self.device)
        plan_loss = idm_loss = zero
        if use_planner:
            plan_loss = c.alpha_planner * self._plan_loss(
                self.planner, obs_emb, d["plan_t"], d["plan_noise"])
        if use_idm:
            idm_loss = c.alpha_idm * self._idm_loss(
                self.idm, idm_emb, actions, d["idm_t"], d["idm_noise"])
        loss = plan_loss + idm_loss
        metrics.update(plan_loss=plan_loss.detach(),
                       idm_loss=idm_loss.detach(), loss=loss.detach())
        return loss, metrics

    def _gates(self, step: int) -> tuple[bool, bool]:
        c = self.config
        use_planner = bool(c.use_planner) and step % c.update_planner_every == 0
        use_planner = use_planner and (c.update_planner_until < 0
                                       or step < c.update_planner_until)
        use_planner = use_planner and step >= c.update_planner_after
        use_idm = (bool(c.use_idm) and step % c.update_idm_every == 0
                   and step >= c.update_idm_after)
        return use_planner, use_idm

    def _prepare_train_batch(self, batch: Mapping) -> dict:
        batch = common.prepare_batch(
            {"obs": {k: v.to(self.device) for k, v in batch["obs"].items()},
             "actions": batch["actions"].to(self.device)},
            self.obs_normalization)
        batch["obs"] = self.codec.encode_obs(batch["obs"],
                                             self.obs_normalization)
        return batch

    def backward(self, batch: Mapping, use_planner: bool, use_idm: bool,
                 generator: torch.Generator | None = None,
                 draws: Mapping | None = None,
                 mixed_batch: Mapping | None = None) -> dict:
        """Forward and one backward pass of the summed loss (the IDM's on
        ``mixed_batch`` when given); leaves the gradients in the nets'
        ``.grad``. Returns the metrics."""
        mixed = (None if mixed_batch is None
                 else self._prepare_train_batch(mixed_batch))
        loss, metrics = self._loss(self._prepare_train_batch(batch),
                                   use_planner, use_idm, generator, draws,
                                   mixed)
        nets = [n for n, use in ((self.planner, use_planner),
                                 (self.idm, use_idm)) if use]
        if nets:
            loss.backward()
        metrics["g_norm"] = global_norm(
            [p.grad for n in nets for p in n.parameters()]).to(self.device)
        return metrics

    def apply_gradients(self, use_planner: bool, use_idm: bool) -> dict:
        """Each used net's own optimizer step; the kernels' packs go
        stale."""
        metrics = {}
        for name, use in (("planner", use_planner), ("idm", use_idm)):
            if use:
                state = getattr(self, f"{name}_state")
                metrics[f"{name}_lr"] = state.lr()
                metrics[f"{name}_step"] = state.step
                state.apply_gradients()
        if use_planner or use_idm:
            self.weights_changed()
        return metrics

    def update(self, batch: Mapping, step: int,
               generator: torch.Generator | None = None,
               draws: Mapping | None = None,
               mixed_batch: Mapping | None = None) -> dict:
        """One train step on a raw batch ``{"obs": {k: (B, H, ...)},
        "actions": (B, H', A)}`` (and the IDM's ``mixed_batch``) at global
        ``step`` (the gates read it); updates the agent in place and
        returns its metrics."""
        use_planner, use_idm = self._gates(step)
        metrics = self.backward(batch, use_planner, use_idm, generator, draws,
                                mixed_batch)
        metrics.update(self.apply_gradients(use_planner, use_idm))
        return metrics

    def update_mixed(self, batch: Mapping, mixed_batch: Mapping, step: int,
                     generator: torch.Generator | None = None,
                     draws: Mapping | None = None) -> dict:
        """One train step with two streams: the planner on ``batch``, the
        IDM on ``mixed_batch`` (its encoded observations and its actions;
        ``action_min``/``action_max`` report its actions)."""
        return self.update(batch, step, generator, draws, mixed_batch)

    @torch.no_grad()
    def get_metrics(self, batch: Mapping,
                    generator: torch.Generator | None = None,
                    draws: Mapping | None = None) -> dict:
        """The losses' metrics without an update."""
        c = self.config
        return self._loss(self._prepare_train_batch(batch),
                          bool(c.use_planner), bool(c.use_idm), generator,
                          draws)[1]

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def get_params(self) -> dict:
        """``{planner_params, idm_params, vae_params}`` state dicts (the
        frozen VAE rides along, so a snapshot is self-contained)."""
        params = {}
        if self.config.use_planner:
            params["planner_params"] = self.planner.state_dict()
        if self.config.use_idm:
            params["idm_params"] = self.idm.state_dict()
        params["vae_params"] = self.vae.state_dict()
        return params

    def state_dict(self) -> dict:
        """The full train state (params, Adam moments, EMA, steps, VAE)."""
        return {"planner": self.planner_state.state_dict(),
                "idm": self.idm_state.state_dict(),
                "vae": self.vae.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.planner_state.load_state_dict(state["planner"])
        self.idm_state.load_state_dict(state["idm"])
        self.vae.load_state_dict(state["vae"])
        self.weights_changed()
