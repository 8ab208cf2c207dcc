"""Training workspace: data and agent from a config dict, the train loop,
offline and closed-loop eval, snapshots.

Counterpart of ``latent_diffusion_planning_tpu/train/loop.py``'s
``Workspace``. The config is a plain dict (the keys of
``configs.bench_train_config()``, ``lift_dp_vae_train_config()``,
``lift_dp_train_config()``, ``lift_ldp_hier_train_config()`` or
``lift_mixed_study_config(arm)``; the agent's ``name``, ``ldp``,
``ldp_hier``, ``dp_vae`` or ``dp``, picks its class), or a config of the
port's config system (``utils/config.load_config``, as the drivers load
it), whose ``_target_`` sections ``instantiate`` builds. Its agent section
takes the bounds the data normalizes with
(``stats_from_data`` measures them) before the agent is built, and
``config.json`` is written again with them. A data section (``data``, and
the optional ``mixed_data``) is a ``MixedOfflineData`` when it sets
``"mixed": true``, else an ``OfflineData`` (``make_data``). Per step:
``agent.update`` on a batch the device dataset gathered (``update_mixed``
on one batch of each stream when there is a ``mixed_data`` stream: the
planner reads ``data``, the IDM ``mixed_data``), then the next gathers;
every ``log_every`` steps the metrics are read and logged (the
only reads of the device inside the loop), every ``save_every`` a snapshot,
every ``eval_every`` an eval; at the end a snapshot and an eval. ``eval``
logs the offline action MSE (``sample_action``: kernel A on the card for
LDP, B for LDP-hier, DPVAE and DP), the losses and, for LDP and LDP-hier,
the plan statistics (``sample_plan_stats``, kernel B) on a train and an
eval batch, then runs ``n_eval_episodes`` closed-loop episodes
(``run_batched_eval``: kernels C, B (twice for LDP-hier) and, for LDP, A
every decision; the policy is handed the ``optimal``
flag when its observation keys name it); ``env_steps_per_sec`` counts each
episode's steps up to its end, as the JAX log does, and
``computed_env_steps_per_sec`` every step the engine ran, masked ones too.
A single-process eval also records the first ``min(2, n_eval_episodes)``
episodes' camera frames (kernel C every env step) and writes them to
``video/<step>_<i>.png`` (``utils/media.save_video``: animated PNG).

Under ``torchrun`` (``parallel/mesh.maybe_init_distributed``) every rank
builds the same agent, ``replicate`` broadcasts rank 0's, and each step
shards the global batch over the ``dp`` axis: every rank draws the global
batch and the losses' draws from generators seeded alike and keeps its
rows (``shard_batch``, ``sharded_draws``), and the train states average
the gradients over the ranks before they clip them, so a W-rank run equals
the one-process run up to the all-reduce's summation order. Only rank 0
logs (the losses of its own rows) and writes ``config.json`` and
checkpoints; the eval's closed loop shards its episodes over every rank
(``env_mesh``), without videos, which the engine does not capture under a
mesh.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Any, Mapping

import torch

from .. import resolve_device
from ..data.datasets import MixedOfflineData, OfflineData
from ..envs.from_meta import make_env_from_meta
from ..models.agents.dp import DPAgent
from ..models.agents.dp_vae import DPVAEAgent
from ..models.agents.ldp import LDPAgent
from ..models.agents.ldp_hier import LDPHierAgent
from ..parallel import mesh as meshlib
from ..rollout import engine as rollout_engine
from ..utils import media
from ..utils.config import instantiate
from ..utils.logger import Logger
from ..utils.timers import Every, Timer
from .checkpoint import Checkpointer, apply_params_snapshot

AGENTS = {"ldp": LDPAgent, "ldp_hier": LDPHierAgent, "dp_vae": DPVAEAgent,
          "dp": DPAgent}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict (``None`` leaves skipped)."""
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    return [] if tree is None else [tree]


def make_data(section: Mapping[str, Any], device: torch.device | str,
              **given) -> OfflineData | MixedOfflineData:
    """A data section as its facade: its ``_target_`` instantiated, or
    ``MixedOfflineData`` when it sets ``"mixed": true``, else
    ``OfflineData``; ``given`` (for example welded ``train``/``eval``
    splits) joins the section's keys."""
    if "_target_" in section:
        return instantiate(section, device=device, **given)
    kw = dict(section)
    cls = MixedOfflineData if kw.pop("mixed", False) else OfflineData
    return cls(**kw, **given, device=device)


def build_agent(agent_cfg: Mapping[str, Any], shape_meta: Mapping[str, Any],
                seed: int, device: torch.device):
    """An agent config (its ``_target_`` instantiated, else the class its
    ``name`` picks) with weights drawn from ``seed``."""
    if "_target_" in agent_cfg:
        return instantiate(agent_cfg, shape_meta, seed=seed, device=device)
    return AGENTS[agent_cfg.get("name", "ldp")].create(
        agent_cfg, shape_meta, seed=seed, device=device)


def agent_config(section: Mapping[str, Any], data) -> tuple[dict, str | None]:
    """An agent section as ``build_agent`` takes it: with the bounds
    ``data`` normalizes with, and without its ``vae_pretrain_path``, which
    is returned beside it."""
    agent_cfg = dict(section)
    vae_path = agent_cfg.pop("vae_pretrain_path", None)
    agent_cfg["obs_normalization"] = data.meta["obs_normalization"]
    return agent_cfg, vae_path


def eval_env(data):
    """The eval env of a data facade: the dataset's recorded env
    (``env_meta``) when it names one, else its ``env_params.env`` (a config
    section with ``_target_`` or ``name``, or an env already built); the
    config's ``episode_len`` wins over the recorded one. None when neither
    names an env."""
    spec = data.env_params.get("env") or {}
    spec_len = (spec.get("episode_len") if isinstance(spec, Mapping)
                else spec.episode_len)
    meta = data.env_meta or {}
    if meta.get("env_name"):
        kwargs = dict(meta.get("env_kwargs", {}))
        if spec_len:
            kwargs["episode_len"] = int(spec_len)
        return make_env_from_meta({"env_name": meta["env_name"],
                                   "env_kwargs": kwargs})
    if not isinstance(spec, Mapping):
        return spec
    if not spec:
        return None
    if "_target_" in spec:
        return instantiate(spec)
    kwargs = {k: v for k, v in spec.items() if k != "name"}
    return make_env_from_meta({"env_name": spec["name"], "env_kwargs": kwargs})


class Workspace:
    def __init__(self, cfg: Mapping[str, Any], work_dir: str | Path | None = None,
                 data: OfflineData | MixedOfflineData | None = None,
                 device: torch.device | str | None = None,
                 mixed_data: OfflineData | MixedOfflineData | None = None):
        self.cfg = copy.deepcopy(dict(cfg))
        self.work_dir = Path(work_dir or self.cfg.get("work_dir",
                                                      "experiments/run"))
        meshlib.maybe_init_distributed()
        self.mesh = meshlib.make_mesh()
        self.env_mesh = (meshlib.make_env_mesh() if self.mesh.world > 1
                         else None)
        self.is_main = self.mesh.rank == 0
        if self.is_main:
            self.work_dir.mkdir(parents=True, exist_ok=True)
        self._write_config()
        self.device = resolve_device(device)
        self.logger = Logger(self.work_dir, write=self.is_main)
        self.ckpt = Checkpointer(self.work_dir / "ckpt")
        self.timer = Timer()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.cfg.get("seed", 0))
        if data is None:
            data = make_data(self.cfg["data"], self.device)
        if mixed_data is None and self.cfg.get("mixed_data"):
            mixed_data = make_data(self.cfg["mixed_data"], self.device)
        self.data = data
        self.mixed_data = mixed_data
        self.agent = None
        self.step = 0
        self.train_seconds = 0.0
        self.loss_history: list[torch.Tensor] = []
        self.last_eval: dict = {}
        self._env = None

    def _write_config(self) -> None:
        if not self.is_main:
            return
        (self.work_dir / "config.json").write_text(
            json.dumps(self.cfg, indent=1, default=str))

    def _record_bounds(self) -> None:
        """Write the bounds the agent normalizes with (the data's, which
        ``stats_from_data`` measures) into the config and rewrite
        ``config.json``, so whatever rebuilds the agent from the run
        directory or a state snapshot's config normalizes as training
        did."""
        for key in ("agent", "model"):      # the VAE workspace's is "model"
            section = self.cfg.get(key)
            if section is not None and "obs_normalization" in section:
                section["obs_normalization"] = copy.deepcopy(
                    self.data.meta["obs_normalization"])
                self._write_config()

    # ------------------------------------------------------------------
    def make_agent(self):
        """The config's agent with seeded weights and, when
        ``vae_pretrain_path`` names a VAE snapshot, its VAE's (EMA)
        weights."""
        agent_cfg, vae_path = agent_config(self.cfg["agent"], self.data)
        agent = build_agent(agent_cfg, self.data.shape_meta,
                            self.cfg.get("seed", 0), self.device)
        if vae_path:
            snap = self.ckpt.restore_raw(vae_path)
            agent.vae.load_state_dict(snap.get("vae_ema_params")
                                      or snap["vae_params"])
        return agent

    def init_agent(self) -> None:
        cfg = self.cfg
        self._record_bounds()
        self.agent = self.make_agent()
        if cfg.get("snapshot_path"):
            apply_params_snapshot(self.agent,
                                  self.ckpt.restore_raw(cfg["snapshot_path"]),
                                  cfg.get("restore_keys"))
        if cfg.get("resume"):
            # continue bit for bit from the newest <step>.state of this run
            states = self.ckpt.list_states()
            if states:
                self.ckpt.restore_state(states[-1], self.agent)
                self.step = int(states[-1].name.split(".")[0])
                self.logger.note(f"resumed full state @ {self.step}")
        self.agent = meshlib.replicate(self.agent, self.mesh)
        n_params = sum(v.numel() for v in _tensors(self.agent.get_params()))
        self.logger.note(f"agent created: {n_params:.3e} params on "
                         f"{self.device}, mesh {self.mesh.shape}")

    # ------------------------------------------------------------------
    def run(self) -> None:
        cfg = self.cfg
        train_iter = self.data.train_dataloader()
        mixed_iter = (self.mixed_data.train_dataloader()
                      if self.mixed_data is not None else None)
        if self.agent is None:
            self.init_agent()
        # every rank draws the global batch and keeps its rows of it
        local = lambda it: (None if it is None
                            else meshlib.shard_batch(next(it), self.mesh))
        batch, mixed_batch = local(train_iter), local(mixed_iter)
        log_every = Every(cfg.get("log_every", 100))
        eval_every = Every(cfg.get("eval_every", 10_000))
        save_every = Every(cfg.get("save_every", 50_000))
        n_steps = cfg["n_grad_steps"]
        self.logger.note(f"training for {n_steps} steps")
        t_start = t_last = time.perf_counter()
        steps_last = self.step
        while self.step < n_steps:
            with self.timer.section("update"), \
                    meshlib.sharded_draws(self.mesh):
                if mixed_iter is not None:
                    metrics = self.agent.update_mixed(
                        batch, mixed_batch, self.step, self.generator)
                else:
                    metrics = self.agent.update(batch, self.step,
                                                self.generator)
            with self.timer.section("data"):
                batch, mixed_batch = local(train_iter), local(mixed_iter)
            # kept on the device: reading them would wait for the step
            self.loss_history.append(torch.stack(
                [metrics[k] for k in self.agent.LOSS_KEYS]))
            if log_every(self.step):
                self.logger.log_metrics(metrics, self.step, "train")
                now = time.perf_counter()
                sps = (self.step - steps_last) / (now - t_last)
                t_last, steps_last = now, self.step
                self.logger.log_metrics({**self.timer.averages(),
                                         "steps_per_sec": sps},
                                        self.step, "train")
                self.logger.dump(self.step, "train")
            if save_every(self.step) and self.step > 0:
                self.save_snapshot()
            if eval_every(self.step) and self.step > 0:
                self.eval()
            self.step += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.train_seconds = time.perf_counter() - t_start
        self.logger.note(f"trained to step {self.step} in "
                         f"{self.train_seconds:.1f} s")
        self.save_snapshot()
        self.eval()

    def loss_curve(self) -> dict[str, torch.Tensor]:
        """Each step's losses of this run (the agent's ``LOSS_KEYS``), on
        the CPU."""
        curve = torch.stack(self.loss_history).cpu()
        return {k: curve[:, i] for i, k in enumerate(self.agent.LOSS_KEYS)}

    # ------------------------------------------------------------------
    def eval(self) -> dict:
        """Offline action MSE, losses and plan statistics on one train and
        one eval batch, then the closed loop; returns what it logged."""
        cfg = self.cfg
        out = {}
        for split, it in (("train", self.data.train_dataloader()),
                          ("eval", self.data.eval_dataloader())):
            batch = next(it)
            pred = self.agent.sample_action(batch, self.generator)
            n = min(pred.shape[1], batch["actions"].shape[1])
            err = pred[:, :n] - batch["actions"][:, :n].to(pred.device)
            metrics = {"action_mse": torch.mean(err ** 2),
                       "action_l1": torch.mean(err.abs())}
            metrics.update(self.agent.get_metrics(batch, self.generator))
            if hasattr(self.agent, "sample_plan_stats"):
                metrics.update(self.agent.sample_plan_stats(batch,
                                                            self.generator))
            out.update({f"{split}_{k}": float(v) for k, v in metrics.items()})
        if cfg.get("n_eval_episodes", 0) > 0 and self._make_env() is not None:
            keys = self._policy_obs_keys()
            n = cfg["n_eval_episodes"]
            video_envs = min(2, n) if self.env_mesh is None else 0
            t0 = time.perf_counter()
            res = rollout_engine.run_batched_eval(
                self._env, self.agent, n, self.step,
                obs_horizon=cfg["obs_horizon"],
                action_horizon=cfg["action_horizon"], policy_obs_keys=keys,
                add_optimal="optimal" in keys, video_envs=video_envs,
                env_mesh=self.env_mesh, device=self.device)
            wall = time.perf_counter() - t0
            m = dict(res["metrics"])
            # the JAX log's rate counts each episode's steps to its end;
            # the computed one every masked step the engine ran as well
            m.update(total_time=wall,
                     env_steps_per_sec=m["horizon"] * m["n_episodes"] / wall,
                     computed_env_steps_per_sec=(
                         self._env.episode_len * m["n_episodes"] / wall))
            out.update(m)
            if self.is_main:
                for i, frames in enumerate(res.get("videos", ())):
                    media.save_video(self.work_dir / "video"
                                     / f"{self.step}_{i}.png", frames)
        self.logger.log_metrics(out, self.step, "eval")
        self.logger.dump(self.step, "eval")
        self.last_eval = out
        return out

    def _policy_obs_keys(self) -> tuple[str, ...]:
        meta = self.data.meta
        return tuple(meta["lowdim_obs"]) + tuple(
            k[len("latent_"):] if k.startswith("latent_") else k
            for k in meta["rgb_obs"])

    def _make_env(self):
        """The data's eval env (``eval_env``), built once."""
        if self._env is None:
            self._env = eval_env(self.data)
        return self._env

    # ------------------------------------------------------------------
    def save_snapshot(self) -> None:
        if not self.is_main:
            return
        with self.timer.section("save"):
            self.ckpt.save_params(self.step, self.agent.get_params())
            if self.cfg.get("save_full_state", True):
                self.ckpt.save_state(self.step, self.agent, config=self.cfg)
        self.logger.note(f"saved snapshot @ {self.step}")

    def load_snapshot(self, path: str | Path) -> None:
        apply_params_snapshot(self.agent, self.ckpt.restore_raw(path))
