"""Suboptimal rollouts of a trained checkpoint → an ``.npz`` dataset.

Counterpart of ``tools/collect_data.py``: rebuild a finished run's agent
from its ``config.json`` and a checkpoint (``ckpt_name``, default the
newest), roll it out in the env its training evaluated in
(``train/loop.eval_env``) with Gaussian action noise
(``engine.run_data_collection``: kernels A, B and C on the card), keep the
(un)successful episodes and write them (``data/writer.write_trajectories``).
"""

from __future__ import annotations

from pathlib import Path

from .. import resolve_device
from ..data.writer import write_trajectories
from ..rollout import engine
from ..train.checkpoint import Checkpointer
from ..train.loop import eval_env
from ..utils.config import load_config
from . import agent_from_snapshot, load, policy_keys, run_data


def load_agent_from_run(run_dir: str | Path, ckpt_name: str | None = None,
                        device=None):
    """(agent, run config, data facade) of a finished run, with checkpoint
    ``ckpt_name`` (default: the newest) loaded."""
    run_dir = Path(run_dir)
    run_cfg = load_config(str(run_dir / "config.json"))
    data, agent_cfg = run_data(run_cfg, resolve_device(device))
    paths = Checkpointer(run_dir / "ckpt").list_checkpoints()
    if not paths:
        raise FileNotFoundError(f"no checkpoints under {run_dir}/ckpt")
    path = run_dir / "ckpt" / ckpt_name if ckpt_name else paths[-1]
    agent = agent_from_snapshot(agent_cfg, data, path, data.device)
    return agent, run_cfg, data


def main(argv: list[str] | None = None) -> None:
    cfg = load("collect_data", argv)
    agent, run_cfg, data = load_agent_from_run(
        cfg.run_dir, cfg.get("ckpt_name"), cfg.get("device"))
    env = eval_env(data)
    keys = policy_keys(data.meta)
    out = engine.run_data_collection(
        env, agent, cfg.n_episodes, cfg.get("seed", 0),
        obs_horizon=run_cfg.obs_horizon,
        action_horizon=run_cfg.action_horizon,
        episode_len=cfg.get("episode_len"),
        action_noise=cfg.get("noise", 0.0), policy_obs_keys=keys,
        add_optimal="optimal" in data.meta["lowdim_obs"], device=data.device)
    n = write_trajectories(
        cfg.out_path, out, env_meta={"env_name": type(env).__name__},
        successful_only=cfg.get("successful_only", False),
        unsuccessful_only=cfg.get("unsuccessful_only", False),
        max_demos=cfg.get("max_demos"))
    rate = float(out["success"].any(1).float().mean())
    print(f"wrote {n} rollouts to {cfg.out_path} (policy success "
          f"{rate:.1%}, noise {cfg.get('noise', 0.0)})")
