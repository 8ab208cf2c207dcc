"""Offline checkpoint sweep of a finished run → ``eval_sweep/eval.csv``.

Counterpart of ``tools/eval_bc.py``: the run's ``config.json`` merged with
this command line's keys, then for every checkpoint of ``ckpt/`` (or those
``ckpt_steps`` names) the action MSE and L1 of ``sample_action`` on one
train and one eval batch, and closed-loop episodes in the env its training
evaluated in (``train/loop.eval_env``); the MSE and L1 compare the first n
actions of each, n the shorter, as the ``Workspace``'s eval does (the JAX
tool slices the window's actions to the prediction's length, which fails on
LDP-hier, whose prediction is longer). ``sweep_batch=K`` evaluates K
checkpoints at once through ``engine.run_batched_eval_multi`` (one env
batch of K·N; the default, 0 or 1, one at a time); checkpoint s's episodes
reset and draw from ``rollout_seed(seed, s)`` either way, so its result
does not depend on ``sweep_batch``. ``idm_snapshot_path`` puts another
snapshot's IDM into every checkpoint; ``eval_action_horizon`` and
``plan_blend`` change how the chunks are executed. A failure raises: there
is no per-checkpoint fallback.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from .. import resolve_device
from ..rollout import engine
from ..train.checkpoint import Checkpointer
from ..train.loop import eval_env
from ..utils.config import load_config, merge, resolve
from ..utils.logger import Logger
from . import agent_from_snapshot, load, policy_keys, run_data


def rollout_seed(seed: int, step: int) -> int:
    """The rollout seed of the checkpoint at ``step``."""
    return int(seed) + int(step)


def main(argv: list[str] | None = None) -> None:
    cfg = load("eval_bc", argv)
    run_dir = Path(cfg.run_dir)
    run_cfg = load_config(str(run_dir / "config.json"))
    run_cfg = merge(run_cfg, {k: v for k, v in cfg.items()
                              if k not in ("run_dir", "_groups_")})
    resolve(run_cfg)
    ckpt = Checkpointer(run_dir / "ckpt")
    only = {int(s) for s in cfg.get("ckpt_steps") or []} or None
    steps_paths = [(int(p.name.split(".")[0]), p)
                   for p in ckpt.list_checkpoints()]
    steps_paths = [(s, p) for s, p in steps_paths if only is None or s in only]
    if not steps_paths:
        raise FileNotFoundError(f"no checkpoints to sweep under {run_dir}/ckpt")
    dev = resolve_device(cfg.get("device"))
    data, agent_cfg = run_data(run_cfg, dev)
    logger = Logger(run_dir / "eval_sweep")
    env = eval_env(data)
    idm_snapshot = (ckpt.restore_raw(cfg.idm_snapshot_path)
                    if cfg.get("idm_snapshot_path") else None)

    seed = int(cfg.get("seed", 1111111))
    gen = torch.Generator(device=dev).manual_seed(seed)
    train_iter, eval_iter = data.train_dataloader(), data.eval_dataloader()
    rollout_kw = dict(
        obs_horizon=run_cfg.obs_horizon,
        action_horizon=(int(cfg.get("eval_action_horizon") or 0)
                        or run_cfg.action_horizon),
        plan_blend=float(cfg.get("plan_blend", 0.0)),
        policy_obs_keys=policy_keys(data.meta),
        add_optimal="optimal" in data.meta["lowdim_obs"], device=dev)
    n_episodes = int(cfg.get("n_eval_episodes", 0))
    group = max(1, int(cfg.get("sweep_batch") or 0))
    for i in range(0, len(steps_paths), group):
        chunk = [(s, agent_from_snapshot(agent_cfg, data, p, dev,
                                         idm_snapshot))
                 for s, p in steps_paths[i:i + group]]
        logged = {step: {} for step, _ in chunk}
        for step, agent in chunk:
            for split, it in (("train", train_iter), ("eval", eval_iter)):
                batch = next(it)
                pred = agent.sample_action(batch, gen)
                # as the Workspace's eval: the first n of each (LDP-hier
                # decodes (H-1)·k actions from an H-step window)
                n = min(pred.shape[1], batch["actions"].shape[1])
                pred = pred[:, :n]
                gt = batch["actions"][:, :n].to(pred.device)
                logged[step].update({
                    f"{split}_action_mse": torch.mean((pred - gt) ** 2),
                    f"{split}_action_l1": torch.mean((pred - gt).abs())})
        if env is not None and n_episodes > 0:
            t0 = time.perf_counter()
            outs = engine.run_batched_eval_multi(
                env, [a for _, a in chunk], n_episodes,
                [rollout_seed(seed, s) for s, _ in chunk], **rollout_kw)
            wall = time.perf_counter() - t0
            for (step, _), out in zip(chunk, outs):
                logged[step].update(out["metrics"], sweep_batch=len(chunk),
                                    sweep_wall_s=wall)
                print(f"ckpt {step}: success={out['metrics']['success']:.2%} "
                      f"reward={out['metrics']['reward']:.2f} (sweep of "
                      f"{len(chunk)} in {wall:.2f} s)", flush=True)
        for step, metrics in logged.items():
            logger.log_metrics(metrics, step, "eval")
            logger.dump(step, "eval")
