"""Scripted expert demos → an ``.npz`` dataset.

Counterpart of ``tools/collect_demos.py``: roll the env's scripted expert
(``engine.run_scripted_collection``, every frame rendered through kernel C
on the card), keep the successful episodes and write them
(``data/writer.write_trajectories``) with the env's name and settings, the
rollout's episode length among them, as ``env_args``.
"""

from __future__ import annotations

from .. import resolve_device
from ..data.writer import write_trajectories
from ..rollout import engine
from ..utils.config import instantiate
from . import load


def main(argv: list[str] | None = None) -> None:
    cfg = load("collect_demos", argv)
    dev = resolve_device(cfg.get("device"))
    env = instantiate(cfg.env)
    out = engine.run_scripted_collection(
        env, cfg.n_episodes, cfg.get("seed", 0),
        episode_len=cfg.get("episode_len"), noise=cfg.get("noise", 0.0),
        noise_hold=cfg.get("noise_hold", 1),
        clean_labels=cfg.get("clean_labels", False), device=dev)
    env_kwargs = {k: v for k, v in cfg.env.items() if k != "_target_"}
    if cfg.get("episode_len"):
        # the demos' true episode length: an eval env rebuilt from env_args
        # must not inherit a shorter cap than the demos had
        env_kwargs["episode_len"] = int(cfg.episode_len)
    n = write_trajectories(
        cfg.out_path, out,
        env_meta={"env_name": type(env).__name__, "env_kwargs": env_kwargs},
        successful_only=cfg.get("successful_only", True),
        max_demos=cfg.get("max_demos"),
        trim_success_margin=cfg.get("trim_success_margin"))
    rate = float(out["success"].any(1).float().mean())
    print(f"wrote {n} demos to {cfg.out_path} (expert success {rate:.1%})")
