#!/usr/bin/env python
"""Convert JAX checkpoints into the PyTorch port's format.

    python tools/export_bench_torch.py [--out build/bench_torch]
    python tools/export_bench_torch.py --jax-run RUN --config CONFIG.json \\
        --out OUT

Orbax checkpoints only a machine with JAX and orbax can read; this tool runs
on such a machine. Each snapshot is restored with the JAX package's
``Checkpointer.restore_raw``, the port's agent is built from it through
``bridge.ldp_agent_from_flax`` and ``agent.get_params()`` is written with the
port's ``Checkpointer.save_params`` (``torch.save`` of state dicts: the
planner, the IDM and the whole VAE, its encoder and its decoder).

Without ``--jax-run`` it converts the committed bench checkpoint
(``assets/bench/agent.ckpt``, the bench agent's config) into
``<out>/30000.ckpt`` (55.9 MB). With it, the LDP snapshots
``RUN/ckpt/<step>.ckpt`` of a JAX ``tools/train_bc.py`` run, whose agent is
the one of the port's ``CONFIG`` (a run's ``config.json``; for the Can
recipe ``tools/compare_ldp_trainers.py --prepare`` writes it), every one
the run holds, into ``OUT/ckpt/<step>.ckpt``, with ``CONFIG`` copied to
``OUT/config.json``: a port run directory that
``tools/run_can_ldp_torch.py --run OUT`` scores.
``build/`` is git-ignored, so exports are not committed; a machine without
JAX reads them with ``Checkpointer.restore_raw`` and
``apply_params_snapshot`` (``tools/eval_bench_torch.py``).
"""

import argparse
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STEP = 30000        # the bench run's n_grad_steps


def export(snapshot_path: Path, agent_cfg: dict, shape_meta: dict,
           out: Path, step: int) -> Path:
    """One JAX LDP snapshot as the port's ``<out>/<step>.ckpt``."""
    import jax
    import numpy as np
    from latent_diffusion_planning_tpu.train.checkpoint import (
        Checkpointer as JaxCheckpointer)
    from latent_diffusion_planning_tpu_torch import bridge
    from latent_diffusion_planning_tpu_torch.train.checkpoint import Checkpointer

    snap = JaxCheckpointer(snapshot_path.parent).restore_raw(snapshot_path)
    snap = jax.tree_util.tree_map(np.asarray, snap)
    agent = bridge.ldp_agent_from_flax(snap, agent_cfg, shape_meta,
                                       device="cpu")
    path = Checkpointer(out).save_params(step, agent.get_params())
    n = sum(v.numel() for p in agent.get_params().values() for v in p.values())
    print(f"wrote {path} ({n} parameters, {path.stat().st_size / 1e6:.1f} MB)")
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--jax-run", type=Path, default=None,
                    help="a JAX train_bc run directory (its ckpt/)")
    ap.add_argument("--config", type=Path, default=None,
                    help="with --jax-run: the port's config.json of the run")
    args = ap.parse_args()
    from latent_diffusion_planning_tpu_torch import configs
    if args.jax_run is None:
        ckpt = REPO / "assets" / "bench"
        export(ckpt / "agent.ckpt", configs.bench_agent_config(),
               configs.SHAPE_META, args.out or REPO / "build" / "bench_torch",
               STEP)
        return 0
    if args.config is None or args.out is None:
        ap.error("--jax-run needs --config and --out")
    from latent_diffusion_planning_tpu_torch.utils.config import (
        load_config, resolve)
    cfg = load_config(str(args.config))
    resolve(cfg)
    agent_cfg = {k: v for k, v in dict(cfg.agent).items()
                 if k != "vae_pretrain_path"}
    shape_meta = cfg.data["meta"]["shape_meta"]
    args.out.mkdir(parents=True, exist_ok=True)
    snaps = sorted((int(p.stem), p)
                   for p in (args.jax_run / "ckpt").glob("*.ckpt")
                   if p.stem.isdigit())
    if not snaps:
        ap.error(f"no <step>.ckpt under {args.jax_run / 'ckpt'}")
    for step, path in snaps:
        export(path, agent_cfg, shape_meta, args.out / "ckpt", step)
    shutil.copy(args.config, args.out / "config.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
