#!/usr/bin/env python
"""Closed-loop success of the exported bench weights on the card, on the
protocol ``bench.py`` runs for the JAX package.

    python3 tools/eval_bench_torch.py [--ckpt build/bench_torch/30000.ckpt]
        [--envs 1024] [--steps 400] [--seeds 1 2 3 4] [--out PATH]

The bench agent (``configs.BENCH_AGENT``: DDIM-10 for planner and IDM) with
the weights ``tools/export_bench_torch.py`` wrote, on ``LiftPhysicsEnv`` as
``configs.make_bench_env`` builds it, ``envs`` episodes of ``steps`` steps
per seed through ``run_batched_eval`` (kernels C, B and A every decision).
Prints, per seed, the success share, the mean horizon and the computed
env-steps/s, each beside the card's name and power limit; ``--out`` writes
them as JSON.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", type=Path,
                    default=REPO / "build" / "bench_torch" / "30000.ckpt")
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if not args.ckpt.exists():
        print(f"{args.ckpt} is missing: run tools/export_bench_torch.py where "
              "JAX is installed", file=sys.stderr)
        return 2
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.checkpoint import (
        Checkpointer, apply_params_snapshot)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    cfg = configs.bench_agent_config()
    agent = LDPAgent.create(cfg, configs.SHAPE_META, device="cuda")
    apply_params_snapshot(agent, Checkpointer(args.ckpt.parent).restore_raw(
        args.ckpt))
    env = configs.make_bench_env(args.steps)
    run = lambda n, steps, seed: engine.run_batched_eval(
        env, agent, n, seed, obs_horizon=cfg["obs_horizon"],
        action_horizon=cfg["action_horizon"], episode_len=steps,
        policy_obs_keys=configs.BENCH_POLICY_KEYS, device="cuda")
    run(args.envs, 8, 0)            # warm-up: cuDNN plans, the env's graph
    rows = []
    for seed in args.seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run(args.envs, args.steps, seed)["metrics"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = dict(seed=seed, success=m["success"], horizon=m["horizon"],
                   reward=m["reward"], envs=args.envs, steps=args.steps,
                   wall_s=wall, env_steps_per_s=args.envs * args.steps / wall,
                   card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)
    mean = sum(r["success"] for r in rows) / len(rows)
    print(f"success over {len(rows)} seeds x {args.envs} envs: {mean:.4f} "
          f"[{card}]")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
