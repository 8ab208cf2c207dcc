#!/usr/bin/env python
"""Score one run of ``tools/run_can_pipeline_torch.sh`` closed-loop, on one
card.

    python3 tools/run_can_ldp_torch.py --run experiments/can_pipeline/ldp
        [--out PATH]

Each checkpoint of ``STEPS`` runs ``EVAL_SEEDS`` closed loops of the run's
``n_eval_episodes`` (the recipe's 256) on its eval env (``CanPhysicsEnv``
at the 400-step protocol), seeds step, step + 1, ... (the first is the
``Workspace``'s own eval), through kernels C, B and A. The checkpoint
``PLAIN_AT`` runs the same loops again with both nets sampled by their
plain fp32 reverse processes on the card in place of kernels B and A
(``plain_sampling``: a measurement, which no path of the package takes on
the card; C still renders). For each loop and for each checkpoint's pooled
episodes it prints ``success`` with its Wilson 95% interval, ``reward`` (an
episode's best step reward, averaged) and ``horizon`` (its steps to the
end, averaged), the kernels' launches and the card's name and power limit;
``--out`` writes them as JSON. The run's datasets must be where its
``config.json`` names them (the pipeline's own). A loop of 256 episodes
takes 8–19 s on an H100 through the kernels, 33–50 s on the plain loop.
"""

import argparse
import contextlib
import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STEPS = (10000, 20000, 30000)
PLAIN_AT = 30000


def wilson(k: int, n: int, z: float = 1.959964) -> tuple[float, float]:
    """The Wilson score interval of k successes in n trials."""
    p, scale = k / n, 1 + z * z / n
    mid = (p + z * z / (2 * n)) / scale
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / scale
    return max(0.0, mid - half), min(1.0, mid + half)


@contextlib.contextmanager
def plain_sampling(agent):
    """Within the block, ``agent`` (LDP) samples its planner U-Net and its
    MLP IDM with the plain fp32 reverse processes on its device in place of
    kernels B and A (the U-Net as ``tools/run_lift_ldp_hier_torch.py``'s
    ``fp32_sampling`` does)."""
    from latent_diffusion_planning_tpu_torch.models.agents import common
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA)
    from run_lift_ldp_hier_torch import fp32_sampling

    def idm(pairs, x_init, generator, draws=None):
        c, sched = agent.config, agent.idm_sched
        ts, coefs = agent._table(sched, c.idm_inference_steps)
        noise = common.step_noise(c.idm_inference_steps, sched, None,
                                  (pairs.shape[0], c.action_dim), generator,
                                  pairs.device)
        return KA.mlp_diffusion_sample_plain(agent._inference_net("idm"),
                                             pairs, x_init, ts, coefs, noise,
                                             agent._clip(sched))
    with fp32_sampling(agent):
        agent._idm_decode = idm
        try:
            yield
        finally:
            del agent._idm_decode


def pooled(rows, step: int, route: str, card: str) -> dict:
    """One checkpoint's loops pooled: success with its Wilson interval,
    reward and horizon over all their episodes."""
    k = sum(r["successes"] for r in rows)
    n = sum(r["n_episodes"] for r in rows)
    for r in rows:
        r["interval"] = wilson(r["successes"], r["n_episodes"])
    out = dict(step=step, route=route, successes=k, n_episodes=n,
               success=k / n, interval=wilson(k, n),
               reward=sum(r["reward"] * r["n_episodes"] for r in rows) / n,
               horizon=sum(r["horizon"] * r["n_episodes"] for r in rows) / n,
               loops=rows)
    print(f"step {step} {route}: success {out['success']:.4f} "
          f"[{out['interval'][0]:.3f}, {out['interval'][1]:.3f}] "
          f"({k} of {n}), reward {out['reward']:.4f}, horizon "
          f"{out['horizon']:.2f} [{card}]", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", type=Path, required=True,
                    help="the LDP run directory (config.json, ckpt/)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from latent_diffusion_planning_tpu_torch.drivers import (
        agent_from_snapshot, policy_keys, run_data)
    from latent_diffusion_planning_tpu_torch.train.loop import eval_env
    from latent_diffusion_planning_tpu_torch.utils.config import (
        load_config, resolve)
    from run_lift_ldp_hier_torch import EVAL_SEEDS, closed_loops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    run_cfg = load_config(str(args.run / "config.json"))
    resolve(run_cfg)
    data, agent_cfg = run_data(run_cfg, dev)
    env = eval_env(data)
    keys = policy_keys(data.meta)
    record = {"run": str(args.run), "card": card, "seed": run_cfg.get("seed"),
              "episode_len": env.episode_len, "checkpoints": []}
    for step in STEPS:
        agent = agent_from_snapshot(agent_cfg, data,
                                    args.run / "ckpt" / f"{step}.ckpt", dev)
        seeds = range(step, step + EVAL_SEEDS)
        routes = [("kernels C, B, A", contextlib.nullcontext())]
        if step == PLAIN_AT:
            routes.append(("plain fp32 loop", plain_sampling(agent)))
        for route, sampling in routes:
            with sampling:
                rows = closed_loops(env, agent, keys, run_cfg, seeds, route,
                                    card, dev)
            record["checkpoints"].append(pooled(rows, step, route, card))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1, default=str))
    return 0

if __name__ == "__main__":
    sys.exit(main())
