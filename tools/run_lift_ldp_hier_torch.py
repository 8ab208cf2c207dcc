#!/usr/bin/env python
"""Stage 3 of ``tools/run_lift_baselines.sh`` (hierarchical LDP) in the
PyTorch/CUDA port, from nothing, on one card.

    python3 tools/run_lift_ldp_hier_torch.py [--steps 15000]
        [--vae-steps 4000] [--dp-vae-steps 15000] [--out PATH]

What ``tools/run_lift_pipeline.sh`` makes first, then the stage itself:
- demos: the scripted expert on ``LiftPhysicsEnv``, 256 episodes of 80
  steps from seed 0 for train and 32 from seed 77 for eval, every frame
  through the ray-cast kernel, successful episodes welded in memory;
- the VAE: ``configs.lift_vae_train_config()`` (4000 steps at batch 64);
- latents of both splits from the VAE snapshot's EMA weights;
- LDP-hier: ``configs.lift_ldp_hier_train_config()`` with that snapshot
  (15000 steps at batch 128, a snapshot and an eval of 256 closed-loop
  episodes at 7500 and at 15000 steps).

Then readings that tell apart why the trained agent succeeds as often as it
does. The final agent runs ``EVAL_SEEDS`` closed loops of 256 episodes
(seeds 15000, 15001, ...; the first is the ``Workspace``'s own) twice:
through kernel B, and with both U-Nets sampled by the plain fp32 loop on
the card instead (``fp32_sampling``: a measurement of what B's bf16
sampling costs, which no path of the package takes on the card). And, as a
control for the demos, the VAE and the training loop that both share,
DPVAE (``configs.lift_dp_vae_train_config()``, stage 2) on the same
latents for ``--dp-vae-steps`` steps with the recorded JAX run's schedule
(``assets/runs/baselines/dp_vae/config.yaml``: 15000 steps, decay over
15000, evals at 7500 and 15000), its final agent over the same seeds
(``--dp-vae-steps 0`` skips it).

Runs live under the git-ignored ``build/ldp_hier_full/``. Prints each
eval's success, horizon and plan statistics, and the train rate, each
beside the card's name and power limit; ``--out`` writes them as JSON.
"""

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DEMO_SPLITS = (("train", 256, 0), ("eval", 32, 77))
DEMO_LEN = 80
EVAL_SEEDS = 4


@contextlib.contextmanager
def fp32_sampling(agent):
    """Within the block, ``agent`` samples both U-Nets with the plain fp32
    reverse process on its device in place of kernel B."""
    from latent_diffusion_planning_tpu_torch.models.agents import common
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)

    def sample(name, steps, cond, x_init, generator, draws=None):
        sched = getattr(agent, f"{name}_sched")
        ts, coefs = agent._table(sched, steps)
        noise = common.step_noise(steps, sched, None, tuple(x_init.shape),
                                  generator, x_init.device)
        return K.unet1d_ddim_sample_plain(agent._inference_net(name), cond,
                                          x_init, ts, coefs,
                                          agent._clip(sched), noise)
    agent._unet_sample = sample
    try:
        yield
    finally:
        del agent._unet_sample


def closed_loops(env, agent, keys, cfg, seeds, route: str, card: str,
                 device) -> list[dict]:
    """``agent`` in one closed loop of ``cfg``'s eval size on ``env`` per
    seed, with its success count, reward, horizon and the kernels it
    launched."""
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine
    rows = []
    for seed in seeds:
        kernels.reset_launch_counts()
        m = engine.run_batched_eval(
            env, agent, cfg["n_eval_episodes"], seed,
            obs_horizon=cfg["obs_horizon"],
            action_horizon=cfg["action_horizon"], policy_obs_keys=keys,
            device=device)["metrics"]
        n = int(m["n_episodes"])
        row = dict(route=route, seed=seed, n_episodes=n,
                   successes=round(float(m["success"]) * n),
                   success=float(m["success"]), reward=float(m["reward"]),
                   horizon=float(m["horizon"]),
                   launches=kernels.launch_counts())
        print(f"{type(agent).__name__} {route}, seed {seed}: success "
              f"{row['success']:.4f} over {n} episodes, reward "
              f"{row['reward']:.4f}, horizon {row['horizon']:.2f}, launches "
              f"{row['launches']} [{card}]", flush=True)
        rows.append(row)
    mean = sum(r["success"] for r in rows) / len(rows)
    print(f"{type(agent).__name__} {route}: mean success {mean:.4f} over "
          f"{len(rows)} seeds [{card}]", flush=True)
    return rows


def workspace_loops(ws, seeds, route: str, card: str) -> list[dict]:
    """``closed_loops`` of a workspace's agent on its eval env."""
    return closed_loops(ws._make_env(), ws.agent, ws._policy_obs_keys(),
                        ws.cfg, seeds, route, card, ws.device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=15000)
    ap.add_argument("--vae-steps", type=int, default=4000)
    ap.add_argument("--dp-vae-steps", type=int, default=15000)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.latents import (
        process_latents)
    from latent_diffusion_planning_tpu_torch.data.writer import (
        weld_collection)
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace
    from latent_diffusion_planning_tpu_torch.train.vae_loop import VAEWorkspace

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    work = REPO / "build" / "ldp_hier_full"
    shutil.rmtree(work, ignore_errors=True)
    record = {"card": card}

    env = configs.make_bench_env(episode_len=DEMO_LEN)
    env_meta = {"env_name": "LiftPhysicsEnv",
                "env_kwargs": dict(configs.BENCH_ENV, episode_len=DEMO_LEN)}
    keys = list(configs.BENCH_AGENT["lowdim_obs"]) + ["agentview_image"]
    welded = {}
    for split, n, seed in DEMO_SPLITS:
        col = engine.run_scripted_collection(env, n, seed, device=dev)
        welded[split] = weld_collection(col, obs_keys=keys, env_meta=env_meta,
                                        successful_only=True,
                                        name=f"lift/{split}")
        print(f"demos {split}: {welded[split].n_demos} of {n}", flush=True)
        record[f"demos_{split}"] = welded[split].n_demos

    vcfg = configs.lift_vae_train_config()
    vcfg.update(n_grad_steps=args.vae_steps, eval_every=0, save_every=0)
    data_kw = {k: v for k, v in vcfg["data"].items() if not k.endswith("path")}
    vws = VAEWorkspace(vcfg, work / "vae", device=dev,
                       data=OfflineData(**data_kw, train=welded["train"],
                                        eval=welded["eval"], device=dev))
    vws.run()
    snapshot = vws.ckpt.list_checkpoints()[-1]
    record["vae"] = dict(steps=args.vae_steps, eval=vws.last_eval,
                         steps_per_s=args.vae_steps / vws.train_seconds)
    process_latents(list(welded.values()), snapshot, vcfg["model"]["vae"],
                    ["agentview_image"], device=dev)

    cfg = configs.lift_ldp_hier_train_config(vae_pretrain_path=str(snapshot))
    half = args.steps // 2
    cfg.update(n_grad_steps=args.steps, eval_every=half, save_every=half,
               resume=False)
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=welded["train"], eval=welded["eval"],
                       device=dev)
    t0 = time.perf_counter()
    ws = Workspace(cfg, work / "ldp_hier", data=data, device=dev)
    ws.run()
    record["ldp_hier"] = dict(steps=args.steps, wall_s=time.perf_counter() - t0,
                              train_s=ws.train_seconds,
                              steps_per_s=args.steps / ws.train_seconds)
    evals = [json.loads(line) for line in
             (ws.work_dir / "eval.jsonl").read_text().splitlines()]
    record["ldp_hier"]["evals"] = evals
    for ev in evals:
        print(f"LDP-hier eval at step {ev['step']}: success {ev['success']:.4f} "
              f"over {ev['n_episodes']:.0f} episodes, horizon "
              f"{ev['horizon']:.2f}; eval_plan_mse {ev['eval_plan_mse']:.4f} "
              f"against eval_plan_mse_persist "
              f"{ev['eval_plan_mse_persist']:.4f}; eval_action_mse "
              f"{ev['eval_action_mse']:.5f} [{card}]", flush=True)
    print(f"LDP-hier: {args.steps} steps at batch {cfg['batch_size']}, "
          f"{record['ldp_hier']['steps_per_s']:.2f} steps/s [{card}]",
          flush=True)
    seeds = range(args.steps, args.steps + EVAL_SEEDS)
    loops = workspace_loops(ws, seeds, "kernel B", card)
    with fp32_sampling(ws.agent):
        loops += workspace_loops(ws, seeds, "plain fp32", card)
    record["ldp_hier"]["closed_loops"] = loops

    if args.dp_vae_steps:
        dcfg = configs.lift_dp_vae_train_config(vae_pretrain_path=str(snapshot))
        half = args.dp_vae_steps // 2
        dcfg["agent"]["decay_steps"] = args.dp_vae_steps
        dcfg.update(n_grad_steps=args.dp_vae_steps, eval_every=half,
                    save_every=half, resume=False)
        data_kw = {k: v for k, v in dcfg["data"].items()
                   if not k.endswith("path")}
        dws = Workspace(dcfg, work / "dp_vae", device=dev,
                        data=OfflineData(**data_kw, train=welded["train"],
                                         eval=welded["eval"], device=dev))
        dws.run()
        evals = [json.loads(line) for line in
                 (dws.work_dir / "eval.jsonl").read_text().splitlines()]
        for ev in evals:
            print(f"DPVAE eval at step {ev['step']}: success "
                  f"{ev['success']:.4f} over {ev['n_episodes']:.0f} episodes, "
                  f"horizon {ev['horizon']:.2f} [{card}]", flush=True)
        record["dp_vae"] = dict(
            steps=args.dp_vae_steps, train_s=dws.train_seconds,
            steps_per_s=args.dp_vae_steps / dws.train_seconds, evals=evals,
            closed_loops=workspace_loops(
                dws, range(args.dp_vae_steps, args.dp_vae_steps + EVAL_SEEDS),
                "kernel B", card))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
