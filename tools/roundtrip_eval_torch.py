#!/usr/bin/env python
"""Closed-loop score of the reference-naming round trip.

The port's counterpart of ``tools/roundtrip_eval.py``:

    python tools/roundtrip_eval_torch.py original=SNAPSHOT.ckpt \
        reimported=REIMPORTED.ckpt [run_dir=RUN] [n_episodes=512]
        [episode_len=400] [seed=7] [device=cuda]

Builds the agent (``run_dir``'s, or the bench agent on ``LiftPhysicsEnv``
as ``configs.make_bench_env`` builds it) with the ``original`` snapshot's
weights, and a second one with the ``reimported`` planner and IDM applied
on top (what ``tools/import_reference_ckpt_torch.py`` wrote from the
export of ``original``). Every planner and IDM tensor must be equal bit
for bit; then both agents run ``run_batched_eval`` on identical seeds
(kernels C, B and A on the card) and their actions, decision by decision,
must be equal. Prints ``{"original", "roundtrip", "delta_pp",
"n_episodes"}``: the renames are bijections, so the success delta is 0.
"""

import copy
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from latent_diffusion_planning_tpu_torch import configs  # noqa: E402
from latent_diffusion_planning_tpu_torch.drivers import run_agent  # noqa: E402
from latent_diffusion_planning_tpu_torch.rollout import engine  # noqa: E402
from latent_diffusion_planning_tpu_torch.train.checkpoint import (  # noqa: E402
    Checkpointer, apply_params_snapshot)


def recording_policy(store: list):
    """``agent_sample_policy`` that keeps every decision's actions."""
    def policy(agent, view, gen):
        actions = engine.agent_sample_policy(agent, view, gen)
        store.append(actions.clone())
        return actions
    return policy


def compare(original, reimported: dict) -> None:
    """Every planner and IDM tensor of ``reimported`` equals the agent's."""
    for key in ("planner_params", "idm_params"):
        mine = getattr(original, key[:-len("_params")]).state_dict()
        theirs = reimported[key]
        if mine.keys() != theirs.keys():
            raise AssertionError(f"{key}: keys differ")
        for k, v in mine.items():
            if not torch.equal(v.cpu(), theirs[k].cpu()):
                raise AssertionError(f"{key}/{k} changed in the round trip")


def roundtrip_eval(agent, reimported: dict, env, n_episodes: int, seed: int,
                   policy_keys, device) -> dict:
    """Both agents' evals on identical seeds; raises unless their actions
    agree at every decision."""
    compare(agent, reimported)
    twin = copy.deepcopy(agent)
    apply_params_snapshot(twin, reimported,
                          restore_keys=["planner_params", "idm_params"])
    out, actions = {}, {}
    for tag, pol in (("original", agent), ("roundtrip", twin)):
        actions[tag] = []
        res = engine.run_batched_eval(
            env, pol, n_episodes, seed,
            obs_horizon=pol.config.obs_horizon,
            action_horizon=pol.config.action_horizon,
            policy_obs_keys=policy_keys, device=device,
            policy=recording_policy(actions[tag]))
        out[tag] = res["metrics"]["success"]
    for d, (a, b) in enumerate(zip(actions["original"], actions["roundtrip"])):
        if not torch.equal(a, b):
            raise AssertionError(f"the actions part at decision {d}")
    out["delta_pp"] = abs(out["original"] - out["roundtrip"]) * 100
    out["n_episodes"] = n_episodes
    out["decisions"] = len(actions["original"])
    return out


def main(argv=None) -> None:
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:]))
    device = args.get("device", "cuda")
    run_dir = args.get("run_dir")
    episode_len = int(args.get("episode_len", 400))
    agent = run_agent(run_dir, device)
    original = Path(args["original"])
    apply_params_snapshot(agent, Checkpointer(original.parent).restore_raw(
        original))
    reimported = Checkpointer(".").restore_raw(args["reimported"])
    if run_dir is None:
        env, keys = (configs.make_bench_env(episode_len),
                     configs.BENCH_POLICY_KEYS)
    else:
        from latent_diffusion_planning_tpu_torch.drivers import (
            policy_keys, run_data)
        from latent_diffusion_planning_tpu_torch.train.loop import eval_env
        from latent_diffusion_planning_tpu_torch.utils.config import (
            load_config)
        data, _ = run_data(load_config(str(Path(run_dir) / "config.json")),
                           torch.device(device))
        env, keys = eval_env(data), policy_keys(data.meta)
    print(json.dumps(roundtrip_eval(
        agent, reimported, env, int(args.get("n_episodes", 512)),
        int(args.get("seed", 7)), keys, device)))


if __name__ == "__main__":
    main()
