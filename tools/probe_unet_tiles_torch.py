#!/usr/bin/env python
"""Kernel B's time at every tile that fits, at the LDP-hier recipe's shapes.

    python3 tools/probe_unet_tiles_torch.py [--out PATH]   # on the card

``choose_tile`` runs the most samples a block that still leaves
``MIN_BLOCKS`` blocks. This times kernel B at each choice of samples per
block instead, for the two U-Nets of ``lift_ldp_hier_train_config()``
(neither downsamples) at the shapes of one 1024-env decision: the planner
[64,128,256] k 5 over 1024 plans of 2 latents, and the chunk IDM [64,128]
k 3 over 2048 chunks of 4 actions; DDIM-25 of 50 train steps; weights,
conditions and initial samples seeded. Each tile's result is held against
the chosen tile's (a reading: samples run independently, so they should
agree). Prints one JSON line per net, ``{"net", "samples", "T",
"chosen_samples_per_block", "ms_by_samples_per_block",
"max_abs_diff_by_samples_per_block", "card"}``, each time the mean of 3
calls between CUDA events; ``--out`` writes them as a JSON list.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def time_ms(fn, iters: int = 3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        unet_from_config)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    dev = torch.device("cuda")
    agent = configs.lift_ldp_hier_train_config()["agent"]
    obs_dim, action_dim = 25, 7
    rows = []
    for name, section, D, Dc, B, T in (
            ("planner", agent["planner"], obs_dim, obs_dim, 1024,
             agent["pred_horizon"] // agent["idm_horizon"]),
            ("idm", agent["idm_net"], action_dim, 2 * obs_dim, 2048,
             agent["idm_horizon"])):
        torch.manual_seed(17)
        net = unet_from_config(section, D, Dc).to(dev)
        sched = dlib.DiffusionSchedule.create(
            agent[f"{name}_n_diffusion_steps"])
        ts, coefs = dlib.ddim_coef_table(sched,
                                         agent[f"{name}_inference_steps"])
        ts, coefs = ts.to(dev, torch.int32), coefs.to(dev)
        g = torch.Generator(device=dev).manual_seed(18)
        gc = torch.randn(B, Dc, generator=g, device=dev)
        x0 = torch.randn(B, T, D, generator=g, device=dev)
        packed = K.pack_params(net).to(dev)
        run = lambda nb=None: K.fused_unet1d_ddim_sample(
            net, gc, x0, ts, coefs, clip_range=sched.clip_range,
            packed=packed, nb=nb)
        chosen = run()
        ms, diff = {}, {}
        for nb in K.NB_CHOICES:
            try:
                got = run(nb)
            except ValueError:
                continue        # this many samples do not fit a block
            diff[nb] = float((got - chosen).abs().max())
            ms[nb] = time_ms(lambda: run(nb))
        row = dict(net=name, down_dims=list(net.down_dims), samples=B, T=T,
                   chosen_samples_per_block=K.choose_tile(net, T, B)[0],
                   ms_by_samples_per_block=ms,
                   max_abs_diff_by_samples_per_block=diff, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
