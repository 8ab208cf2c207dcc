#!/usr/bin/env python
"""The Can recipe's LDP stage in both packages, on the CPU: does the port's
trainer compute the JAX package's update?

    JAX_PLATFORMS=cpu python tools/compare_ldp_trainers.py --lockstep N \\
        --data DIR --out OUT [--steps 30000] [--every 100] [--float64] \\
        [KEY=VALUE ...]
    JAX_PLATFORMS=cpu python tools/compare_ldp_trainers.py --prepare \\
        --data DIR --vae VAE.ckpt --out OUT [--steps 30000]

``DIR`` holds the port's Can datasets as ``tools/run_can_pipeline_torch.sh``
writes them: ``demos.npz``, ``demos_eval.npz`` and their
``*_latent.npz`` twins.

``--lockstep N`` builds the recipe's LDP agent (the LDP stage's command line
of ``tools/run_can_pipeline.sh``: planner [64,128,256], MLP IDM hidden 256,
DDPM-50, batch 128, AdamW lr 3e-4 with 200 warm-up steps and a cosine to
1e-6 over ``--steps``, no clip, no EMA) in the JAX package from JAX's init
at ``seed`` (the ``Workspace``'s ``split(PRNGKey(seed))[1]``), carries its
weights to the port through ``bridge.py`` and steps the two trainers
together: one stream of windows (the port's data facade over ``DIR``, its
own bounds from ``stats_from_data``), and at each step JAX's key
(``split`` of the ``Workspace``'s running key) for JAX's ``update`` and the
timesteps and noise drawn from that key for the port's (``draws=``). Every
``--every`` steps it prints, and writes to ``OUT/lockstep.json``, the
largest absolute and relative (by tensor norm) difference of a weight
tensor of the planner and of the IDM, and the two packages' losses. Two
identical trainers stay together up to float rounding; a difference in the
update (loss weighting, the time draw, the optimizer, the schedule, the
normalization) shows as a drift that grows with the steps. Training
amplifies rounding too, so beside it runs a control: a second port agent
whose initial weights are nudged by a relative 1e-7 (``NUDGE``), stepped on
the same stream; its distance from the first (``control_*``) is what float
rounding alone grows to by each step. Without
``--data`` the windows are random (``synthetic_batches``), for a quick run
at any widths. ``KEY=VALUE`` overrides join the stage's command line (for
example ``lr=3e-5``: at a tenth of the recipe's rate the IDM's ReLUs stop
flipping on rounding, so the two can be held element by element).

``--float64`` runs both trainers in float64 end to end (``float64``): the
recipe's rate then starts rounding's growth from about 1e-16 instead of
1e-7, so a difference in the update stands out of it at the recipe's
widths and lr. Neither package computes in float64 as written (the nets,
the schedules and the input cast name float32: Flax's ``dtype=``,
``astype(jnp.float32)``, ``Tensor.float()``), so the option points those
names at float64 in this process before either package is imported; the
control's nudge is then 1e-14 (``NUDGE64``).

``--prepare`` readies the JAX package's LDP stage on the port's data: the
four datasets as the robomimic HDF5 the JAX trainer reads
(``compare_vae_trainers.npz_to_hdf5``), the port's VAE snapshot as a JAX
checkpoint (``bridge.export_klvae``, as ``vae_ema_params``), a copy of
each split without its camera frames (all the LDP stage reads, for
carrying to a card: ``OUT/lean``), and the port's ``config.json`` of that
stage over ``--card-data`` (default ``DIR``; what
``tools/run_can_ldp_torch.py`` reads beside the exported checkpoints). It
prints the JAX command line (``n_eval_episodes=0``: JAX's Can env is not
run on the CPU; its offline eval once, at the end), whose checkpoints
``tools/export_bench_torch.py --jax-run`` then converts to the port's
format.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

VAE_ARGS = ["model_vae.block_out_channels=[64,128,128,128]",
            "model_vae.patch_size=4", "model_vae.norm_groups=16"]
# the LDP stage of tools/run_can_pipeline.sh, without its paths and counts
LDP_ARGS = ["agent=ldp_agent", "data=can/latent_img", *VAE_ARGS,
            "agent.planner.down_dims=[64,128,256]",
            "agent.planner_n_diffusion_steps=50",
            "agent.idm_n_diffusion_steps=50",
            "agent.planner_inference_steps=25",
            "agent.idm_inference_steps=25",
            "data.stats_from_data=[latent_agentview_image]",
            "data.env_params.env.episode_len=400",
            "horizon=9", "obs_horizon=1", "action_horizon=4",
            "pred_horizon=8", "batch_size=128", "warmup_steps=200",
            "lr=3e-4", "n_eval_episodes=256", "eval_every=10000",
            "save_every=10000"]
SPLITS = ("demos", "demos_eval")
NUDGE = 1e-7        # the control's relative nudge of its initial weights
NUDGE64 = 1e-14     # the same in float64


def float64() -> None:
    """Make float64 the float type both packages compute in, in this
    process: JAX with 64-bit types, ``jnp.float32`` naming float64 and
    ``jnp.int32`` int64 (optax divides its int32 step count in float32),
    torch with float64 as the default type, ``torch.float32`` naming it and
    ``Tensor.float`` casting to it, and ``bridge.py`` handing weights over
    in float64. Call it before either package is
    imported (their modules read these names as they load)."""
    import jax
    import jax.numpy as jnp
    import torch
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    jnp.int32 = jnp.int64   # optax's step count: its schedule's type
    torch.set_default_dtype(torch.float64)
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    from latent_diffusion_planning_tpu_torch import bridge
    bridge._t = lambda a: torch.from_numpy(np.array(a, dtype=np.float64))


def data_args(data: Path) -> list[str]:
    """The stage's dataset paths under ``data``."""
    return [f"data.train_path={data / 'demos.npz'}",
            f"data.eval_path={data / 'demos_eval.npz'}",
            f"data.train_latent_path={data / 'demos_latent.npz'}",
            f"data.eval_latent_path={data / 'demos_eval_latent.npz'}"]


def port_config(argv: list[str]):
    """The port's resolved ``train_bc`` config of a command line."""
    from latent_diffusion_planning_tpu_torch.drivers import load
    from latent_diffusion_planning_tpu_torch.utils.config import resolve
    cfg = load("train_bc", argv)
    resolve(cfg)
    return cfg


def jax_agent(agent_cfg: dict, shape_meta: dict, seed: int):
    """The JAX ``LDPAgent`` the JAX ``Workspace`` builds from this config
    at ``seed`` (its init key, ``split(PRNGKey(seed))[1]``; XLA scans)."""
    import jax
    from latent_diffusion_planning_tpu.models.agents.ldp import LDPAgent
    kw = {k: v for k, v in agent_cfg.items()
          if k not in ("_target_", "vae_pretrain_path")}
    kw["fused_sampler"] = False
    rng = jax.random.split(jax.random.PRNGKey(seed))[1]
    return LDPAgent.create(rng, None, shape_meta, **kw)


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def bridged(jagent, agent_cfg: dict, shape_meta: dict):
    """The port's ``LDPAgent`` holding the JAX agent's weights."""
    from latent_diffusion_planning_tpu_torch import bridge
    snap = {"planner_params": _np(jagent.planner_state.params),
            "idm_params": _np(jagent.idm_state.params),
            "vae_params": _np(jagent.vae_params)}
    return bridge.ldp_agent_from_flax(snap, agent_cfg, shape_meta,
                                      device="cpu")


def loss_draws(rng, jagent, B: int, H: int) -> dict:
    """The timesteps and noise JAX's ``_loss`` draws from ``rng`` with
    both nets in use: one split a net, then ``t`` and ``noise`` from a
    split of that key."""
    import jax
    c = jagent.config
    oh, D, A = c.obs_horizon, c.obs_dim, c.action_dim
    out = {}
    rng, sub = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(sub)
    out["plan_t"] = np.array(jax.random.randint(
        t_rng, (B,), 0, jagent.planner_sched.num_steps))
    out["plan_noise"] = np.array(jax.random.normal(n_rng, (B, H - oh, D)))
    rng, sub = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(sub)
    n = B * (H - oh)
    out["idm_t"] = np.array(jax.random.randint(
        t_rng, (n,), 0, jagent.idm_sched.num_steps))
    out["idm_noise"] = np.array(jax.random.normal(n_rng, (n, A)))
    return out


def facade_batches(cfg):
    """The port's data facade of a config, on the CPU, and its train
    windows as numpy batches."""
    from latent_diffusion_planning_tpu_torch.train.loop import make_data
    data = make_data(cfg["data"], "cpu")

    def stream():
        for batch in data.train_dataloader():
            yield {"obs": {k: v.numpy() for k, v in batch["obs"].items()},
                   "actions": batch["actions"].numpy()}
    return data, stream()


def synthetic_batches(B: int, H: int, lowdim: dict, latent: dict,
                      A: int, seed: int = 0):
    """Random windows: lowdim keys ``{key: dim}`` near the Can bounds'
    middle, latent keys ``{key: dim}`` at the scale of the Can latents."""
    rng = np.random.default_rng(seed)
    while True:
        obs = {k: rng.uniform(-0.2, 0.2, (B, H, d)).astype(np.float32)
               + np.float32(1.0 if k == "robot0_eef_pos" else 0.0)
               for k, d in lowdim.items()}
        obs.update({k: rng.normal(0, 2.0, (B, H, d)).astype(np.float32)
                    for k, d in latent.items()})
        yield {"obs": obs,
               "actions": rng.uniform(-1, 1, (B, H, A)).astype(np.float32)}


def weight_gap(name: str, port_net, jax_params, mirror
               ) -> tuple[float, float]:
    """The largest absolute and relative (tensor norm) difference between
    ``port_net``'s weights and ``jax_params`` loaded into ``mirror`` (the
    planner or the IDM, as ``name`` says)."""
    from latent_diffusion_planning_tpu_torch import bridge
    load = bridge.load_unet1d if name == "planner" else bridge.load_mlp_diffusion
    load(mirror, _np(jax_params))
    return gap(port_net, mirror)


def gap(net, other) -> tuple[float, float]:
    """The largest absolute and relative (tensor norm) difference between
    the weights of two nets of one structure."""
    worst_abs = worst_rel = 0.0
    for a, b in zip(net.parameters(), other.parameters()):
        a, b = a.detach().double(), b.detach().double()
        worst_abs = max(worst_abs, float((a - b).abs().max()))
        if float(b.norm()) > 0:
            worst_rel = max(worst_rel, float((a - b).norm() / b.norm()))
    return worst_abs, worst_rel


def lockstep(agent_cfg: dict, shape_meta: dict, batches, n: int,
             every: int = 100, seed: int = 0, log=print,
             nudge: float = NUDGE) -> list[dict]:
    """``n`` steps of both trainers from JAX's init on one stream (see the
    module docstring); a row every ``every`` steps and at the last."""
    import copy
    import jax
    import jax.numpy as jnp
    import torch
    jagent = jax_agent(agent_cfg, shape_meta, seed)
    agent = bridged(jagent, agent_cfg, shape_meta)
    control = bridged(jagent, agent_cfg, shape_meta)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in (*control.planner.parameters(), *control.idm.parameters()):
            p.mul_(1 + nudge * torch.randn(p.shape, generator=gen,
                                           dtype=p.dtype))
    control.weights_changed()
    mirror = bridged(jagent, agent_cfg, shape_meta)
    mirrors = {"planner": copy.deepcopy(mirror.planner),
               "idm": copy.deepcopy(mirror.idm)}
    key = jax.random.PRNGKey(seed)
    key = jax.random.split(key)[0]      # the Workspace's key after its init
    rows, t0 = [], time.perf_counter()
    for step in range(n):
        batch = next(batches)
        B, H = batch["actions"].shape[:2]
        key, sub = jax.random.split(key)
        jagent, jm = jagent.update(
            jax.tree_util.tree_map(jnp.asarray, batch), sub, step)
        tb = {"obs": {k: torch.from_numpy(v) for k, v in batch["obs"].items()},
              "actions": torch.from_numpy(batch["actions"])}
        draws = loss_draws(sub, jagent, B, H)
        pm = agent.update(tb, step, draws=draws)
        control.update(tb, step, draws=draws)
        if (step + 1) % every and step + 1 != n:
            continue
        row = dict(step=step + 1, seconds=time.perf_counter() - t0)
        for name in ("planner", "idm"):
            a, r = weight_gap(name, getattr(agent, name),
                              getattr(jagent, f"{name}_state").params,
                              mirrors[name])
            row[f"{name}_max_abs"], row[f"{name}_max_rel"] = a, r
            a, r = gap(getattr(agent, name), getattr(control, name))
            row[f"control_{name}_max_abs"] = a
            row[f"control_{name}_max_rel"] = r
        for k in ("plan_loss", "idm_loss"):
            row[f"jax_{k}"] = float(jm[k])
            row[f"port_{k}"] = float(pm[k])
            row[f"{k}_diff"] = abs(float(jm[k]) - float(pm[k]))
        row["lr_diff"] = abs(float(jm["planner_lr"]) - float(pm["planner_lr"]))
        rows.append(row)
        log(json.dumps(row))
    return rows


def strip_frames(src: Path, dst: Path) -> None:
    """``src`` without its camera frames (keys ending in ``_image`` outside
    ``latent/``): what the LDP stage's data facade reads."""
    with np.load(src) as z:
        keep = {k: z[k] for k in z.files
                if not (k.endswith("_image") and "/latent/" not in k)}
    np.savez(dst, **keep)


def prepare(data: Path, vae: Path, out: Path, steps: int, seed: int,
            card_data: Path) -> dict:
    """The JAX stage's inputs from the port's datasets and VAE snapshot
    (see the module docstring)."""
    import torch
    from compare_vae_trainers import VAE_CFG, npz_to_hdf5
    from latent_diffusion_planning_tpu.train.checkpoint import (
        Checkpointer as JaxCheckpointer)
    from latent_diffusion_planning_tpu_torch import bridge
    from latent_diffusion_planning_tpu_torch.data.latents import load_vae
    out.mkdir(parents=True, exist_ok=True)
    h5 = out / "hdf5"
    h5.mkdir(exist_ok=True)
    for split in SPLITS:
        for suffix in ("", "_latent"):
            dst = h5 / f"{split}{suffix}.hdf5"
            if not dst.exists():
                npz_to_hdf5(data / f"{split}{suffix}.npz", dst)
    lean = out / "lean"
    lean.mkdir(exist_ok=True)
    for split in SPLITS:
        for suffix in ("", "_latent"):
            dst = lean / f"{split}{suffix}.npz"
            if not dst.exists():
                strip_frames(data / f"{split}{suffix}.npz", dst)
    params = bridge.export_klvae(load_vae(vae, VAE_CFG, torch.device("cpu")))
    jvae = JaxCheckpointer(out / "jax_vae").save_params(
        0, {"vae_params": params, "vae_ema_params": params})
    cfg = port_config(LDP_ARGS + data_args(card_data) + [
        f"n_grad_steps={steps}", f"seed={seed}", "experiment_name=ldp"])
    (out / "config.json").write_text(json.dumps(cfg, indent=1, default=str))
    jax_cmd = ["tools/train_bc.py",
               *(a for a in LDP_ARGS
                 if not a.startswith(("n_eval_episodes=", "eval_every="))),
               f"data.train_path={h5 / 'demos.hdf5'}",
               f"data.eval_path={h5 / 'demos_eval.hdf5'}",
               f"data.train_latent_path={h5 / 'demos_latent.hdf5'}",
               f"data.eval_latent_path={h5 / 'demos_eval_latent.hdf5'}",
               f"agent.vae_pretrain_path={jvae}", f"n_grad_steps={steps}",
               f"seed={seed}", f"experiment_root={out / 'exp'}",
               "experiment_folder=jax", "experiment_name=ldp",
               "n_eval_episodes=0", f"eval_every={10 * steps}"]
    return dict(jax_vae=str(jvae), config=str(out / "config.json"),
                lean_data=str(lean), jax_command=jax_cmd)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=Path, default=None)
    ap.add_argument("--vae", type=Path, default=None)
    ap.add_argument("--card-data", type=Path, default=None,
                    help="--prepare: the datasets' folder config.json names")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--lockstep", type=int, default=0, metavar="N")
    ap.add_argument("--prepare", action="store_true")
    ap.add_argument("--float64", action="store_true",
                    help="--lockstep: both trainers in float64")
    ap.add_argument("overrides", nargs="*", metavar="KEY=VALUE",
                    help="--lockstep: more overrides of the stage")
    args = ap.parse_args()
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    if args.prepare:
        if args.data is None or args.vae is None:
            ap.error("--prepare needs --data and --vae")
        info = prepare(args.data.resolve(), args.vae.resolve(), out,
                       args.steps, args.seed, args.card_data or args.data)
        print(json.dumps(info, indent=1))
        return 0
    if not args.lockstep:
        ap.error("give --lockstep N or --prepare")
    if args.float64:
        float64()
    argv = LDP_ARGS + [f"n_grad_steps={args.steps}", f"seed={args.seed}",
                       *args.overrides]
    if args.data is not None:
        cfg = port_config(argv + data_args(args.data.resolve()))
        data, batches = facade_batches(cfg)
        from latent_diffusion_planning_tpu_torch.train.loop import (
            agent_config)
        agent_cfg, _ = agent_config(cfg["agent"], data)
        shape_meta = data.shape_meta
    else:
        cfg = port_config(argv)
        agent_cfg = dict(cfg["agent"])
        shape_meta = cfg["data"]["meta"]["shape_meta"]
        dims = shape_meta["all_shapes"]
        batches = synthetic_batches(
            cfg["batch_size"], cfg["horizon"],
            {k: dims[k][0] for k in agent_cfg["lowdim_obs"]},
            {k: dims[k][0] for k in agent_cfg["rgb_obs"]},
            shape_meta["ac_dim"], args.seed)
    rows = lockstep(agent_cfg, shape_meta, batches, args.lockstep,
                    args.every, args.seed,
                    nudge=NUDGE64 if args.float64 else NUDGE)
    name = "lockstep64.json" if args.float64 else "lockstep.json"
    (out / name).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
