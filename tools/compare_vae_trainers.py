#!/usr/bin/env python
"""The Can recipe's VAE stage in both packages on one set of demos, on the
CPU: do the JAX package's and the port's trainers give latents of the same
range?

    JAX_PLATFORMS=cpu python tools/compare_vae_trainers.py \\
        --train DEMOS.npz --eval DEMOS_EVAL.npz --out DIR [--steps 4000]
        [--seed 0] [--jax-init] [--lockstep N]

The demos are the port's ``.npz`` files of ``tools/run_can_pipeline_torch.sh``
(``tools/collect_demos_torch.py ... device=cpu`` writes them on the CPU);
they are also written as the robomimic HDF5 the JAX trainer reads. Then,
at once, each package's ``train_vae`` runs the recipe's VAE stage from its
own init (the arguments of ``tools/run_can_pipeline.sh``: patch-4
[64,128,128,128], batch 64, 4000 steps, warm-up 100, lr 3e-4, a snapshot
and an eval at half and at the end; ``--seed`` seeds both trainers' init,
batches and draws, as ``SEED`` does in the port's pipeline), JAX's on
the CPUs of the first half of this process's affinity, the port's on the
second. Each snapshot's EMA weights encode both splits through its own
package's ``process_latents``. The port's snapshot is also exported to
Flax (``bridge.export_klvae``) and encoded by the JAX tool's
``encode_file`` on the eval split, spliced terminal frames included,
against the port's latents of it.

Prints, and writes as ``DIR/compare.json``: each trainer's eval rows
(loss, KL, z_std, z_min, z_max at 2000 and 4000 steps);
over each package's train latents the extremes ``process_latents``
records, the bounds ``stats_from_data`` builds from them (padded by 5% of
the span each side), the 0.1% and 99.9% quantiles and the standard
deviation; and the encode's largest absolute difference. At 4000 steps
it takes about 1.5 h on 8 cores, most of it the JAX trainer.

``--jax-init`` runs the port's trainer alone, from the weights JAX's
trainer starts from at ``--seed`` (its own batches and draws): the
port's latents beside those of JAX's run at that seed tell whether the
init draw or the rest of training sets their range.

``--lockstep N`` trains the two in one process instead, N steps of the
schedule over ``--steps``, from one set of weights (JAX's init, bridged),
on one stream of batches (frames drawn with numpy) and posterior noise
(JAX's ``split(rng)[0]``, handed to the port). Every 100 steps it prints,
for each package's EMA weights, the posterior means of 512 eval frames
(max, min, standard deviation) and the largest relative distance of a
weight tensor between the two (not the attention's key bias: its true
gradient is 0, so Adam steps both sides by their rounding noise, and the
softmax cancels it). Two identical trainers stay together up to float
rounding; a difference in the update shows as a drift that grows with
the steps. About 2 s a step on 4 cores.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

VAE_ARGS = ["data=can/img", "model.vae.block_out_channels=[64,128,128,128]",
            "model.vae.patch_size=4", "model.vae.norm_groups=16",
            "batch_size=64", "warmup_steps=100", "lr=3e-4"]
ENC_ARGS = ["vae.block_out_channels=[64,128,128,128]", "vae.patch_size=4",
            "vae.norm_groups=16"]
VAE_CFG = dict(block_out_channels=[64, 128, 128, 128], patch_size=4,
               norm_groups=16)
STATS_PAD = 0.05
RGB = "agentview_image"


def npz_to_hdf5(src: Path, dst: Path) -> None:
    """A port ``.npz`` demo or latent file as robomimic HDF5 (the same key
    paths; a latent file's ``min_z``/``max_z`` as the attributes JAX's
    ``tools/process_latents.py`` records)."""
    with np.load(src) as z, h5py.File(dst, "w") as f:
        data = f.create_group("data")
        for k in z.files:
            if k == "data/env_args":
                data.attrs["env_args"] = str(z[k])
            elif k in ("data/min_z", "data/max_z"):
                data.attrs[k[5:]] = float(json.loads(str(z[k])))
            elif k.endswith("/num_samples"):
                f.require_group(k.rsplit("/", 1)[0]).attrs[
                    "num_samples"] = int(z[k])
            else:
                f.create_dataset(k, data=z[k])


def start(cmd, cpus, log: Path, **env) -> subprocess.Popen:
    """``cmd`` in the background on ``cpus``, its output into ``log``."""
    env = dict(os.environ, OMP_NUM_THREADS=str(len(cpus)), **env)
    return subprocess.Popen(
        [sys.executable] + cmd, cwd=REPO, env=env, stdout=log.open("w"),
        stderr=subprocess.STDOUT,
        preexec_fn=lambda: os.sched_setaffinity(0, cpus))


def run(cmd, cpus, log: Path, **env) -> None:
    if start(cmd, cpus, log, **env).wait():
        raise SystemExit(f"{cmd[0]} failed: see {log}")


def eval_rows(run_dir: Path) -> list[dict]:
    import csv
    keep = ("step", "loss", "loss_kl", "z_std", "z_min", "z_max")
    with open(run_dir / "eval.csv") as f:
        return [{k: float(r[k]) for k in keep} for r in csv.DictReader(f)]


def latent_stats(z: np.ndarray) -> dict:
    lo, hi = float(z.min()), float(z.max())
    pad = STATS_PAD * (hi - lo)
    q = np.quantile(z, [0.001, 0.999])
    return dict(min_z=lo, max_z=hi, bounds=[lo - pad, hi + pad],
                span=hi - lo + 2 * pad, q001=float(q[0]), q999=float(q[1]),
                std=float(z.std()), n=int(z.size))


def jax_latents(path: Path) -> np.ndarray:
    with h5py.File(path) as f:
        return np.concatenate([f[f"data/{d}/latent/{RGB}"][:].ravel()
                               for d in f["data"]])


def port_latents(path: Path) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k.split("/")[1]: z[k] for k in z.files
                if k.endswith(f"/latent/{RGB}")}


def encode_difference(snapshot: Path, src: Path, port_file: Path,
                      work: Path) -> float:
    """The JAX tool's ``encode_file`` of the port snapshot's weights on
    ``src`` against the port's latents of it: the largest |difference|."""
    import torch
    from process_latents import encode_file
    from latent_diffusion_planning_tpu.models.vae import KLVAE as JKLVAE
    from latent_diffusion_planning_tpu_torch import bridge
    from latent_diffusion_planning_tpu_torch.data.latents import load_vae
    vae = load_vae(snapshot, VAE_CFG, torch.device("cpu"))
    params = bridge.export_klvae(vae)
    out = work / "port_weights_jax_encode.hdf5"
    encode_file(str(src), str(out), JKLVAE(**VAE_CFG), params, [RGB],
                {"min": 0, "max": 255})
    mine = port_latents(port_file)
    worst = 0.0
    with h5py.File(out) as f:
        assert set(f["data"]) == set(mine)
        for d, z in mine.items():
            theirs = f[f"data/{d}/latent/{RGB}"][:]
            assert theirs.shape == z.shape, (d, theirs.shape, z.shape)
            worst = max(worst, float(np.abs(theirs - z).max()))
    return worst


def lockstep(train: Path, eval_: Path, steps: int, n: int,
             out: Path) -> list[dict]:
    """The two trainers step by step from one init on one stream of
    batches and noise (see the module's docstring)."""
    import jax
    import jax.numpy as jnp
    import torch
    from latent_diffusion_planning_tpu.models.vae import VAEModel as JVAE
    from latent_diffusion_planning_tpu_torch import bridge, configs
    from latent_diffusion_planning_tpu_torch.models.vae import VAEModel
    base = configs.lift_vae_train_config()["model"]
    cfg = dict(base, vae=dict(base["vae"], **VAE_CFG), lr=3e-4, end_lr=1e-6,
               warmup_steps=100, decay_steps=steps)
    norm = json.loads((REPO / "latent_diffusion_planning_tpu_torch/conf/data/"
                       "can/img.json").read_text())["meta"]["obs_normalization"]
    cfg["obs_normalization"] = norm
    jm = JVAE.create(jax.random.PRNGKey(0), None, vae=cfg["vae"],
                     beta=cfg["beta"], rgb_obs=cfg["rgb_obs"],
                     obs_normalization=norm, lr=cfg["lr"],
                     end_lr=cfg["end_lr"], warmup_steps=cfg["warmup_steps"],
                     decay_steps=steps, ema_decay=cfg["ema_decay"])
    tm = VAEModel.create(cfg, device="cpu")
    flat = jax.tree_util.tree_map(np.asarray, jm.vae_state.params)
    tm.vae_state.set_params(
        bridge.klvae_from_flax(flat, **VAE_CFG).state_dict())

    def frames(path):
        with np.load(path) as z:
            return np.concatenate([z[k] for k in z.files
                                   if k.endswith(f"/obs/{RGB}")])
    pool, probe = frames(train), frames(eval_)
    probe = probe[::max(1, len(probe) // 512)][:512]
    probe_n = probe.astype(np.float32) / 127.5 - 1.0
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(1)
    hw = tm.latent_hw()

    def readings(step):
        jz = np.asarray(jm.encode_mode(jnp.asarray(probe_n)))
        tz = tm.encode_mode(torch.from_numpy(probe_n)).detach().numpy()
        mine = bridge.klvae_from_flax(
            jax.tree_util.tree_map(np.asarray, jm.vae_state.ema_params),
            **VAE_CFG)
        drift = max(float((a - b).norm() / b.norm())
                    for (name, a), b in zip(
                        tm.vae_state.ema.named_parameters(),
                        mine.parameters())
                    if b.norm() > 0 and not name.endswith("attn.k.bias"))
        row = dict(step=step, weight_drift=drift,
                   jax=dict(max=float(jz.max()), min=float(jz.min()),
                            std=float(jz.std())),
                   port=dict(max=float(tz.max()), min=float(tz.min()),
                             std=float(tz.std())))
        print(json.dumps(row), flush=True)
        return row

    rows = [readings(0)]
    for step in range(1, n + 1):
        idx = rng.integers(0, len(pool), 64)
        batch = {"obs": {RGB: np.stack([pool[idx], pool[idx]], 1)}}
        key, sub = jax.random.split(key)
        eps = np.array(jax.random.normal(jax.random.split(sub)[0],
                                         (64, *hw)))
        jm, _ = jm.update(jax.tree_util.tree_map(jnp.asarray, batch), sub)
        tm.update({"obs": {RGB: torch.from_numpy(batch["obs"][RGB])}},
                  step - 1, draws={"eps": eps})
        if step % 100 == 0:
            rows.append(readings(step))
    (out / "lockstep.json").write_text(json.dumps(rows, indent=1))
    return rows


def jax_init_snapshot(seed: int, out: Path) -> Path:
    """JAX's ``VAEWorkspace`` init at ``seed`` (``KLVAE.init`` from
    ``split(PRNGKey(seed))[1]``) as a port snapshot."""
    import jax
    import jax.numpy as jnp
    import torch
    from latent_diffusion_planning_tpu.models.vae import KLVAE as JKLVAE
    from latent_diffusion_planning_tpu_torch import bridge
    rng = jax.random.split(jax.random.PRNGKey(seed))[1]
    params = JKLVAE(**VAE_CFG).init(rng, jnp.zeros((2, 64, 64, 3)),
                                    jax.random.PRNGKey(0))["params"]
    sd = bridge.klvae_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                **VAE_CFG).state_dict()
    path = out / "jax_init.ckpt"
    torch.save({"vae_params": sd, "vae_ema_params": sd}, path)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", type=Path, required=True)
    ap.add_argument("--eval", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jax-init", action="store_true")
    ap.add_argument("--lockstep", type=int, default=0, metavar="N")
    args = ap.parse_args()
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    if args.lockstep:
        lockstep(args.train, args.eval, args.steps, args.lockstep, out)
        return 0
    cpus = sorted(os.sched_getaffinity(0))
    halves = {"jax": set(cpus[:len(cpus) // 2]),
              "port": set(cpus[len(cpus) // 2:])}
    h5 = {s: out / f"{s}.hdf5" for s in ("train", "eval")}
    npz = {"train": args.train.resolve(), "eval": args.eval.resolve()}
    for s in h5:
        npz_to_hdf5(npz[s], h5[s])

    common = VAE_ARGS + [f"n_grad_steps={args.steps}",
                         f"save_every={args.steps // 2}",
                         f"eval_every={args.steps // 2}",
                         f"experiment_root={out / 'exp'}",
                         f"seed={args.seed}", f"data.seed={args.seed}",
                         "experiment_name=vae"]
    port_cmd = ["tools/train_vae_torch.py", *common, "experiment_folder=port",
                "device=cpu", f"data.train_path={npz['train']}",
                f"data.eval_path={npz['eval']}"]
    if args.jax_init:
        port_cmd.append(f"snapshot_path={jax_init_snapshot(args.seed, out)}")
        procs = {"port": start(port_cmd, set(cpus), out / "train_port.log")}
    else:
        procs = {
            "jax": start(["tools/train_vae.py", *common,
                          "experiment_folder=jax",
                          f"data.train_path={h5['train']}",
                          f"data.eval_path={h5['eval']}"],
                         halves["jax"], out / "train_jax.log",
                         JAX_PLATFORMS="cpu"),
            "port": start(port_cmd, halves["port"], out / "train_port.log")}
    record = {"steps": args.steps, "seed": args.seed,
              "port_init": "jax" if args.jax_init else "port", "trainers": {}}
    for name, p in procs.items():
        if p.wait():
            raise SystemExit(f"{name} trainer failed: see {out}")
        run_dir = out / "exp" / name / "vae"
        record["trainers"][name] = eval_rows(run_dir)
    snap = {k: out / "exp" / k / "vae" / "ckpt" / f"{args.steps}.ckpt"
            for k in procs}
    lat = {"jax": {s: out / f"jax_{s}_latent.hdf5" for s in h5},
           "port": {s: out / f"port_{s}_latent.npz" for s in h5}}
    run(["tools/process_latents_torch.py", f"vae_snapshot_path={snap['port']}",
         *ENC_ARGS, f"src_paths=[{npz['train']},{npz['eval']}]",
         f"dst_paths=[{lat['port']['train']},{lat['port']['eval']}]",
         "device=cpu"], set(cpus), out / "latents_port.log")
    record["latents"] = {"port": latent_stats(np.concatenate(
        [z.ravel() for z in port_latents(lat["port"]["train"]).values()]))}
    if not args.jax_init:
        run(["tools/process_latents.py", f"vae_snapshot_path={snap['jax']}",
             *ENC_ARGS, f"src_paths=[{h5['train']},{h5['eval']}]",
             f"dst_paths=[{lat['jax']['train']},{lat['jax']['eval']}]"],
            set(cpus), out / "latents_jax.log", JAX_PLATFORMS="cpu")
        record["latents"]["jax"] = latent_stats(
            jax_latents(lat["jax"]["train"]))
        record["encode_max_abs_diff"] = encode_difference(
            snap["port"], h5["eval"], lat["port"]["eval"], out)
    text = json.dumps(record, indent=1)
    (out / "compare.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
