#!/usr/bin/env python
"""The port's VAE trainer on the card against the same trainer on the CPU,
in lockstep: is the card's VAE stage the same function as the CPU's?

    python tools/compare_vae_devices_torch.py run --device cuda|cpu
        [--permute] --train DEMOS.npz --eval DEMOS_EVAL.npz --out DIR/ARM
        [--steps 2000] [ARG=value ...]
    python tools/compare_vae_devices_torch.py report DIR [--also cuda_perm]

``run`` builds the Can recipe's VAE stage as ``tools/train_vae_torch.py``
does (``tools/run_can_pipeline_torch.sh``'s arguments: patch-4
[64,128,128,128], norm_groups 16, batch 64, warm-up 100, lr 3e-4 over
4000 steps with EMA; extra ``ARG=value`` overrides follow them), its
weights from ``VAEModel.create(seed)`` (drawn on the CPU, so every device
starts from the same bits), and steps it ``--steps`` times on one stream
that does not depend on the device: the batch indices drawn with numpy
from seed 0 and handed to ``DeviceDataset.sample(idx=...)``, the posterior
noise drawn on the CPU from seed 1 and handed in through ``draws={"eps":
...}``. ``--permute`` permutes each batch's rows (indices and noise alike,
by a permutation drawn from seed 2): the same update, summed in another
order. Every 100 steps it saves the trained and EMA weights and the EMA
posterior means of 512 eval frames (max, min, standard deviation) to
``ARM/<step>.pt``.

``latents A.npz [B.npz] [--vae-run DIR]`` prints, as JSON, the spread of
a latent file (``tools/process_latents_torch.py``'s): its extremes, the
bounds ``stats_from_data`` builds from them (padded by 5% of the span each
side), the 0.1% and 99.9% quantiles, and the bounds' span over the
quantiles' span; with B (the same demos encoded by the same snapshot on
another device), B's beside it and the largest |A - B|; with ``--vae-run``,
the VAE run's last eval row (loss, KL).

``report`` reads the arms under DIR and prints, at every saved step, the
largest relative distance ||a - b|| / ||b|| of a weight tensor (trained
weights and EMA; not the attention's key bias, whose true gradient is 0:
Adam steps it by its rounding noise) of the card's arm ``cuda`` and of
the yardstick ``cpu_perm`` to the CPU's arm ``cpu``, and of ``--also``
(the card with rows permuted) to ``cuda``, beside each arm's posterior
means. The rule, fixed before the runs: the card's arm is another
function than the CPU's if its distance exceeds ``K`` (10) times the
yardstick's at two successive steps (trained weights). Writes
``DIR/report.json``.

The CPU arms take about 0.4 s a step on 4 cores; the card's about 20 ms.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

RECIPE = ["data=can/img", "model.vae.block_out_channels=[64,128,128,128]",
          "model.vae.patch_size=4", "model.vae.norm_groups=16",
          "batch_size=64", "n_grad_steps=4000", "warmup_steps=100",
          "lr=3e-4"]
N_PROBE = 512
SKIP = "attn.k.bias"
K = 10.0                 # the rule's factor over the yardstick
REF, YARDSTICK = "cpu", "cpu_perm"


def build(train: Path, eval_: Path, device: str, seed: int, out: Path,
          overrides=()):
    """The recipe's ``VAEModel`` at ``seed`` on ``device``, its train split
    as a ``DeviceDataset`` and 512 normalized eval frames."""
    import torch
    from latent_diffusion_planning_tpu_torch.drivers import load
    from latent_diffusion_planning_tpu_torch.train.vae_loop import VAEWorkspace
    cfg = load("train_vae", [*RECIPE, f"data.train_path={train}",
                             f"data.eval_path={eval_}", f"seed={seed}",
                             f"data.seed={seed}", f"device={device}",
                             *overrides])
    ws = VAEWorkspace(cfg, out, device=device)
    model = ws.make_agent()
    key = model.config["rgb_obs"][0]
    frames = ws.data.device_dataset("eval").arrays[key]
    frames = frames[::max(1, len(frames) // N_PROBE)][:N_PROBE]
    probe = model._prepare({"obs": {key: frames}})["obs"][key]
    return model, ws.data.device_dataset("train"), probe, int(
        cfg["batch_size"]), torch.device(device)


def readings(model, probe) -> dict:
    z = model.encode_mode(probe).float().cpu()
    return dict(max=float(z.max()), min=float(z.min()),
                std=float(z.std(correction=0)))


def run_arm(out: Path, device: str, permute: bool, train: Path,
            eval_: Path, steps: int, seed: int = 0, every: int = 100,
            overrides=(), tweak=None) -> list[dict]:
    """One arm (see the module's docstring); ``tweak(model)``, if given,
    alters the trainer before the first step (a test's deliberate
    fault)."""
    import torch
    out.mkdir(parents=True, exist_ok=True)
    model, data, probe, batch, dev = build(train, eval_, device, seed, out,
                                           overrides)
    if tweak is not None:
        tweak(model)
    idx_rng = np.random.default_rng(seed)
    perm_rng = np.random.default_rng(seed + 2)
    noise = torch.Generator().manual_seed(seed + 1)
    hw = model.latent_hw()
    rows = []

    def save(step):
        row = dict(step=step, readings=readings(model, probe))
        torch.save(dict(row, params={k: v.detach().cpu() for k, v in
                                     model.vae.state_dict().items()},
                        ema={k: v.detach().cpu() for k, v in
                             model.vae_state.ema.state_dict().items()}),
                   out / f"{step}.pt")
        print(json.dumps(row), flush=True)
        rows.append(row)

    save(0)
    for step in range(1, steps + 1):
        idx = idx_rng.integers(0, data.n_steps, batch)
        eps = torch.randn((batch, *hw), generator=noise)
        if permute:
            p = perm_rng.permutation(batch)
            idx, eps = idx[p], eps[p]
        model.update(data.sample(batch, idx=torch.from_numpy(idx)), step - 1,
                     draws={"eps": eps.to(dev)})
        if step % every == 0:
            save(step)
    return rows


def distance(a: dict, b: dict) -> float:
    """The largest ||a - b|| / ||b|| over the tensors (not the key bias)."""
    worst = 0.0
    for name, t in b.items():
        if name.endswith(SKIP) or not t.is_floating_point():
            continue
        nb = float(t.double().norm())
        if nb > 0:
            worst = max(worst, float((a[name].double() - t.double()).norm())
                        / nb)
    return worst


def report(root: Path, arm: str = "cuda", also: str | None = None) -> dict:
    import torch
    k, ref, yardstick = K, REF, YARDSTICK
    arms = [a for a in (ref, arm, yardstick, also) if a]
    steps = sorted(int(p.stem) for p in (root / ref).glob("*.pt"))
    rows, over = [], 0
    verdict = "the same function"
    for s in steps:
        snap = {a: torch.load(root / a / f"{s}.pt") for a in arms
                if (root / a / f"{s}.pt").exists()}
        if len(snap) < len(arms):
            break
        row = dict(step=s)
        for kind in ("params", "ema"):
            row[kind] = {
                f"{arm}_vs_{ref}": distance(snap[arm][kind], snap[ref][kind]),
                f"{yardstick}_vs_{ref}": distance(snap[yardstick][kind],
                                                  snap[ref][kind])}
            if also:
                row[kind][f"{also}_vs_{arm}"] = distance(snap[also][kind],
                                                         snap[arm][kind])
        row["readings"] = {a: snap[a]["readings"] for a in arms}
        d, y = (row["params"][f"{arm}_vs_{ref}"],
                row["params"][f"{yardstick}_vs_{ref}"])
        row["ratio"] = d / y if y > 0 else (0.0 if d == 0 else float("inf"))
        over = over + 1 if s > 0 and row["ratio"] > k else 0
        if over >= 2:
            verdict = "another function"
        print(json.dumps(row), flush=True)
        rows.append(row)
    out = dict(k=k, ref=ref, arm=arm, yardstick=yardstick, also=also,
               rows=rows, verdict=verdict)
    print(f"{arm} against {ref}, k = {k} x {yardstick}: {verdict} "
          f"({len(rows)} steps compared)")
    (root / "report.json").write_text(json.dumps(out, indent=1))
    return out


def latent_spread(path: Path) -> tuple[dict, dict]:
    """(stats, {demo: latents}) of a latent file."""
    with np.load(path) as z:
        lat = {k: z[k] for k in z.files if k.endswith("/latent/agentview_image")}
    flat = np.concatenate([v.ravel() for v in lat.values()]).astype(np.float64)
    lo, hi = float(flat.min()), float(flat.max())
    pad = 0.05 * max(hi - lo, 1e-4)
    q = np.quantile(flat, [0.001, 0.999])
    stats = dict(min=lo, max=hi, bounds=[lo - pad, hi + pad],
                 q001=float(q[0]), q999=float(q[1]),
                 span_over_quantiles=(hi - lo + 2 * pad) / float(q[1] - q[0]),
                 std=float(flat.std()), n=int(flat.size))
    return stats, lat


def latents(a: Path, b: Path | None = None, vae_run: Path | None = None
            ) -> dict:
    out = {"a": latent_spread(a)[0]}
    if b is not None:
        sa, la = latent_spread(a)
        sb, lb = latent_spread(b)
        assert set(la) == set(lb), "the two files hold other demos"
        out["b"] = sb
        out["max_abs_diff"] = max(float(np.abs(la[k].astype(np.float64)
                                               - lb[k]).max()) for k in la)
    if vae_run is not None:
        import csv
        with open(vae_run / "eval.csv") as f:
            row = list(csv.DictReader(f))[-1]
        out["vae_eval"] = {k: float(row[k]) for k in ("step", "loss",
                                                      "loss_kl")}
    print(json.dumps(out, indent=1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--device", required=True)
    r.add_argument("--permute", action="store_true")
    r.add_argument("--train", type=Path, required=True)
    r.add_argument("--eval", type=Path, required=True)
    r.add_argument("--out", type=Path, required=True)
    r.add_argument("--steps", type=int, default=2000)
    r.add_argument("--threads", type=int, default=0)
    r.add_argument("overrides", nargs="*")
    la = sub.add_parser("latents")
    la.add_argument("a", type=Path)
    la.add_argument("b", type=Path, nargs="?")
    la.add_argument("--vae-run", type=Path)
    p = sub.add_parser("report")
    p.add_argument("root", type=Path)
    p.add_argument("--also", default=None)
    args = ap.parse_args()
    if args.cmd == "latents":
        latents(args.a, args.b, args.vae_run)
        return 0
    if args.cmd == "report":
        report(args.root, also=args.also)
        return 0
    if args.threads:
        import torch
        torch.set_num_threads(args.threads)
    run_arm(args.out, args.device, args.permute, args.train, args.eval,
            args.steps, overrides=args.overrides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
