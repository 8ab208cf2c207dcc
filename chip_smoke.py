#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``latent_diffusion_planning_tpu_torch/csrc``
   with nvcc (first use; seconds).
2. Holds each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, and times both:
   A  MLP-IDM sampler, 8192 rows, DDIM-10 and DDPM-50 (fp32 results from
      3×TF32 products; atol 1e-4 for DDIM; 1e-3 for DDPM, whose first step
      scales eps by 1/sqrt(abar) ≈ 1e3), against the fp32 twin;
   B  U-Net DDIM-10 sampler at the bench widths [64,128,256] × 1024 samples,
      the reference widths [256,512,1024] × 64, and widths that need padding
      ((24, 40), 16 samples, correctness only), against the rounding twin
      (bf16 weights and bf16 conv/dense inputs, like the kernel). A function
      that rounds activations to bf16 is discontinuous: the twin moves by up
      to 2.5e-2 when its input moves by 2e-7 (``phase_unet`` measures and
      prints this), so no two summation orders agree everywhere to 5e-3. The
      bar of 5e-3 is therefore held on what rounding flips cannot move:
      after one step at least 99% of elements within 5e-3; after all ten the
      mean error within 5e-3, no element beyond 0.1, and the kernel closer
      to the rounding twin than the unrounded fp32 net is;
   C  ray-caster on 1024 kinematic Lift scenes (3 boxes), on 64 scenes with
      a convex k-DOP prim, and on 1024 physics Lift scenes (cube, two sphere
      pads, three rotated arm-link boxes) taken from states a few scripted
      steps apart: at least 99.9% of pixels within 2.0 on each set, image
      finite. The ``kernels`` line reports the physics set.
3. Runs the scripted expert on 1024 ``LiftPhysicsEnv`` envs × 80 steps on the
   card (no rendering): at least 95% of the episodes must succeed and every
   state stay finite.
4. Runs the main path: ``run_batched_eval`` of the LDP agent at the bench
   widths (seeded random weights) on 1024 ``LiftPhysicsEnv`` envs × 400
   steps (100 decisions), the bench's env, with every kernel's launch count
   read around it; then the same on 1024 kinematic ``LiftEnv`` envs × 40
   steps (10 decisions), counts read again. Both after an end-to-end check
   of ``sample_fast`` against the plain path (mean error within 5e-3, no
   action beyond 0.1, for the reason given under B). Then times one decision
   stage by stage, the physics and the render separately, the env
   transitions eagerly and from their CUDA graph.
5. Trains the LDP agent on Lift at the bench widths (``phase_training``):
   scripted demos on ``LiftPhysicsEnv`` (256 envs × 80 steps seed 0 for
   train, 32 seed 77 for eval, every frame through kernel C; successful
   episodes welded in memory), latents from the agent's seeded VAE, then the
   ``Workspace`` of ``bench_train_config()`` for ``TRAIN_STEPS`` steps at
   batch 128; both losses must be finite and fall. ``Workspace.run`` ends
   with an eval (offline action MSE through A, plan statistics through B, a
   closed loop of 256 envs × 80 steps), launch counts checked. The trained
   agent's kernels are held against their plain versions on its trained
   weights (the bars of A and B above; the packs were built from the seeded
   weights before training, so a missed repack fails here); the full state
   round-trips bit for bit, and one step from the restored state equals one
   from the live state (cuDNN deterministic); a train step is timed part
   by part with CUDA events.

Prints the card's name and power limit, a ``kernels`` JSON line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device, when the port's package is not beside this file,
or when any phase fails. ``--out PATH`` also writes the full record (every
phase's numbers) as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 on the CUDA cores, at 700 W
PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12     # H100 SXM, dense TF32 on the tensor cores
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
N_ENVS, EPISODE_LEN = 1024, 400
KINEMATIC_LEN = 40           # the kinematic LiftEnv path: 10 decisions
# the training phase: demos as tools/run_lift_pipeline.sh collects them
# (256 train envs seed 0, 32 eval envs seed 77, 80 steps), then TRAIN_STEPS
# steps at the bench's batch 128 and a closed loop of EVAL_ENVS × 80 steps
DEMO_SPLITS = (("train", 256, 0), ("eval", 32, 77))
DEMO_LEN = 80
TRAIN_STEPS = 400
EVAL_ENVS = 256
SPLIT_STEPS = 30             # train steps timed part by part (first 5 warm-up)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def time_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
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


def bound(flops: float, nbytes: float, bf16_flops: float = 0.0,
          fp32_products: float = 0.0) -> tuple[float, str]:
    """Least time in ms: bytes over HBM rate vs operations over the peak of
    their type (bf16 products on the tensor cores, the rest fp32 on the CUDA
    cores; the two units overlap, so the slower of them sets the time).
    ``fp32_products`` are products whose result must be fp32-accurate: they
    take the faster of two faithful routes, the CUDA cores beside ``flops``,
    or three TF32 tensor-core passes overlapping ``flops``."""
    cuda_route = (flops + fp32_products) / PEAK_FP32_FLOPS
    tensor_route = max(flops / PEAK_FP32_FLOPS,
                       3 * fp32_products / PEAK_TF32_FLOPS)
    t_ops = max(min(cuda_route, tensor_route),
                bf16_flops / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Smoke:
    def __init__(self, card: str):
        self.card = card
        self.record: dict = {"card": card, "phases": {}}
        self.kernels: dict = {}
        self.failures: list[str] = []

    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            info = fn()
            info = info or {}
            info["wall_s"] = time.perf_counter() - t0
            self.record["phases"][name] = info
            print(f"   ok in {info['wall_s']:.1f} s", flush=True)
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            self.failures.append(name)
            self.record["phases"][name] = {"error": traceback.format_exc()}

    def check(self, what: str, err: float, tol: float) -> None:
        ok = err <= tol
        print(f"   {what}: {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{what}: {err} > {tol}")

    def timing(self, what: str, ms: float, plain_ms: float) -> None:
        print(f"   {what}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"[{self.card}]", flush=True)

    def shape_line(self, what: str, entry: str, info: dict, flops: float,
                   peak: float, unit: str, ms: float) -> dict:
        """One line on how the kernel sits on the card: registers and spill
        of the entry the main path runs (from the build log), its launch
        geometry, the weights it streams, its achieved rate."""
        res = entry_resources(entry)
        share = flops / (ms * 1e-3) / peak
        info = {**info, **res, "achieved_flops": flops / (ms * 1e-3),
                "share_of_peak": share, "unit": unit}
        print(f"   {what}: {json.dumps(info)}", flush=True)
        print(f"   {what}: {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s = "
              f"{share:.1%} of the {unit} peak [{self.card}]", flush=True)
        return info


def entry_resources(entry: str) -> dict:
    """Registers and spill bytes ptxas reported for the kernel whose mangled
    name contains ``entry``."""
    import re
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build
    lines = _build.build_log().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            text = " ".join(lines[i:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            st = re.search(r"(\d+) bytes spill stores", text)
            ld = re.search(r"(\d+) bytes spill loads", text)
            if regs and st and ld:
                return dict(registers=int(regs.group(1)),
                            spill_store_bytes=int(st.group(1)),
                            spill_load_bytes=int(ld.group(1)))
    raise AssertionError(f"no ptxas lines for {entry} in the build log")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def idm_net(device):
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.nets.mlp import MLPDiffusion
    cfg = configs.BENCH_AGENT["idm_net"]
    torch.manual_seed(1)
    return MLPDiffusion(50, 7, cfg["time_dim"], cfg["cond_hidden_dims"],
                        "swish", cfg["n_blocks"], cfg["hidden_dim"]).to(device)


def idm_flops_bytes(net, N, S, A, T, with_noise):
    H = net.trunk.dense0.out_features
    C1 = net.cond.dense[1].out_features
    nb = len(net.trunk.blocks)
    per_step_once = 2 * sum(l.in_features * l.out_features
                            for l in net.cond.dense) + 2 * C1 * H
    # the three large products (fp32-accurate) and the elementwise rest
    products = T * N * (2 * (A + S) * H + nb * 2 * 2 * H * 4 * H)
    rest = T * (per_step_once + N * (nb * 8 * H + 2 * H * A + 10 * A))
    weights = sum(p.numel() for p in net.parameters()) * 4
    nbytes = weights + 4 * (N * S + 2 * N * A + (T * N * A if with_noise else 0)
                            + 6 * T)
    return products, rest, nbytes


def phase_mlp(smoke: Smoke):
    import torch
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import diffusion_mlp as K

    dev = torch.device("cuda")
    net = idm_net(dev)
    N, S, A = 8192, 50, 7
    g = torch.Generator(device=dev).manual_seed(2)
    s = torch.randn(N, S, generator=g, device=dev)
    x0 = torch.randn(N, A, generator=g, device=dev)
    sched = dlib.DiffusionSchedule.create(50)
    packed = K.pack_params(net).to(dev)
    out = {}
    for mode in ("ddim10", "ddpm50"):
        if mode == "ddim10":
            ts, coefs = dlib.ddim_coef_table(sched, 10)
            noise, tol = None, 1e-4
        else:
            ts, coefs = dlib.ddpm_coef_table(sched)
            noise = torch.randn(50, N, A, generator=g, device=dev)
            tol = 1e-3
        coefs_d = coefs.to(dev)
        run_k = lambda: K.fused_mlp_diffusion_sample(
            net, s, x0, ts, coefs_d, noise, packed=packed)
        run_p = lambda: K.mlp_diffusion_sample_plain(net, s, x0, ts, coefs_d,
                                                     noise)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        assert torch.isfinite(got).all() and got.shape == (N, A)
        smoke.check(f"A {mode} max_abs_err", err, tol)
        ms, plain_ms = time_ms(run_k), time_ms(run_p)
        smoke.timing(f"A {mode} N={N}", ms, plain_ms)
        products, rest, nbytes = idm_flops_bytes(
            net, N, S, A, int(ts.shape[0]), noise is not None)
        b_ms, b_by = bound(rest, nbytes, fp32_products=products)
        fp32_ms, _ = bound(rest + products, nbytes)
        print(f"   A {mode}: bound {b_ms:.3f} ms (three TF32 passes at "
              f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s); on the fp32 CUDA cores "
              f"alone it would be {fp32_ms:.3f} ms", flush=True)
        info = smoke.shape_line(
            f"A {mode}", "mlp_sampler_kernelILi4E",
            K.kernel_info(net, N, A, S, int(ts.shape[0])), 3 * products,
            PEAK_TF32_FLOPS, "TF32 tensor-core", ms)
        if info["spill_store_bytes"] or info["spill_load_bytes"]:
            raise AssertionError(f"kernel A's main-path entry spills: {info}")
        out[mode] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, fp32_route_bound_ms=fp32_ms,
                         product_flops=products, other_flops=rest,
                         bytes=nbytes, shape=info)
    smoke.kernels["diffusion_mlp"] = dict(out["ddim10"])
    return out


def unet_flops_bytes(net, B, T, steps):
    """(fp32 elementwise FLOPs, bf16-weight product FLOPs, bytes). The TPU
    kernel multiplies bf16 by bf16 with fp32 accumulation, so its products
    are counted at the bf16 tensor-core peak."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)
    recs = K.build_program(net, T, 1)["records"]
    k = net.kernel_size
    cond = net.dsed + net.global_cond_dim
    per = elem = 0
    for r in recs:
        if r[0] == K.FILM:
            cin, ch, tl = r[1:4]
            per += 2 * tl * ch * k * (cin + ch) + 2 * cond * 2 * ch
            if r[7] >= 0:
                per += 2 * tl * cin * ch
            else:
                elem += tl * ch
            elem += 2 * 12 * tl * ch         # two GroupNorm + Mish passes
        elif r[0] in (K.DOWN, K.UP):
            ch, tin = r[1:3]
            tout = tin // 2 if r[0] == K.DOWN else 2 * tin
            per += 2 * tout * ch * ch * (3 if r[0] == K.DOWN else 2)
        elif r[0] == K.FINAL_BLOCK:
            per += 2 * r[3] * r[1] * r[2] * k
            elem += 12 * r[3] * r[2]
        elif r[0] == K.FINAL_CONV:
            per += 2 * r[3] * r[1] * r[2]
    d = net.dsed
    once = 2 * (d * 4 * d + 4 * d * d)
    mm = steps * (once + B * per)
    elem = steps * B * (elem + 10 * T * net.input_dim)
    weights = sum(p.numel() for p in net.parameters()) * 2       # bf16
    nbytes = weights + 4 * (B * net.global_cond_dim + 2 * B * T * net.input_dim)
    return elem, mm, nbytes


def err_stats(a, b) -> dict:
    e = (a.double() - b.double()).abs()
    return dict(max=float(e.max()), mean=float(e.mean()),
                frac_within_5e3=float((e <= 5e-3).double().mean()))


def phase_unet(smoke: Smoke):
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)

    dev = torch.device("cuda")
    p = configs.BENCH_AGENT["planner"]
    sched = dlib.DiffusionSchedule.create(50)
    ts, coefs = dlib.ddim_coef_table(sched, 10)
    coefs = coefs.to(dev)
    out = {}
    for name, dd, B, dsed, timed in (
            ("bench", tuple(p["down_dims"]), 1024,
             p["diffusion_step_embed_dim"], True),
            ("reference", (256, 512, 1024), 64,
             p["diffusion_step_embed_dim"], True),
            ("padded", (24, 40), 16, 64, False)):
        torch.manual_seed(3)
        net = ConditionalUnet1D(25, 25, dsed, dd, p["kernel_size"],
                                p["n_groups"]).to(dev)
        twin_net = K.rounding_twin(net)
        g = torch.Generator(device=dev).manual_seed(4)
        gc = torch.randn(B, 25, generator=g, device=dev)
        x0 = torch.randn(B, 8, 25, generator=g, device=dev)
        nudge = x0 * (1 + 2e-7 * torch.randn(x0.shape, generator=g, device=dev))
        packed = K.pack_params(net).to(dev)
        run_k = lambda n=10: K.fused_unet1d_ddim_sample(
            net, gc, x0, ts[:n], coefs[:n], packed=packed)
        run_p = lambda n=10, x=x0, m=twin_net: K.unet1d_ddim_sample_plain(
            m, gc, x, ts[:n], coefs[:n])
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and got.shape == (B, 8, 25)
        one = err_stats(run_k(1), run_p(1))
        full = err_stats(got, ref)
        self_move = err_stats(ref, run_p(10, nudge))
        fp32 = err_stats(run_p(10, x0, net), ref)
        what = f"B {name} {list(dd)} B={B}"
        print(f"   {what}: after 1 step {one}", flush=True)
        print(f"   {what}: after 10 steps {full}", flush=True)
        print(f"   {what}: the twin against itself, input moved by 2e-7: "
              f"{self_move}", flush=True)
        print(f"   {what}: the unrounded fp32 net against the twin: {fp32}",
              flush=True)
        smoke.check(f"{what} share of elements beyond 5e-3 after 1 step",
                    1 - one["frac_within_5e3"], 1e-2)
        smoke.check(f"{what} mean_abs_err after 10 steps", full["mean"], 5e-3)
        smoke.check(f"{what} max_abs_err after 10 steps", full["max"], 0.1)
        if not full["mean"] < fp32["mean"]:
            raise AssertionError(f"{what}: the kernel is no closer to the "
                                 "rounding twin than the fp32 net is")
        out[name] = dict(max_abs_err=full["max"], mean_abs_err=full["mean"],
                         one_step=one, ten_steps=full, twin_self_move=self_move,
                         fp32_net_vs_twin=fp32, tol=5e-3)
        if not timed:
            continue
        ms, plain_ms = time_ms(run_k), time_ms(run_p)
        smoke.timing(f"B {name} B={B}", ms, plain_ms)
        elem, mm, nbytes = unet_flops_bytes(net, B, 8, int(ts.shape[0]))
        b_ms, b_by = bound(elem, nbytes, bf16_flops=mm)
        shape = K.kernel_info(net, B, 8, int(ts.shape[0]))
        # the kernel is instantiated for 2, 4 or 8 row tiles of 16
        row_tiles = -(-shape["samples_per_block"] * 8 // 16)
        entry = next(n for n in (2, 4, 8) if row_tiles <= n)
        info = smoke.shape_line(
            f"B {name}", f"unet1d_sampler_kernelILi{entry}E", shape, mm,
            PEAK_BF16_FLOPS, "bf16 tensor-core", ms)
        by_nb = {}
        for nb in K.NB_CHOICES:
            try:
                by_nb[nb] = time_ms(lambda: K.fused_unet1d_ddim_sample(
                    net, gc, x0, ts, coefs, packed=packed, nb=nb), iters=3)
            except ValueError:
                continue        # this many samples do not fit a block
        print(f"   B {name}: ms by samples per block {by_nb} "
              f"[{smoke.card}]", flush=True)
        out[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, bf16_flops=mm, fp32_flops=elem,
                         bytes=nbytes, shape=info, ms_by_samples_per_block=by_nb)
    smoke.kernels["diffusion_unet1d"] = dict(out["bench"])
    return out


def convex_scenes(n, device):
    """n scenes: a rotated octahedron-capped box (k-DOP, 14 half-spaces)
    first, then a sphere and a box."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops import render as R
    axes = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    diag = [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)]
    n_k = torch.tensor(axes + diag, dtype=torch.float32)
    n_k = n_k / n_k.norm(dim=-1, keepdim=True)
    d_k = torch.tensor([0.04] * 6 + [0.05] * 8)
    hull = torch.cat([n_k, d_k[:, None]], -1)
    pad = torch.zeros(14, 4)
    pad[:, 3] = 1.0
    yaw = torch.linspace(-0.6, 0.6, n)
    pos = torch.tensor([[0.05, 0.0, 0.86], [0.0, 0.1, 0.9], [-0.05, -0.08, 0.84]])
    scene = R.Scene(
        pos=pos.expand(n, 3, 3).clone(),
        rot=torch.stack([R.euler_z(yaw), torch.eye(3).expand(n, 3, 3),
                         R.euler_z(-yaw)], 1),
        size=torch.tensor([[0.05, 0.05, 0.05], [0.03, 0.0, 0.0],
                           [0.02, 0.03, 0.04]]).expand(n, 3, 3),
        color=torch.tensor([[0.85, 0.1, 0.1], [0.2, 0.4, 0.8],
                            [0.3, 0.7, 0.3]]).expand(n, 3, 3),
        kind=torch.tensor([2, 1, 0], dtype=torch.int32).expand(n, 3),
        plane_z=torch.full((n,), 0.8),
        plane_color=torch.tensor(R.PLANE_COLOR).expand(n, 3),
        planes=torch.stack([hull, pad, pad]).expand(n, 3, 14, 4))
    return R.Scene(**{k: (v.to(device).contiguous() if v is not None else v)
                      for k, v in scene.__dict__.items()})


def physics_states(env, n, device, seed=5, spread=12):
    """n ``LiftPhysicsEnv`` states a few scripted steps apart: env i has
    taken ``i % spread`` + 1 steps of the scripted expert, so the arm, the
    pads and (late in the spread) the cube are in different places."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    state = env.reset_state(n, g)
    keep = state
    steps = torch.arange(n, device=device) % spread + 1
    for i in range(spread):
        state = env.transition(state, env.scripted_action(state))[0]
        took = steps == i + 1
        keep = keep.map(lambda k, s: torch.where(
            took.reshape((-1,) + (1,) * (s.ndim - 1)), s, k), state)
    return keep


def scene_bytes(scene, n_convex) -> int:
    """Bytes of the scene the kernel must read: each field once (a field
    broadcast over envs is stored once)."""
    total = 0
    for name, t in scene.__dict__.items():
        if t is None or (name == "planes" and not n_convex):
            continue
        unique = t.numel() if (t.shape[0] < 2 or t.stride(0)) else (
            t.numel() // t.shape[0])
        total += 4 * unique
    return total


def phase_raycast(smoke: Smoke):
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv, LiftState
    from latent_diffusion_planning_tpu_torch.ops import render as R
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build
    from latent_diffusion_planning_tpu_torch.ops.kernels import raycast as K

    dev = torch.device("cuda")
    env = LiftEnv(render_images=False)
    g = torch.Generator(device=dev).manual_seed(5)
    state = env.reset(N_ENVS, g)[0]
    # spread the eef around the workspace and close some grippers
    u = torch.rand(N_ENVS, 4, generator=g, device=dev)
    state = LiftState(eef_pos=state.cube_pos + (u[:, :3] - 0.5) * 0.3,
                      gripper=u[:, 3], cube_pos=state.cube_pos,
                      cube_yaw=state.cube_yaw, grasped=state.grasped,
                      t=state.t)
    penv = configs.make_bench_env(render_images=False)
    pstate = physics_states(penv, N_ENVS, dev)
    out = {}
    H = W = 64
    for name, scene, cam, n_convex in (
            ("lift", env.scene(state), env.camera, 0),
            ("convex", convex_scenes(64, dev),
             R.look_at((0.55, 0.0, 1.25), (0.0, 0.0, 0.85)), 1),
            ("physics", penv.scene(pstate), penv.camera, 0)):
        rays = R.camera_rays(cam, H, W, dev)
        run_k = lambda: K.render_batch_cuda(scene, cam, H, W, n_convex, rays)
        run_p = lambda: R.render_batch(scene, cam, H, W)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        frac = float((diff.amax(-1) < 2.0).double().mean())
        err = float(diff.max())
        print(f"   C {name}: {frac:.4%} of pixels within 2.0 (bar 99.9%), "
              f"max_abs_err {err:.3e}", flush=True)
        if not (frac >= 0.999 and torch.isfinite(got).all()):
            raise AssertionError(f"C {name}: {frac} of pixels within 2.0")
        ms, plain_ms = time_ms(run_k, iters=20), time_ms(run_p)
        smoke.timing(f"C {name} N={scene.pos.shape[0]}", ms, plain_ms)
        args, _out, _keep = K.launch_args(scene, cam, H, W, n_convex, rays)
        fn = _build.function("ldp_raycast", K.ARGTYPES)
        stream = torch.cuda.current_stream().cuda_stream
        launch_ms = time_ms(lambda: fn(*args, stream), iters=20)
        print(f"   C {name}: the launch alone (arguments marshalled once) "
              f"{launch_ms:.4f} ms [{smoke.card}]", flush=True)
        N, P = scene.pos.shape[:2]
        K_planes = scene.planes.shape[2] if n_convex else 0
        kinds = scene.kind[0, n_convex:].tolist()
        n_box = sum(1 for k in kinds if k == 0)
        n_sphere = len(kinds) - n_box
        # FLOPs per pixel per env, counted from csrc/raycast.cu (an fma is
        # 2; a reciprocal, a division, a square root 1; compares, min/max
        # and selects 0; the normal of a nearer hit, taken for few pixels,
        # 0): plane hit 1, shading 21 + 1 + 3, sky 2, clip * 255 3, checker
        # tint 12; per box the bounding-sphere test 7, and only for the rays
        # that pass it (counted on this run's scenes) the body-frame
        # direction 15, 3 reciprocals, 6 products; per sphere 5 + 2 + 1 + 2;
        # per k-DOP 15 and 6 a half-space
        boxes = [n_convex + i for i, k in enumerate(kinds) if k == 0]
        slab_tests = 0
        if boxes:
            oc = torch.tensor(cam.pos, device=dev) - scene.pos[:, boxes]
            b = oc @ rays.reshape(-1, 3).t()                  # (N, boxes, HW)
            c_bound = (oc * oc).sum(-1) - 1.0201 * (
                scene.size[:, boxes] ** 2).sum(-1)
            passes = (b * b - c_bound[..., None] >= 0) & ~(
                (b > 0) & (c_bound[..., None] > 0))
            slab_tests = int(passes.sum())
        per_pixel = (43 + 7 * n_box + 10 * n_sphere
                     + (15 + 6 * K_planes) * n_convex)
        ops = N * H * W * per_pixel + 24 * slab_tests
        per_pixel = ops / (N * H * W)
        nbytes = 4 * (N * H * W * 3 + H * W * 3 + 12) + scene_bytes(
            scene, n_convex)
        b_ms, b_by = bound(ops, nbytes)
        E = args[-1]
        print(f"   C {name}: {slab_tests / max(1, N * H * W * n_box):.2%} of "
              "the (ray, box) pairs pass the bounding sphere", flush=True)
        info = smoke.shape_line(
            f"C {name}", "raycast_kernelILb1E",
            dict(pixels_per_thread=4, pixels_per_block=1024,
                 envs_per_block=E, grid=[-(-H * W // 1024), -(-N // E)],
                 smem_bytes=K.smem_bytes(P, K_planes, n_convex, E),
                 flops_per_pixel=per_pixel, weight_bytes_streamed=0), ops,
            PEAK_FP32_FLOPS, "fp32 CUDA-core", ms)
        out[name] = dict(max_abs_err=err, frac_within_2=frac, ms=ms,
                         launch_only_ms=launch_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
                         shape=info)
    smoke.kernels["raycast"] = dict(out["physics"])
    return out


def phase_expert(smoke: Smoke):
    """The physics checked on the card by the repo's own means: the scripted
    expert must lift the cube in at least 95% of 1024 envs within 80 steps
    (the JAX package's own test asks 6 of 6)."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs

    env = configs.make_bench_env(episode_len=80, render_images=False)
    g = torch.Generator(device="cuda").manual_seed(9)
    state = env.reset_state(N_ENVS, g)
    success = torch.zeros(N_ENVS, dtype=torch.bool, device="cuda")
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(80):
        state, reward, ok = env.transition(state, env.scripted_action(state))
        success |= ok
        for leaf in (state.bodies.pos, state.bodies.quat, state.bodies.linvel,
                     state.bodies.angvel, state.qpos, reward):
            finite &= torch.isfinite(leaf).all()
    rate = float(success.float().mean())
    wall = time.perf_counter() - t0
    print(f"   scripted expert, {N_ENVS} physics envs x 80 steps: success "
          f"{rate:.4f} (bar 0.95), all finite {bool(finite)}, wall "
          f"{wall:.3f} s incl. the graph's capture [{smoke.card}]", flush=True)
    if not (rate >= 0.95 and bool(finite)):
        raise AssertionError(f"scripted expert: success {rate}, finite "
                             f"{bool(finite)}")
    return dict(success=rate, finite=bool(finite), wall_s_run=wall)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def phase_end_to_end_check(smoke: Smoke):
    """sample_fast on the card vs the plain path (CPU, the planner replaced
    by its rounding twin) on 8 rendered windows and identical draws."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)

    agent = LDPAgent.create(configs.bench_agent_config(), configs.SHAPE_META,
                            seed=0, device="cuda")
    cpu = LDPAgent.create(configs.bench_agent_config(), configs.SHAPE_META,
                          seed=0, device="cpu")
    cpu.planner = K.rounding_twin(cpu.planner)
    env = configs.make_bench_env()
    obs = env.obs(physics_states(env, 8, "cuda", seed=6, spread=8))
    window = {k: obs[k][:, None] for k in configs.BENCH_POLICY_KEYS}
    gc = torch.Generator().manual_seed(7)
    draws = {"planner": torch.randn(8, 8, 25, generator=gc),
             "idm": torch.randn(64, 7, generator=gc)}
    got = agent.sample_fast({"obs": window}, draws=draws).cpu()
    ref = cpu.sample_fast({"obs": {k: v.cpu() for k, v in window.items()}},
                          draws=draws)
    assert got.shape == (8, 8, 7) and torch.isfinite(got).all()
    # the planner on the card and its rounding twin round bf16 activations
    # apart where a value sits on a boundary (see phase_unet), so the bar of
    # 5e-3 is held on the mean, and no action may be beyond 0.1
    stats = err_stats(got, ref)
    print(f"   sample_fast cuda vs plain: {stats}", flush=True)
    smoke.check("sample_fast cuda vs plain mean_abs_err", stats["mean"], 5e-3)
    smoke.check("sample_fast cuda vs plain max_abs_err", stats["max"], 0.1)
    return stats


def phase_slice(smoke: Smoke):
    """The main path on the bench's env (``LiftPhysicsEnv``, 1024 envs × 400
    steps), then on the kinematic ``LiftEnv`` (1024 × 40), each with the
    launch counts set to 0 just before and read just after."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine

    cfg = configs.bench_agent_config()
    agent = LDPAgent.create(cfg, configs.SHAPE_META, seed=0, device="cuda")
    out = {}
    for label, env, T in (
            ("physics", configs.make_bench_env(EPISODE_LEN), EPISODE_LEN),
            ("kinematic", LiftEnv(image_size=64, episode_len=KINEMATIC_LEN),
             KINEMATIC_LEN)):
        run = lambda n, steps, seed: engine.run_batched_eval(
            env, agent, n, seed, obs_horizon=cfg["obs_horizon"],
            action_horizon=cfg["action_horizon"], episode_len=steps,
            policy_obs_keys=configs.BENCH_POLICY_KEYS, device="cuda")
        run(N_ENVS, 8, 0)       # warm-up: cuDNN plans, allocator, the graph
        torch.cuda.synchronize()
        n_decisions = math.ceil(T / cfg["action_horizon"])
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = run(N_ENVS, T, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        print(f"   {label}: launches {counts} (decisions {n_decisions})",
              flush=True)
        for name, n in counts.items():
            if n != n_decisions:
                raise AssertionError(f"{label}: {name} launched {n} times, "
                                     f"expected {n_decisions}")
            if label == "physics":
                smoke.kernels[name]["launches"] = n
        m = res["metrics"]
        hz = res["per_episode"]["horizon"]
        if not (0 <= m["success"] <= 1 and math.isfinite(m["reward"])
                and hz.min() >= 1 and hz.max() <= T):
            raise AssertionError(f"{label}: implausible metrics {m}")
        rate = N_ENVS * T / wall
        print(f"   {label}: random-weight LDP, {N_ENVS} envs x {T} steps: "
              f"{rate:.1f} computed env-steps/s, wall {wall:.3f} s, "
              f"{wall / n_decisions * 1e3:.2f} ms a decision, "
              f"success {m['success']:.4f}, horizon {m['horizon']:.1f} "
              f"[{smoke.card}]", flush=True)
        out[label] = dict(env_steps_per_s=rate, wall_s_run=wall, n_envs=N_ENVS,
                          episode_len=T, decisions=n_decisions,
                          launches=counts, metrics=m,
                          weights="random (seed 0)")
    return out


def phase_breakdown(smoke: Smoke):
    """One decision of the main path at 1024 envs, stage by stage, each
    timed with CUDA events over repeated calls (not a trace: the stages run
    back to back here as in the engine's loop). The env's stages are timed
    on the physics env (transitions eagerly and from the CUDA graph, the
    render apart from the rest of the observation) and, under their own
    names, on the kinematic env."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    from latent_diffusion_planning_tpu_torch.envs.physics import kinematics
    from latent_diffusion_planning_tpu_torch.models.agents import common
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent

    cfg = configs.bench_agent_config()
    agent = LDPAgent.create(cfg, configs.SHAPE_META, seed=0, device="cuda")
    env = configs.make_bench_env(EPISODE_LEN)
    eager = configs.make_bench_env(EPISODE_LEN, cuda_graph=False)
    kin = LiftEnv(image_size=64, episode_len=EPISODE_LEN)
    g = torch.Generator(device="cuda").manual_seed(8)
    state = physics_states(env, N_ENVS, "cuda", seed=8)
    kstate = kin.reset_state(N_ENVS, g)
    c = agent.config
    obs = env.obs(state)
    window = {k: obs[k][:, None] for k in configs.BENCH_POLICY_KEYS}
    batch = agent._prepare_eval_batch({"obs": window})
    emb = agent._obs_cond(batch["obs"])
    cond = emb[:, 0]
    x_plan = torch.randn(N_ENVS, c.pred_horizon, c.obs_dim, device="cuda")
    plan = torch.cat([emb, agent._plan(cond, x_plan, g)], 1)
    pairs = common.consecutive_pairs(plan)
    x_idm = torch.randn(pairs.shape[0], c.action_dim, device="cuda")
    acts = torch.rand(N_ENVS, 7, device="cuda") * 2 - 1
    chain = env._const("cuda")["chain"]
    positions = kinematics.fk(chain, state.qpos)[0]
    scene = env.scene(state, positions)
    steps = range(c.action_horizon)
    stages = {
        "physics env: render + obs (fk, scene, kernel C)":
            lambda: env.obs(state),
        "physics env: scene + render (kernel C)":
            lambda: env.render(state),
        "physics env: render alone (kernel C through its wrapper)":
            lambda: env.render_scene(scene),
        "physics env: 4 transitions, CUDA graph":
            lambda: [env.transition(state, acts) for _ in steps],
        "physics env: 4 transitions, eager":
            lambda: [eager.transition(state, acts) for _ in steps],
        "kinematic env: render + obs (kernel C)": lambda: kin.obs(kstate),
        "kinematic env: 4 transitions":
            lambda: [kin.transition(kstate, acts) for _ in steps],
        "normalize + VAE encode": lambda: agent._prepare_eval_batch(
            {"obs": window}),
        "plan (kernel B)": lambda: agent._plan(cond, x_plan, g),
        "IDM decode (kernel A)": lambda: agent._idm_decode(pairs, x_idm, g),
        "sample_fast (VAE + B + A + glue)": lambda: agent.sample_fast(
            {"obs": window}, generator=g),
    }
    out = {}
    for name, fn in stages.items():
        out[name] = time_ms(fn, iters=5)
        print(f"   {name}: {out[name]:.3f} ms [{smoke.card}]", flush=True)
    # the eager step's host time: how long the host takes to enqueue it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eager.transition(state, acts)
    host = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    print(f"   physics env: host time to enqueue one eager transition "
          f"{host:.3f} ms [{smoke.card}]", flush=True)
    out["physics env: host ms to enqueue one eager transition"] = host
    return {"ms": out, "n_envs": N_ENVS}


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """Nested dicts/lists of tensors and numbers → {path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    return {k2: v2 for k, v in items for k2, v2 in _flat(v, f"{prefix}{k}.").items()}


def _max_diff(a, b) -> float:
    """Largest |a - b| over every leaf of two states (inf if their keys,
    shapes or plain values differ)."""
    import torch
    a, b = _flat(a), _flat(b)
    if a.keys() != b.keys():
        return math.inf
    worst = 0.0
    for k, x in a.items():
        y = b[k]
        if not isinstance(x, torch.Tensor):
            if x != y:
                return math.inf
        elif x.shape != y.shape:
            return math.inf
        elif x.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def phase_training(smoke: Smoke):
    """The training phase in a scratch run directory under the checkout's
    git-ignored ``build/``, removed after."""
    import shutil
    import tempfile
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build))
    try:
        return _train_and_check(smoke, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _train_and_check(smoke: Smoke, work: Path):
    """LDP training on Lift at the bench widths, through the port's entry
    points: scripted demos on ``LiftPhysicsEnv`` (every frame rendered by
    kernel C), welded in memory, VAE-encoded latents, the ``Workspace`` from
    ``bench_train_config()`` for ``TRAIN_STEPS`` steps (its last act is
    ``eval``: offline metrics through kernels A and B, then a closed loop of
    ``EVAL_ENVS`` × 80 steps through C, B and A), the trained agent's kernels
    against their plain versions, the state's round trip, and a train step
    timed part by part."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.latents import encode_latents
    from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
    from latent_diffusion_planning_tpu_torch.models.agents import common
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA, diffusion_unet1d as KB)
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace

    dev = torch.device("cuda")
    out: dict = {}
    cfg = configs.bench_train_config()
    meta = cfg["data"]["meta"]
    agent_cfg = {**cfg["agent"], "obs_normalization": meta["obs_normalization"]}

    # 1. demos: the scripted expert on the bench's env, successful episodes
    env = configs.make_bench_env(episode_len=DEMO_LEN)
    env_meta = {"env_name": "LiftPhysicsEnv",
                "env_kwargs": dict(configs.BENCH_ENV, episode_len=DEMO_LEN)}
    keys = list(meta["lowdim_obs"]) + ["agentview_image"]
    welded = {}
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for split, n, seed in DEMO_SPLITS:
        col = engine.run_scripted_collection(env, n, seed, device=dev)
        rate = float(col["success"].any(1).float().mean())
        w = welded[split] = weld_collection(
            col, obs_keys=keys, env_meta=env_meta, successful_only=True,
            name=f"lift/{split}")
        del col
        print(f"   demos {split}: {n} envs x {DEMO_LEN} steps, seed {seed}: "
              f"expert success {rate:.4f}, {w.n_demos} demos, "
              f"{w.total_steps} steps welded [{smoke.card}]", flush=True)
        out[f"demos_{split}"] = dict(envs=n, seed=seed, expert_success=rate,
                                     demos=w.n_demos, steps=w.total_steps)
        if w.n_demos == 0:
            raise AssertionError(f"no successful {split} demos")
    torch.cuda.synchronize()
    out["collect_s"] = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {"diffusion_mlp": 0, "diffusion_unet1d": 0,
            "raycast": len(DEMO_SPLITS) * (DEMO_LEN + 1)}
    print(f"   collection: {out['collect_s']:.3f} s, launches {counts} "
          f"(expected {want}) [{smoke.card}]", flush=True)
    if counts != want:
        raise AssertionError(f"collection launches {counts} != {want}")

    # 2. the Workspace over the welded splits; latents from its agent's VAE
    cfg.update(n_grad_steps=TRAIN_STEPS, n_eval_episodes=EVAL_ENVS,
               eval_every=0, save_every=0, log_every=100)
    cfg["data"]["env_params"]["env"]["episode_len"] = DEMO_LEN
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=welded["train"], eval=welded["eval"],
                       device=dev)
    ws = Workspace(cfg, work, data=data, device=dev)
    ws.init_agent()
    agent = ws.agent
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bounds = [encode_latents(welded[s], agent.vae, ["agentview_image"])
              for s, _, _ in DEMO_SPLITS]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    frames = sum(w.total_steps for w in welded.values())
    min_z, max_z = min(b[0] for b in bounds), max(b[1] for b in bounds)
    print(f"   latents: {frames} frames in {secs:.3f} s = {frames / secs:.1f} "
          f"frames/s, min_z {min_z:.4f} max_z {max_z:.4f} (seeded VAE at "
          f"the bench widths) [{smoke.card}]", flush=True)
    out.update(latent_frames=frames, latent_s=secs,
               latent_frames_per_s=frames / secs, min_z=min_z, max_z=max_z)

    # prime the kernels' packs with the seeded weights: a repack that the
    # updates failed to trigger would show in the checks of step 4
    primer = next(data.eval_dataloader())
    agent.sample_action(primer)
    agent.sample_plan_stats(primer)
    seeded = LDPAgent.create(agent_cfg, meta["shape_meta"], seed=cfg["seed"],
                             device=dev)

    # 3. train (Workspace.run ends with a snapshot and an eval)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ws.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    curve = ws.loss_curve()
    sps = TRAIN_STEPS / ws.train_seconds
    first = {k: float(v[:20].mean()) for k, v in curve.items()}
    last = {k: float(v[-20:].mean()) for k, v in curve.items()}
    finite = all(bool(torch.isfinite(v).all()) for v in curve.values())
    print(f"   train: {TRAIN_STEPS} steps at batch {cfg['batch_size']} in "
          f"{ws.train_seconds:.3f} s = {sps:.2f} steps/s, "
          f"{1e3 / sps:.2f} ms a step; run() with its snapshot and eval "
          f"{run_s:.3f} s; peak memory {peak / 2**20:.1f} MiB "
          f"[{smoke.card}]", flush=True)
    for k in ("plan_loss", "idm_loss"):
        print(f"   {k}: mean of the first 20 steps {first[k]:.5f}, of the "
              f"last 20 {last[k]:.5f}", flush=True)
    # An ε-prediction loss starts near 1 (the target is unit noise and the
    # seeded nets output about 0); the warm-up reaches 3e-4 at step 200 and
    # the nets fit the noise of 128-window batches well below 1 within a few
    # hundred steps. The bar asks only that it falls: the last 20 steps'
    # mean below the first 20's, for both losses, and every value finite.
    if not finite:
        raise AssertionError("a training loss is not finite")
    for k in ("plan_loss", "idm_loss"):
        if not last[k] < first[k]:
            raise AssertionError(f"{k} did not fall: {first[k]} -> {last[k]}")
    out.update(train_steps=TRAIN_STEPS, batch=cfg["batch_size"],
               train_s=ws.train_seconds, steps_per_s=sps,
               ms_per_step=1e3 / sps, run_s=run_s, peak_mib_run=peak / 2**20,
               loss_first20=first, loss_last20=last)

    # the eval that ended run(): launch counts, offline metrics, closed loop
    ev = ws.last_eval
    n_dec = math.ceil(DEMO_LEN / cfg["action_horizon"])
    counts = kernels.launch_counts()
    want = {"diffusion_mlp": 2 + n_dec, "diffusion_unet1d": 2 + n_dec,
            "raycast": n_dec}
    print(f"   eval: launches {counts} (expected {want}: one offline batch "
          f"of each split through A and B, then {n_dec} decisions)",
          flush=True)
    if counts != want:
        raise AssertionError(f"eval launches {counts} != {want}")
    for split in ("train", "eval"):
        print(f"   eval {split}: action_mse {ev[f'{split}_action_mse']:.5f}, "
              f"plan_mse {ev[f'{split}_plan_mse']:.6f} against "
              f"plan_mse_persist {ev[f'{split}_plan_mse_persist']:.6f} "
              f"(target var {ev[f'{split}_plan_target_var']:.6f})", flush=True)
    print(f"   closed loop, {EVAL_ENVS} envs x {DEMO_LEN} steps after "
          f"{TRAIN_STEPS} steps (a reading: a few hundred steps do not make "
          f"a policy): success {ev['success']:.4f}, horizon "
          f"{ev['horizon']:.2f}, {ev['env_steps_per_sec']:.1f} env-steps/s "
          f"[{smoke.card}]", flush=True)
    bad = [k for k, v in ev.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"eval metrics not finite: {bad}")
    out.update(eval=ev, eval_launches=counts)

    # 4. the trained agent's kernels against their plain versions, on its
    # trained weights (its packs were primed with the seeded ones)
    batch = agent._prepare_eval_batch(next(data.eval_dataloader()))
    emb = agent._obs_cond(batch["obs"])
    g = torch.Generator(device=dev).manual_seed(11)
    pairs = common.consecutive_pairs(emb)
    x_idm = torch.randn(pairs.shape[0], 7, generator=g, device=dev)
    ts, coefs = agent._table(agent.idm_sched, agent.config.idm_inference_steps)
    clip = agent._clip(agent.idm_sched)
    got = agent._idm_decode(pairs, x_idm, None)
    ref = KA.mlp_diffusion_sample_plain(agent.idm, pairs, x_idm, ts, coefs,
                                        None, clip)
    away = float((KA.mlp_diffusion_sample_plain(
        seeded.idm, pairs, x_idm, ts, coefs, None, clip) - ref).abs().max())
    err_a = float((got - ref).abs().max())
    print(f"   trained A ({pairs.shape[0]} rows, DDIM-"
          f"{agent.config.idm_inference_steps}): the plain net on the seeded "
          f"weights is {away:.3e} away from the trained", flush=True)
    smoke.check("trained A max_abs_err vs plain on the trained weights",
                err_a, 1e-4)
    cond = emb[:, 0]
    x_plan = torch.randn(emb.shape[0], 8, emb.shape[2], generator=g,
                         device=dev)
    ts, coefs = agent._table(agent.planner_sched,
                             agent.config.planner_inference_steps)
    clip = agent._clip(agent.planner_sched)
    plain = lambda net: KB.unet1d_ddim_sample_plain(net, cond, x_plan, ts,
                                                    coefs, clip)
    ref = plain(KB.rounding_twin(agent.planner))
    full = err_stats(agent._plan(cond, x_plan, None), ref)
    fp32 = err_stats(plain(agent.planner), ref)
    stale = err_stats(plain(KB.rounding_twin(seeded.planner)), ref)
    print(f"   trained B ({emb.shape[0]} samples): {full}; the fp32 net "
          f"{fp32}; the seeded weights' twin {stale}", flush=True)
    smoke.check("trained B mean_abs_err vs the rounding twin", full["mean"],
                5e-3)
    smoke.check("trained B max_abs_err vs the rounding twin", full["max"], 0.1)
    if not full["mean"] < fp32["mean"]:
        raise AssertionError("trained B: no closer to the rounding twin than "
                             "the fp32 net is")
    out.update(trained_a_max_abs_err=err_a, trained_a_seeded_away=away,
               trained_b=full, trained_b_fp32=fp32, trained_b_seeded=stale)

    # the cost of a repack, paid at the first sample after an update
    for name, mod, net in (("planner", KB, agent.planner),
                           ("idm", KA, agent.idm)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            mod.pack_params(net).to(dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"   pack_params({name}) + copy to the card: {ms:.3f} ms "
              f"[{smoke.card}]", flush=True)
        out[f"pack_ms_{name}"] = ms

    # 5. round trip of the full state, then one step from each copy
    path = ws.ckpt.list_states()[-1]
    restored = LDPAgent.create(agent_cfg, meta["shape_meta"],
                               seed=cfg["seed"] + 1, device=dev)
    ws.ckpt.restore_state(path, restored)
    n_leaves = len(_flat(agent.state_dict()))
    diff = _max_diff(agent.state_dict(), restored.state_dict())
    print(f"   state round trip through {path.name}: {n_leaves} leaves, "
          f"max |diff| {diff}", flush=True)
    if diff != 0.0:
        raise AssertionError(f"restored state differs: {diff}")
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        step_batch = next(data.train_dataloader())
        for ag in (agent, restored):
            ag.update(step_batch, ws.step,
                      torch.Generator(device=dev).manual_seed(12))
        diff = _max_diff(agent.state_dict(), restored.state_dict())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            prev)
    print(f"   one step from the restored and from the live state (same "
          f"batch and draws, cuDNN deterministic): max |diff| {diff}",
          flush=True)
    if diff != 0.0:
        raise AssertionError(f"a step from the restored state differs: {diff}")
    out.update(roundtrip_leaves=n_leaves, roundtrip_step_max_diff=diff)

    # 6. where a train step's time goes (CUDA events, on the restored copy)
    ds = data.device_dataset("train")
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(SPLIT_STEPS)]
    host = []
    torch.cuda.reset_peak_memory_stats()
    for e0, e1, e2, e3 in events:
        h0 = time.perf_counter()
        e0.record()
        step_batch = ds.sample(cfg["batch_size"], g)
        e1.record()
        h1 = time.perf_counter()
        restored.backward(step_batch, True, True, g)
        e2.record()
        h2 = time.perf_counter()
        restored.apply_gradients(True, True)
        e3.record()
        host.append((h1 - h0, h2 - h1, time.perf_counter() - h2))
    torch.cuda.synchronize()
    peak_steps = torch.cuda.max_memory_allocated()
    parts = ("gather", "forward+backward", "optimizer")
    timed = SPLIT_STEPS - 5
    split_ms = {p: sum(ev[j].elapsed_time(ev[j + 1]) for ev in events[5:])
                / timed for j, p in enumerate(parts)}
    host_ms = {p: sum(h[j] for h in host[5:]) * 1e3 / timed
               for j, p in enumerate(parts)}
    print(f"   a train step, device timeline between events (mean of "
          f"{timed}): {json.dumps(split_ms)} ms; host time to enqueue: "
          f"{json.dumps(host_ms)} ms; peak memory over these steps "
          f"{peak_steps / 2**20:.1f} MiB [{smoke.card}]", flush=True)
    out.update(step_split_ms=split_ms, step_host_ms=host_ms,
               peak_mib_train_steps=peak_steps / 2**20)
    return out


REPLACES = {   # the pl.pallas_call of each TPU kernel
    "diffusion_mlp": ("latent_diffusion_planning_tpu/ops/pallas/"
                      "diffusion_mlp.py:145"),
    "diffusion_unet1d": ("latent_diffusion_planning_tpu/ops/pallas/"
                         "diffusion_unet1d.py:533"),
    "raycast": "latent_diffusion_planning_tpu/ops/pallas/raycast.py:268",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full record as JSON here")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to measure", file=sys.stderr)
        return 2
    try:
        from latent_diffusion_planning_tpu_torch.ops.kernels import _build
    except ImportError:
        print("the port's package is not beside chip_smoke.py", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    smoke = Smoke(card)

    def build():
        t0 = time.perf_counter()
        _build.library()
        secs = time.perf_counter() - t0
        print(f"   kernels built in {secs:.1f} s", flush=True)
        for line in _build.build_log().splitlines():
            if any(w in line for w in ("registers", "spill", "==",
                                       "Compiling entry function")):
                print("   " + line.strip(), flush=True)
        return {"build_s": secs}

    smoke.phase("build", build)
    if not smoke.failures:
        smoke.phase("kernel A: MLP-IDM sampler", lambda: phase_mlp(smoke))
        smoke.phase("kernel B: U-Net DDIM sampler", lambda: phase_unet(smoke))
        smoke.phase("kernel C: ray-caster", lambda: phase_raycast(smoke))
        smoke.phase("physics: scripted expert on LiftPhysicsEnv",
                    lambda: phase_expert(smoke))
        smoke.phase("sample_fast end to end", lambda: phase_end_to_end_check(smoke))
        if not smoke.failures:
            smoke.phase("main path: LDP closed loop on Lift, physics then "
                        "kinematic", lambda: phase_slice(smoke))
            smoke.phase("one decision, stage by stage",
                        lambda: phase_breakdown(smoke))
            smoke.phase("training: LDP on Lift at the bench widths",
                        lambda: phase_training(smoke))

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {**smoke.record, "kernels": smoke.kernels,
             "failures": smoke.failures}, indent=1, default=str))
    if smoke.failures:
        print(f"FAILED phases: {smoke.failures}", file=sys.stderr)
        return 1

    line = []
    for name, k in smoke.kernels.items():
        line.append({
            "name": name, "route": "cuda",
            "source": f"latent_diffusion_planning_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": k["launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
