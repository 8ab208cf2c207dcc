#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``latent_diffusion_planning_tpu_torch/csrc``
   with nvcc (first use; seconds).
2. Holds each kernel against its plain PyTorch twin on the card, at the main
   path's shapes, and times both:
   A  MLP-IDM sampler, 8192 rows, DDIM-10 and DDPM-50 (fp32; atol 1e-4 for
      DDIM; 1e-3 for DDPM, whose first step scales eps by 1/sqrt(abar) ≈ 1e3);
   B  U-Net DDIM-10 sampler at the bench widths [64,128,256] × 1024 samples
      and the reference widths [256,512,1024] × 64 (bf16 weights; the twin
      runs in fp32 on the same bf16-rounded weights; atol 5e-3, the JAX
      package's bf16 bar);
   C  ray-caster on 1024 Lift scenes and on 64 scenes with a convex k-DOP
      prim (more than 98% of pixels within 2.0, the JAX package's bar).
3. Runs the main path: ``run_batched_eval`` of the LDP agent at the bench
   widths (seeded random weights) on 1024 kinematic Lift envs × 400 steps
   (100 decisions), with every kernel's launch count read around it, after
   an end-to-end check of ``sample_fast`` against the plain path; then
   times one decision stage by stage.

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
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3
N_ENVS, EPISODE_LEN = 1024, 400


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


def bound(flops: float, nbytes: float, bf16_flops: float = 0.0
          ) -> tuple[float, str]:
    """Least time in ms: bytes over HBM rate vs operations over the peak of
    their type (bf16 products on the tensor cores, the rest fp32 on the CUDA
    cores; the two units overlap, so the slower of them sets the time)."""
    t_ops = max(flops / PEAK_FP32_FLOPS, bf16_flops / PEAK_BF16_FLOPS) * 1e3
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
        print(f"   {what}: max_abs_err {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{what}: {err} > {tol}")

    def timing(self, what: str, ms: float, plain_ms: float) -> None:
        print(f"   {what}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"[{self.card}]", flush=True)


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
    per_row = (2 * (A + S) * H + nb * (2 * 2 * H * 4 * H + 8 * H)
               + 2 * H * A + 10 * A)
    flops = T * (per_step_once + N * per_row)
    weights = sum(p.numel() for p in net.parameters()) * 4
    nbytes = weights + 4 * (N * S + 2 * N * A + (T * N * A if with_noise else 0)
                            + 6 * T)
    return flops, nbytes


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
        smoke.check(f"A {mode}", err, tol)
        ms, plain_ms = time_ms(run_k), time_ms(run_p)
        smoke.timing(f"A {mode} N={N}", ms, plain_ms)
        flops, nbytes = idm_flops_bytes(net, N, S, A, int(ts.shape[0]),
                                        noise is not None)
        b_ms, b_by = bound(flops, nbytes)
        out[mode] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, flops=flops,
                         bytes=nbytes)
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
    for name, dd, B in (("bench", tuple(p["down_dims"]), 1024),
                        ("reference", (256, 512, 1024), 64)):
        torch.manual_seed(3)
        net = ConditionalUnet1D(25, 25, p["diffusion_step_embed_dim"], dd,
                                p["kernel_size"], p["n_groups"]).to(dev)
        twin_net = K.round_weights(net)
        g = torch.Generator(device=dev).manual_seed(4)
        gc = torch.randn(B, 25, generator=g, device=dev)
        x0 = torch.randn(B, 8, 25, generator=g, device=dev)
        packed = K.pack_params(net).to(dev)
        run_k = lambda: K.fused_unet1d_ddim_sample(net, gc, x0, ts, coefs,
                                                   packed=packed)
        run_p = lambda: K.unet1d_ddim_sample_plain(twin_net, gc, x0, ts, coefs)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        assert torch.isfinite(got).all() and got.shape == (B, 8, 25)
        smoke.check(f"B {name} {list(dd)} B={B}", err, 5e-3)
        ms, plain_ms = time_ms(run_k), time_ms(run_p)
        smoke.timing(f"B {name} B={B}", ms, plain_ms)
        elem, mm, nbytes = unet_flops_bytes(net, B, 8, int(ts.shape[0]))
        b_ms, b_by = bound(elem, nbytes, bf16_flops=mm)
        fp32_share = (mm + elem) / PEAK_FP32_FLOPS * 1e3 / ms
        nb, prog = K.choose_tile(net, 8)
        out[name] = dict(max_abs_err=err, tol=5e-3, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, bf16_flops=mm,
                         fp32_flops=elem, bytes=nbytes,
                         share_of_fp32_cuda_core_peak=fp32_share,
                         samples_per_block=nb,
                         smem_bytes=prog["smem_bytes"])
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


def phase_raycast(smoke: Smoke):
    import torch
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv, LiftState
    from latent_diffusion_planning_tpu_torch.ops import render as R
    from latent_diffusion_planning_tpu_torch.ops.kernels import raycast as K

    dev = torch.device("cuda")
    env = LiftEnv(render_images=False)
    g = torch.Generator(device=dev).manual_seed(5)
    state = env.reset(N_ENVS, g, dev)[0]
    # spread the eef around the workspace and close some grippers
    u = torch.rand(N_ENVS, 4, generator=g, device=dev)
    state = LiftState(eef_pos=state.cube_pos + (u[:, :3] - 0.5) * 0.3,
                      gripper=u[:, 3], cube_pos=state.cube_pos,
                      cube_yaw=state.cube_yaw, grasped=state.grasped,
                      t=state.t)
    out = {}
    H = W = 64
    for name, scene, cam, n_convex in (
            ("lift", env.scene(state), env.camera, 0),
            ("convex", convex_scenes(64, dev),
             R.look_at((0.55, 0.0, 1.25), (0.0, 0.0, 0.85)), 1)):
        rays = R.camera_rays(cam, H, W, dev)
        run_k = lambda: K.render_batch_cuda(scene, cam, H, W, n_convex, rays)
        run_p = lambda: R.render_batch(scene, cam, H, W)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        frac = float((diff.amax(-1) < 2.0).float().mean())
        err = float(diff.max())
        print(f"   C {name}: {frac:.4%} of pixels within 2.0 (bar 98%), "
              f"max_abs_err {err:.3e}", flush=True)
        if not (frac > 0.98 and torch.isfinite(got).all()):
            raise AssertionError(f"C {name}: {frac} of pixels within 2.0")
        ms, plain_ms = time_ms(run_k, iters=10), time_ms(run_p)
        smoke.timing(f"C {name} N={scene.pos.shape[0]}", ms, plain_ms)
        N, P = scene.pos.shape[:2]
        K_planes = scene.planes.shape[2] if n_convex else 0
        # FLOPs per pixel, counted from csrc/raycast.cu (add, mul, div, sqrt;
        # compares, min/max and selects not counted): ground plane 15,
        # shading 30; per prim 33 for the body-frame ray, then 30 for a box
        # slab or a sphere, or 15 + 12 per half-space for a k-DOP
        ops = N * H * W * (45 + 63 * (P - n_convex)
                           + (48 + 12 * K_planes) * n_convex)
        nbytes = 4 * (N * H * W * 3 + N * P * 22 + H * W * 3 + N * 4
                      + N * n_convex * K_planes * 4)
        b_ms, b_by = bound(ops, nbytes)
        out[name] = dict(max_abs_err=err, frac_within_2=frac, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         ops=ops, bytes=nbytes)
    smoke.kernels["raycast"] = dict(out["lift"])
    return out


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def phase_end_to_end_check(smoke: Smoke):
    """sample_fast on the card vs the plain path (CPU, planner weights rounded
    to bf16 like the kernel's) on 8 rendered windows and identical draws."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)

    agent = LDPAgent.create(configs.bench_agent_config(), configs.SHAPE_META,
                            seed=0, device="cuda")
    cpu = LDPAgent.create(configs.bench_agent_config(), configs.SHAPE_META,
                          seed=0, device="cpu")
    cpu.planner = K.round_weights(cpu.planner)
    env = LiftEnv()
    g = torch.Generator(device="cuda").manual_seed(6)
    _, obs = env.reset(8, g, "cuda")
    window = {k: obs[k][:, None] for k in configs.BENCH_POLICY_KEYS}
    gc = torch.Generator().manual_seed(7)
    draws = {"planner": torch.randn(8, 8, 25, generator=gc),
             "idm": torch.randn(64, 7, generator=gc)}
    got = agent.sample_fast({"obs": window}, draws=draws).cpu()
    ref = cpu.sample_fast({"obs": {k: v.cpu() for k, v in window.items()}},
                          draws=draws)
    assert got.shape == (8, 8, 7) and torch.isfinite(got).all()
    smoke.check("sample_fast cuda vs plain", float((got - ref).abs().max()),
                5e-3)
    return {"max_abs_err": float((got - ref).abs().max())}


def phase_slice(smoke: Smoke):
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine

    cfg = configs.bench_agent_config()
    agent = LDPAgent.create(cfg, configs.SHAPE_META, seed=0, device="cuda")
    env = LiftEnv(image_size=64, episode_len=EPISODE_LEN)
    run = lambda n, T, seed: engine.run_batched_eval(
        env, agent, n, seed, obs_horizon=cfg["obs_horizon"],
        action_horizon=cfg["action_horizon"], episode_len=T,
        policy_obs_keys=configs.BENCH_POLICY_KEYS, device="cuda")
    run(N_ENVS, 8, 0)                       # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    n_decisions = math.ceil(EPISODE_LEN / cfg["action_horizon"])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(N_ENVS, EPISODE_LEN, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"   launches: {counts} (decisions {n_decisions})", flush=True)
    for name, n in counts.items():
        if n != n_decisions:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{n_decisions}")
        smoke.kernels[name]["launches"] = n
    m = res["metrics"]
    hz = res["per_episode"]["horizon"]
    if not (0 <= m["success"] <= 1 and math.isfinite(m["reward"])
            and hz.min() >= 1 and hz.max() <= EPISODE_LEN):
        raise AssertionError(f"implausible metrics {m}")
    rate = N_ENVS * EPISODE_LEN / wall
    print(f"   random-weight LDP, {N_ENVS} envs x {EPISODE_LEN} steps: "
          f"{rate:.1f} computed env-steps/s, wall {wall:.3f} s, "
          f"success {m['success']:.4f}, horizon {m['horizon']:.1f} "
          f"[{smoke.card}]", flush=True)
    return dict(env_steps_per_s=rate, wall_s_run=wall, n_envs=N_ENVS,
                episode_len=EPISODE_LEN, decisions=n_decisions,
                launches=counts, metrics=m, weights="random (seed 0)")


def phase_breakdown(smoke: Smoke):
    """One decision of the main path at 1024 envs, stage by stage, each
    timed with CUDA events over repeated calls (not a trace: the stages run
    back to back here as in the engine's loop)."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv
    from latent_diffusion_planning_tpu_torch.models.agents import common
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent

    cfg = configs.bench_agent_config()
    agent = LDPAgent.create(cfg, configs.SHAPE_META, seed=0, device="cuda")
    env = LiftEnv(image_size=64, episode_len=EPISODE_LEN)
    g = torch.Generator(device="cuda").manual_seed(8)
    state = env.reset_state(N_ENVS, g, "cuda")
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
    stages = {
        "render + obs (kernel C)": lambda: env.obs(state),
        "normalize + VAE encode": lambda: agent._prepare_eval_batch(
            {"obs": window}),
        "plan (kernel B)": lambda: agent._plan(cond, x_plan, g),
        "IDM decode (kernel A)": lambda: agent._idm_decode(pairs, x_idm, g),
        "4 env transitions": lambda: [env.transition(state, acts)
                                      for _ in range(c.action_horizon)],
        "sample_fast (VAE + B + A + glue)": lambda: agent.sample_fast(
            {"obs": window}, generator=g),
    }
    out = {}
    for name, fn in stages.items():
        out[name] = time_ms(fn, iters=5)
        print(f"   {name}: {out[name]:.3f} ms [{smoke.card}]", flush=True)
    return {"ms": out, "n_envs": N_ENVS}


REPLACES = {
    "diffusion_mlp": ("latent_diffusion_planning_tpu/ops/pallas/"
                      "diffusion_mlp.py:122"),
    "diffusion_unet1d": ("latent_diffusion_planning_tpu/ops/pallas/"
                         "diffusion_unet1d.py:473"),
    "raycast": "latent_diffusion_planning_tpu/ops/pallas/raycast.py:226",
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
        smoke.phase("sample_fast end to end", lambda: phase_end_to_end_check(smoke))
        if not smoke.failures:
            smoke.phase("main path: LDP closed loop on Lift",
                        lambda: phase_slice(smoke))
            smoke.phase("one decision, stage by stage",
                        lambda: phase_breakdown(smoke))

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
