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
   C  ray-caster on 1024 Lift scenes and on 64 scenes with a convex k-DOP
      prim (more than 98% of pixels within 2.0, the JAX package's bar).
3. Runs the main path: ``run_batched_eval`` of the LDP agent at the bench
   widths (seeded random weights) on 1024 kinematic Lift envs × 400 steps
   (100 decisions), with every kernel's launch count read around it, after
   an end-to-end check of ``sample_fast`` against the plain path (mean
   error within 5e-3, no action beyond 0.1, for the reason given under B); then
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
PEAK_TF32_FLOPS = 495e12     # H100 SXM, dense TF32 on the tensor cores
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


def phase_raycast(smoke: Smoke):
    import torch
    from latent_diffusion_planning_tpu_torch.envs.lift import LiftEnv, LiftState
    from latent_diffusion_planning_tpu_torch.ops import render as R
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
        info = smoke.shape_line(
            f"C {name}", "raycast_kernel",
            dict(pixels_per_block=256, grid=[-(-H * W // 256), N],
                 smem_bytes=4 * (P * 22 + n_convex * K_planes * 4),
                 weight_bytes_streamed=0), ops, PEAK_FP32_FLOPS,
            "fp32 CUDA-core", ms)
        out[name] = dict(max_abs_err=err, frac_within_2=frac, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         ops=ops, bytes=nbytes, shape=info)
    smoke.kernels["raycast"] = dict(out["lift"])
    return out


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def phase_end_to_end_check(smoke: Smoke):
    """sample_fast on the card vs the plain path (CPU, the planner replaced
    by its rounding twin) on 8 rendered windows and identical draws."""
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
    cpu.planner = K.rounding_twin(cpu.planner)
    env = LiftEnv()
    g = torch.Generator(device="cuda").manual_seed(6)
    _, obs = env.reset(8, g)
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
    state = env.reset_state(N_ENVS, g)
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
