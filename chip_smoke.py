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
5. Runs the Lift recipe's training on the card (``_training_phases``):
   scripted demos on ``LiftPhysicsEnv`` (256 envs × 80 steps seed 0 for
   train, 32 seed 77 for eval, every frame through kernel C; successful
   episodes welded in memory); the VAE (``lift_vae_train_config()``: widths
   [64,128,128,128], patch 4, batch 64) through ``VAEWorkspace`` for
   ``VAE_STEPS`` steps: its loss must fall, its eval writes the HTML report,
   and its reconstruction of eval frames must beat the seeded VAE's; a VAE
   step timed part by part. Then latents of both splits from the VAE's
   snapshot (EMA weights), and the LDP ``Workspace`` of
   ``bench_train_config(vae_pretrain_path=...)`` for ``TRAIN_STEPS`` steps
   at batch 128; both losses must be finite and fall. ``Workspace.run`` ends
   with an eval (offline action MSE through A, plan statistics through B, a
   closed loop of 256 envs × 80 steps), launch counts checked. The trained
   agent's kernels are held against their plain versions on its trained
   weights (the bars of A and B above; the packs were built from the seeded
   weights before training, so a missed repack fails here); ``sample_viz``
   runs once (one launch of B and of A); the full state round-trips bit for
   bit, and one step from the restored state equals one from the live state
   (cuDNN deterministic); a train step is timed part by part. Then the
   mixed-data study of ``tools/run_lift_mixed_study.sh`` on that trained
   agent and its latents: episode resets checked to depend on (seed,
   episode) alone on the card; ``run_data_collection`` of the agent on
   ``COLLECT_ENVS`` physics envs × 80 steps with action noise 0.1, seed 123
   (A and B once a decision, C every frame; launch counts checked); its
   unsuccessful episodes welded (at most ``SUBOPT_CAP``, the study's corpus
   size) and encoded by the VAE snapshot; the study's three arms
   (``lift_mixed_study_config``: expert, mixed, action-free; 8 expert
   demos) ``MIXED_STEPS`` steps each at batch 128, both losses falling,
   each ending with its eval (closed loop of ``EVAL_ENVS`` × 80 steps,
   launch counts checked, success a reading); the share of rows each mixed
   stream drew from the suboptimal corpus within 0.1 of its ``train_split``;
   A and B on the mixed arm's trained weights (the bars above, packs primed
   from the seeded weights), its state's round trip through
   ``update_mixed``, and a mixed step timed part by part beside the plain
   one. Last DPVAE
   (``lift_dp_vae_train_config()``) on the same latents for ``DPVAE_STEPS``
   steps at batch 128, its loss falling, its eval's closed loop of 256 envs
   × 80 steps launching C and B once a decision, B held against its
   rounding twin on the trained action U-Net (packs primed from the seeded
   weights), and B timed alone at 1024 samples, DDIM-25, at the recipe's
   widths [64,128,256] and the reference widths [256,512,1024], each with
   its launch geometry, the weight bytes it streams and its bound. Then DP
   (``lift_dp_train_config()``: ResNet-18 on the raw frame trained end to
   end with the action U-Net, a 1033-wide condition) on the same demos for
   ``DP_STEPS`` steps at batch 128, its loss falling, its eval's closed
   loop launching C and B once a decision, B held against its rounding
   twin on the trained action U-Net at that condition (pack primed from the
   seeded weights) and timed alone at 1024 samples, DDIM-25; the encoder's
   time over 1024 frames beside its conv FLOPs and fp32 bound, one DP
   decision at 1024 envs stage by stage, the state's round trip and a step
   timed part by part.

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
VAE_STEPS = 400              # of the recipe's 4000, at its batch 64
DPVAE_STEPS = 400            # of the baselines' 30000, at batch 128
DP_STEPS = 400               # likewise, on raw frames
UNET_TIMING_SAMPLES = 1024   # kernel B alone at the DPVAE widths
# the mixed-data study (tools/run_lift_mixed_study.sh): its collection of
# 256 envs, the unsuccessful episodes capped at its corpus size, 8 expert
# demos, each arm cut from 30000 steps
COLLECT_ENVS = 256
SUBOPT_CAP = 92
N_EXPERT = 8
MIXED_STEPS = 400


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


class TrainRun:
    """What the training phases hand on: the scratch run directory (under
    the checkout's git-ignored ``build/``, removed at the end), the welded
    demo splits (with their latents once the LDP phase made them), the VAE
    snapshot and the trained LDP agent."""

    def __init__(self, work: Path):
        self.work = work
        self.welded: dict = {}
        self.vae_snapshot: Path | None = None
        self.vae_config: dict = {}
        self.ldp_agent = None


def _loss_means(curve, n=20) -> tuple[dict, dict]:
    first = {k: float(v[:n].mean()) for k, v in curve.items()}
    last = {k: float(v[-n:].mean()) for k, v in curve.items()}
    return first, last


def _falls(curve, keys, first, last) -> None:
    """Every value finite, and the last 20 steps' mean below the first
    20's for each of ``keys``."""
    import torch
    if not all(bool(torch.isfinite(v).all()) for v in curve.values()):
        raise AssertionError("a training loss is not finite")
    for k in keys:
        if not last[k] < first[k]:
            raise AssertionError(f"{k} did not fall: {first[k]} -> {last[k]}")


def _split_step(parts, n_steps, skip=5):
    """Mean device time (CUDA events) and host time to enqueue of each named
    part of a train step, over ``n_steps`` steps after ``skip`` warm-up
    ones; ``parts`` is [(name, fn)], run in order each step."""
    import torch
    events = [[torch.cuda.Event(enable_timing=True)
               for _ in range(len(parts) + 1)] for _ in range(n_steps)]
    host = []
    for ev in events:
        row = []
        ev[0].record()
        for j, (_, fn) in enumerate(parts):
            h = time.perf_counter()
            fn()
            ev[j + 1].record()
            row.append(time.perf_counter() - h)
        host.append(row)
    torch.cuda.synchronize()
    timed = n_steps - skip
    dev_ms = {p: sum(ev[j].elapsed_time(ev[j + 1]) for ev in events[skip:])
              / timed for j, (p, _) in enumerate(parts)}
    host_ms = {p: sum(h[j] for h in host[skip:]) * 1e3 / timed
               for j, (p, _) in enumerate(parts)}
    return dev_ms, host_ms


def _check_round_trip(ws, restored, what: str) -> dict:
    """The workspace's newest full state restored onto ``restored`` (an
    agent built from another seed) equals the live agent's bit for bit,
    and one step from each copy (same batch and draws, cuDNN
    deterministic; ``update_mixed`` when the workspace has a mixed stream)
    leaves them equal."""
    import torch
    agent = ws.agent
    path = ws.ckpt.list_states()[-1]
    ws.ckpt.restore_state(path, restored)
    n_leaves = len(_flat(agent.state_dict()))
    diff = _max_diff(agent.state_dict(), restored.state_dict())
    print(f"   {what} state round trip through {path.name}: {n_leaves} "
          f"leaves, max |diff| {diff}", flush=True)
    if diff != 0.0:
        raise AssertionError(f"restored {what} state differs: {diff}")
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        step_batch = next(ws.data.train_dataloader())
        mixed = ws.mixed_data
        mixed_batch = (None if mixed is None
                       else next(mixed.train_dataloader()))
        for ag in (agent, restored):
            gen = torch.Generator(device=ws.device).manual_seed(12)
            if mixed_batch is None:
                ag.update(step_batch, ws.step, gen)
            else:
                ag.update_mixed(step_batch, mixed_batch, ws.step, gen)
        diff = _max_diff(agent.state_dict(), restored.state_dict())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            prev)
    print(f"   one {what} step from the restored and from the live state "
          f"(same batch and draws, cuDNN deterministic): max |diff| {diff}",
          flush=True)
    if diff != 0.0:
        raise AssertionError(f"a {what} step from the restored state "
                             f"differs: {diff}")
    return dict(roundtrip_leaves=n_leaves, roundtrip_step_max_diff=diff)


def phase_vae(smoke: Smoke, run: TrainRun):
    """Demos as ``tools/run_lift_pipeline.sh`` collects them (the scripted
    expert on ``LiftPhysicsEnv``, every frame through kernel C, successful
    episodes welded in memory), then the recipe's VAE run
    (``lift_vae_train_config()``: widths [64,128,128,128], patch 4, batch
    64, β 1e-5, EMA 0.99) through ``VAEWorkspace`` for ``VAE_STEPS`` steps;
    its snapshot is what the next phases read."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.ops import normalize as nz
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.vae_loop import VAEWorkspace

    dev = torch.device("cuda")
    out: dict = {}

    # 1. demos: the scripted expert on the bench's env, successful episodes
    env = configs.make_bench_env(episode_len=DEMO_LEN)
    env_meta = {"env_name": "LiftPhysicsEnv",
                "env_kwargs": dict(configs.BENCH_ENV, episode_len=DEMO_LEN)}
    keys = list(configs.BENCH_AGENT["lowdim_obs"]) + ["agentview_image"]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for split, n, seed in DEMO_SPLITS:
        col = engine.run_scripted_collection(env, n, seed, device=dev)
        rate = float(col["success"].any(1).float().mean())
        w = run.welded[split] = weld_collection(
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

    # 2. the VAE run; its last acts are a snapshot and an eval (losses over
    # 10 eval batches, the HTML page)
    cfg = configs.lift_vae_train_config()
    cfg.update(n_grad_steps=VAE_STEPS, eval_every=0, save_every=0,
               log_every=100)
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=run.welded["train"],
                       eval=run.welded["eval"], device=dev)
    ws = VAEWorkspace(cfg, run.work / "vae", data=data, device=dev)
    ws.init_agent()
    model = ws.agent
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ws.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    curve = ws.loss_curve()
    first, last = _loss_means(curve)
    sps = VAE_STEPS / ws.train_seconds
    print(f"   VAE: {VAE_STEPS} steps at batch {cfg['batch_size']} in "
          f"{ws.train_seconds:.3f} s = {sps:.2f} steps/s, {1e3 / sps:.2f} ms "
          f"a step; run() with its snapshot and eval {run_s:.3f} s; peak "
          f"memory {peak / 2**20:.1f} MiB [{smoke.card}]", flush=True)
    for k in model.LOSS_KEYS:
        print(f"   VAE {k}: mean of the first 20 steps {first[k]:.6f}, of "
              f"the last 20 {last[k]:.6f}", flush=True)
    _falls(curve, ("loss", "loss_mse"), first, last)
    ev = ws.last_eval
    report = ws.report_path
    print(f"   VAE eval over {cfg['n_eval_batches']} batches: loss_mse "
          f"{ev['loss_mse']:.6f}, loss_kl {ev['loss_kl']:.3f}; report "
          f"{report} ({report.stat().st_size} bytes)", flush=True)
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"VAE eval metrics not finite: {ev}")

    # 3. reconstruction of eval frames, trained (EMA) against seeded
    seeded = ws.make_agent()
    key = "agentview_image"
    frames = run.welded["eval"].arrays[key][:512].to(dev)
    x = nz.normalize_tree({key: frames},
                          {key: model.obs_normalization["obs"][key]})[key]
    rec_err = {}
    for name, m in (("trained", model), ("seeded", seeded)):
        rec_err[name] = float(torch.mean(torch.square(
            m.decode(m.encode_mode(x)) - x)))
    print(f"   decode(encode_mode(x)) on {frames.shape[0]} eval frames, MSE "
          f"in [-1, 1]: trained (EMA) {rec_err['trained']:.6f}, seeded "
          f"{rec_err['seeded']:.6f}", flush=True)
    if not rec_err["trained"] < rec_err["seeded"]:
        raise AssertionError(f"the trained VAE does not reconstruct better "
                             f"than the seeded one: {rec_err}")

    # 4. where a VAE step's time goes (CUDA events, on the seeded copy)
    ds = data.device_dataset("train")
    g = torch.Generator(device=dev).manual_seed(13)
    holder = {}
    torch.cuda.reset_peak_memory_stats()
    dev_ms, host_ms = _split_step([
        ("gather", lambda: holder.update(b=ds.sample(cfg["batch_size"], g))),
        ("forward+backward", lambda: seeded.backward(holder["b"], g)),
        ("optimizer", seeded.apply_gradients)], SPLIT_STEPS)
    peak_steps = torch.cuda.max_memory_allocated()
    print(f"   a VAE step, device timeline between events (mean of "
          f"{SPLIT_STEPS - 5}): {json.dumps(dev_ms)} ms; host time to "
          f"enqueue: {json.dumps(host_ms)} ms; peak memory over these steps "
          f"{peak_steps / 2**20:.1f} MiB [{smoke.card}]", flush=True)

    run.vae_snapshot = ws.ckpt.list_checkpoints()[-1]
    run.vae_config = dict(cfg["model"]["vae"])
    out.update(vae_steps=VAE_STEPS, batch=cfg["batch_size"],
               train_s=ws.train_seconds, steps_per_s=sps, ms_per_step=1e3 / sps,
               run_s=run_s, peak_mib_run=peak / 2**20,
               loss_first20=first, loss_last20=last, eval=ev,
               report=str(report), report_bytes=report.stat().st_size,
               recon_mse=rec_err, step_split_ms=dev_ms, step_host_ms=host_ms,
               peak_mib_train_steps=peak_steps / 2**20,
               snapshot=run.vae_snapshot.name)
    return out


def _check_trained_ldp(smoke, what: str, agent, seeded, raw_batch,
                       g) -> dict:
    """Kernels A and B of a trained LDP agent against their plain versions
    on its trained weights, on the latents of ``raw_batch``: A within 1e-4
    of the fp32 sampler, B within phase B's mean (5e-3) and max (0.1) of
    its rounding twin and closer to it than the fp32 net. The caller primed
    the packs with the seeded weights before training, so a missed repack
    fails here; how far ``seeded``'s nets land is printed beside."""
    import torch
    from latent_diffusion_planning_tpu_torch.models.agents import common
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA, diffusion_unet1d as KB)
    dev = agent.device
    batch = agent._prepare_eval_batch(raw_batch)
    emb = agent._obs_cond(batch["obs"])
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
    print(f"   {what} A ({pairs.shape[0]} rows, DDIM-"
          f"{agent.config.idm_inference_steps}): the plain net on the seeded "
          f"weights is {away:.3e} away from the trained", flush=True)
    smoke.check(f"{what} A max_abs_err vs plain on the trained weights",
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
    print(f"   {what} B ({emb.shape[0]} samples): {full}; the fp32 net "
          f"{fp32}; the seeded weights' twin {stale}", flush=True)
    smoke.check(f"{what} B mean_abs_err vs the rounding twin", full["mean"],
                5e-3)
    smoke.check(f"{what} B max_abs_err vs the rounding twin", full["max"],
                0.1)
    if not full["mean"] < fp32["mean"]:
        raise AssertionError(f"{what} B: no closer to the rounding twin than "
                             "the fp32 net is")
    return {f"{what}_a_max_abs_err": err_a, f"{what}_a_seeded_away": away,
            f"{what}_b": full, f"{what}_b_fp32": fp32,
            f"{what}_b_seeded": stale}


def phase_ldp_training(smoke: Smoke, run: TrainRun):
    """LDP training on Lift at the bench widths, fed by the trained VAE:
    latents of both splits from its snapshot's EMA weights
    (``process_latents``), the ``Workspace`` from ``bench_train_config``
    with ``vae_pretrain_path`` set, for ``TRAIN_STEPS`` steps (its last act
    is ``eval``: offline metrics through kernels A and B, then a closed loop
    of ``EVAL_ENVS`` × 80 steps through C, B and A), the trained agent's
    kernels against their plain versions, ``sample_viz``, the state's round
    trip, and a train step timed part by part."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.data.latents import process_latents
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA, diffusion_unet1d as KB)
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace

    dev = torch.device("cuda")
    out: dict = {}
    cfg = configs.bench_train_config(vae_pretrain_path=str(run.vae_snapshot))
    meta = cfg["data"]["meta"]
    agent_cfg = {**cfg["agent"], "obs_normalization": meta["obs_normalization"]}

    # 1. latents from the trained VAE's snapshot (EMA weights)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    min_z, max_z = process_latents(list(run.welded.values()), run.vae_snapshot,
                                   run.vae_config, ["agentview_image"],
                                   device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    frames = sum(w.total_steps for w in run.welded.values())
    bound = meta["obs_normalization"]["obs"]["latent_agentview_image"]
    to_unit = lambda z: (z - bound["min"]) / (bound["max"] - bound["min"]) * 2 - 1
    print(f"   latents of the trained VAE: {frames} frames in {secs:.3f} s = "
          f"{frames / secs:.1f} frames/s; min_z {min_z:.4f} max_z "
          f"{max_z:.4f}, normalized by the config's bounds [{bound['min']}, "
          f"{bound['max']}] to [{to_unit(min_z):.4f}, {to_unit(max_z):.4f}] "
          f"[{smoke.card}]", flush=True)
    out.update(latent_frames=frames, latent_s=secs,
               latent_frames_per_s=frames / secs, min_z=min_z, max_z=max_z)

    # 2. the Workspace over the welded splits, its VAE from the snapshot
    cfg.update(n_grad_steps=TRAIN_STEPS, n_eval_episodes=EVAL_ENVS,
               eval_every=0, save_every=0, log_every=100)
    cfg["data"]["env_params"]["env"]["episode_len"] = DEMO_LEN
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=run.welded["train"],
                       eval=run.welded["eval"], device=dev)
    ws = Workspace(cfg, run.work / "ldp", data=data, device=dev)
    ws.init_agent()
    agent = ws.agent
    snap = torch.load(run.vae_snapshot, map_location=dev, weights_only=True)
    vae_diff = max(float((v - snap["vae_ema_params"][k]).abs().max())
                   for k, v in agent.vae.state_dict().items())
    print(f"   the agent's VAE against the snapshot's EMA weights: max |diff| "
          f"{vae_diff}", flush=True)
    if vae_diff != 0.0:
        raise AssertionError("the agent did not load the VAE snapshot")

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
    first, last = _loss_means(curve)
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
    _falls(curve, ("plan_loss", "idm_loss"), first, last)
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
          f"to the episodes' ends, {ev['computed_env_steps_per_sec']:.1f} "
          f"computed env-steps/s [{smoke.card}]", flush=True)
    bad = [k for k, v in ev.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"eval metrics not finite: {bad}")
    out.update(eval=ev, eval_launches=counts)

    # 4. the trained agent's kernels against their plain versions, on its
    # trained weights (its packs were primed with the seeded ones)
    g = torch.Generator(device=dev).manual_seed(11)
    out.update(_check_trained_ldp(smoke, "trained", agent, seeded,
                                  next(data.eval_dataloader()), g))

    # plan visualization once on eval windows: B plans, the decoder draws
    # the executed latents, A decodes the actions between them
    viz_batch = next(data.eval_dataloader())
    kernels.reset_launch_counts()
    acts, viz = agent.sample_viz(viz_batch, g)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {"diffusion_mlp": 1, "diffusion_unet1d": 1, "raycast": 0}
    pv = viz["plan_viz"]
    print(f"   sample_viz on {acts.shape[0]} eval windows: plan_mse "
          f"{float(viz['plan_mse']):.6f}, plan_viz {tuple(pv.shape)} in "
          f"[{float(pv.min()):.3f}, {float(pv.max()):.3f}], launches {counts} "
          f"(expected {want})", flush=True)
    if counts != want or not (torch.isfinite(acts).all()
                              and torch.isfinite(pv).all()):
        raise AssertionError(f"sample_viz: launches {counts}, finite "
                             f"{bool(torch.isfinite(pv).all())}")
    out.update(viz_plan_mse=float(viz["plan_mse"]), viz_launches=counts)

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
    restored = LDPAgent.create(agent_cfg, meta["shape_meta"],
                               seed=cfg["seed"] + 1, device=dev)
    out.update(_check_round_trip(ws, restored, "LDP"))

    # 6. where a train step's time goes (CUDA events, on the restored copy)
    ds = data.device_dataset("train")
    holder = {}
    torch.cuda.reset_peak_memory_stats()
    split_ms, host_ms = _split_step([
        ("gather", lambda: holder.update(b=ds.sample(cfg["batch_size"], g))),
        ("forward+backward",
         lambda: restored.backward(holder["b"], True, True, g)),
        ("optimizer", lambda: restored.apply_gradients(True, True))],
        SPLIT_STEPS)
    peak_steps = torch.cuda.max_memory_allocated()
    print(f"   a train step, device timeline between events (mean of "
          f"{SPLIT_STEPS - 5}): {json.dumps(split_ms)} ms; host time to "
          f"enqueue: {json.dumps(host_ms)} ms; peak memory over these steps "
          f"{peak_steps / 2**20:.1f} MiB [{smoke.card}]", flush=True)
    out.update(step_split_ms=split_ms, step_host_ms=host_ms,
               peak_mib_train_steps=peak_steps / 2**20)
    run.ldp_agent = agent
    return out


def _replayed_share(facade, n_batches: int) -> tuple[float, int]:
    """The share of rows that a mixed facade's train stream drew from its
    sub-datasets after the first, judged by index against the offsets: the
    stream's first ``n_batches`` batches replayed from a generator seeded
    as its loader seeds one (checked against the loader's first batch)."""
    import torch
    ds = facade.device_dataset("train")
    gen = torch.Generator(device=ds.device).manual_seed(facade.seed)
    idx = [ds.indices(facade.batch_size, gen) for _ in range(n_batches)]
    first = next(facade.train_dataloader())
    if not torch.equal(ds.dataset.gather(idx[0])["actions"],
                       first["actions"]):
        raise AssertionError("the replayed indices are not the stream's")
    idx = torch.cat(idx)
    return float((idx >= ds.sub_offsets[1]).float().mean()), idx.numel()


def phase_mixed(smoke: Smoke, run: TrainRun):
    """The mixed-data study of ``tools/run_lift_mixed_study.sh`` on the
    LDP phase's trained agent and latents: the per-episode resets checked
    on the card; ``run_data_collection`` of the agent with action noise 0.1
    on ``COLLECT_ENVS`` physics envs × 80 steps, seed 123
    (``lift_collect_data_config()``), launch counts checked; the
    unsuccessful episodes welded (at most ``SUBOPT_CAP``) and encoded by the
    VAE snapshot; the three arms (``lift_mixed_study_config``, 8 expert
    demos) trained ``MIXED_STEPS`` steps each, losses falling, each ending
    with its eval (closed loop ``EVAL_ENVS`` × 80 through C, B and A; launch
    counts checked); the share of suboptimal rows in the mixed streams;
    kernels A and B on the mixed arm's trained weights, its state's round
    trip, and a mixed step timed part by part beside the plain one."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.data.latents import process_latents
    from latent_diffusion_planning_tpu_torch.data.writer import weld_collection
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.loop import (Workspace,
                                                               make_data)

    dev = torch.device("cuda")
    out: dict = {}
    col_cfg = configs.lift_collect_data_config()
    n_col, seed = COLLECT_ENVS, col_cfg["seed"]
    T = col_cfg["episode_len"]
    policy = run.ldp_agent
    c = policy.config

    # 1. the resets: episode i's uniforms depend on (seed, i) alone, on the
    # card as on the CPU; the old single-generator draw beside, as a reading
    full = engine.reset_uniforms(seed, torch.arange(n_col, device=dev), 3)
    head = engine.reset_uniforms(seed, torch.arange(4, device=dev), 3)
    tail = engine.reset_uniforms(seed, torch.arange(n_col - 4, n_col,
                                                    device=dev), 3)
    on_cpu = engine.reset_uniforms(seed, torch.arange(n_col), 3)
    same = (torch.equal(full[:4], head) and torch.equal(full[-4:], tail)
            and torch.equal(full.cpu(), on_cpu))
    old = lambda n: torch.rand(n, 3, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    print(f"   resets: {n_col} episodes' uniforms, the first and last 4 "
          f"drawn alone, and the CPU's: equal {same}; the old one-generator "
          f"draw's first 4 of {n_col} against 4 alone: equal "
          f"{torch.equal(old(n_col)[:4], old(4))} (a reading)", flush=True)
    if not same:
        raise AssertionError("per-episode reset uniforms depend on the run")

    # 2. the suboptimal corpus: the trained LDP with action noise
    env = configs.make_bench_env(episode_len=T)
    env_meta = {"env_name": "LiftPhysicsEnv",
                "env_kwargs": dict(configs.BENCH_ENV, episode_len=T)}
    keys = list(configs.BENCH_AGENT["lowdim_obs"]) + ["agentview_image"]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    col = engine.run_data_collection(
        env, policy, n_col, seed, obs_horizon=c.obs_horizon,
        action_horizon=c.action_horizon, episode_len=T,
        action_noise=col_cfg["noise"],
        policy_obs_keys=configs.BENCH_POLICY_KEYS, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_dec = math.ceil(T / c.action_horizon)
    want = {"diffusion_mlp": n_dec, "diffusion_unet1d": n_dec,
            "raycast": n_dec * c.action_horizon + 1}
    rate = float(col["success"].any(1).float().mean())
    print(f"   collection: {n_col} envs x {T} steps, noise "
          f"{col_cfg['noise']}, seed {seed}: {secs:.3f} s, "
          f"{n_col * T / secs:.1f} env-steps/s; policy success {rate:.4f}; "
          f"launches {counts} (expected {want}) [{smoke.card}]", flush=True)
    if counts != want:
        raise AssertionError(f"collection launches {counts} != {want}")
    subopt = weld_collection(col, obs_keys=keys, env_meta=env_meta,
                             unsuccessful_only=True, max_demos=SUBOPT_CAP,
                             name="lift/suboptimal")
    del col
    if subopt.n_demos == 0:
        raise AssertionError("no unsuccessful episodes to weld")
    min_z, max_z = process_latents([subopt], run.vae_snapshot,
                                   run.vae_config, ["agentview_image"],
                                   device=dev)
    z = subopt.arrays["latent_agentview_image"]
    print(f"   suboptimal corpus: {subopt.n_demos} unsuccessful episodes "
          f"(cap {SUBOPT_CAP}), {subopt.total_steps} steps, latents "
          f"{tuple(z.shape)} in [{min_z:.4f}, {max_z:.4f}]", flush=True)
    if not bool(torch.isfinite(z).all()):
        raise AssertionError("suboptimal latents not finite")
    out.update(collect_envs=n_col, collect_s=secs, collect_success=rate,
               collect_launches=counts, subopt_demos=subopt.n_demos,
               subopt_steps=subopt.total_steps)

    # 3. the three arms
    given = {True: dict(train=[run.welded["train"], subopt],
                        eval=run.welded["eval"]),
             False: dict(train=run.welded["train"], eval=run.welded["eval"])}
    arms = {}
    for arm in configs.MIXED_STUDY_ARMS:
        cfg = configs.lift_mixed_study_config(
            arm, N_EXPERT, vae_pretrain_path=str(run.vae_snapshot))
        cfg.update(n_grad_steps=MIXED_STEPS, n_eval_episodes=EVAL_ENVS,
                   eval_every=0, save_every=0, log_every=100)
        facades = {}
        for name in ("data", "mixed_data"):
            if name in cfg:
                sec = cfg[name]
                sec["env_params"]["env"]["episode_len"] = DEMO_LEN
                sec = {k: v for k, v in sec.items()
                       if not k.endswith(("path", "paths"))}
                facades[name] = make_data(sec, dev,
                                          **given[bool(sec.get("mixed"))])
        ws = Workspace(cfg, run.work / arm, data=facades["data"],
                       mixed_data=facades.get("mixed_data"), device=dev)
        ws.init_agent()
        agent = ws.agent
        if arm == "mixed":
            # prime the packs with the seeded weights (see the LDP phase)
            primer = next(ws.data.eval_dataloader())
            agent.sample_action(primer)
            agent.sample_plan_stats(primer)
            agent_cfg = {**cfg["agent"], "obs_normalization":
                         ws.data.meta["obs_normalization"]}
            seeded = LDPAgent.create(agent_cfg, ws.data.shape_meta,
                                     seed=cfg["seed"], device=dev)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        ws.run()
        torch.cuda.synchronize()
        curve = ws.loss_curve()
        first, last = _loss_means(curve)
        sps = MIXED_STEPS / ws.train_seconds
        print(f"   {arm}: {MIXED_STEPS} steps at batch {cfg['batch_size']} "
              f"in {ws.train_seconds:.3f} s = {sps:.2f} steps/s; plan_loss "
              f"{first['plan_loss']:.5f} -> {last['plan_loss']:.5f}, "
              f"idm_loss {first['idm_loss']:.5f} -> {last['idm_loss']:.5f} "
              f"(means of the first and last 20 steps); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"[{smoke.card}]", flush=True)
        _falls(curve, ("plan_loss", "idm_loss"), first, last)
        counts = kernels.launch_counts()
        want = {"diffusion_mlp": 2 + n_dec, "diffusion_unet1d": 2 + n_dec,
                "raycast": n_dec}
        ev = ws.last_eval
        print(f"   {arm} eval: launches {counts} (expected {want}); closed "
              f"loop {EVAL_ENVS} envs x {DEMO_LEN} steps (a reading): "
              f"success {ev['success']:.4f}, horizon {ev['horizon']:.2f}, "
              f"{ev['computed_env_steps_per_sec']:.1f} computed env-steps/s; "
              f"action_mse train {ev['train_action_mse']:.5f}, eval "
              f"{ev['eval_action_mse']:.5f} [{smoke.card}]", flush=True)
        if counts != want:
            raise AssertionError(f"{arm} eval launches {counts} != {want}")
        bad = [k for k, v in ev.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{arm} eval metrics not finite: {bad}")
        info = dict(steps_per_s=sps, loss_first20=first, loss_last20=last,
                    eval=ev, eval_launches=counts)
        stream = {"mixed": ws.mixed_data, "actionfree": ws.data}.get(arm)
        if stream is not None:
            share, rows = _replayed_share(stream, MIXED_STEPS + 1)
            target = 1.0 - stream.train_split[0]
            print(f"   {arm}: the {'IDM' if arm == 'mixed' else 'planner'}'s"
                  f" stream drew {share:.4f} of its {rows} rows from the "
                  f"suboptimal corpus (train_split {stream.train_split})",
                  flush=True)
            smoke.check(f"{arm} suboptimal share |share - {target}|",
                        abs(share - target), 0.1)
            info["subopt_share"] = share
        arms[arm] = info
        if arm == "mixed":
            mixed_ws = ws
    out["arms"] = arms

    # 4. the mixed arm's kernels on its trained weights, its state's round
    # trip, and a mixed step beside the plain one (CUDA events)
    ws, agent = mixed_ws, mixed_ws.agent
    g = torch.Generator(device=dev).manual_seed(14)
    out.update(_check_trained_ldp(smoke, "mixed arm", agent, seeded,
                                  next(ws.data.eval_dataloader()), g))
    restored = LDPAgent.create(agent_cfg, ws.data.shape_meta,
                               seed=ws.cfg["seed"] + 1, device=dev)
    out.update(_check_round_trip(ws, restored, "mixed LDP"))
    ds = ws.data.device_dataset("train")
    ds_m = ws.mixed_data.device_dataset("train")
    B = ws.data.batch_size
    h = {}
    gather = lambda: h.update(b=ds.sample(B, g))
    splits = {}
    for label, parts in (
            ("plain", [("gather", gather),
                       ("forward+backward",
                        lambda: restored.backward(h["b"], True, True, g)),
                       ("optimizer",
                        lambda: restored.apply_gradients(True, True))]),
            ("mixed", [("gather", gather),
                       ("gather mixed", lambda: h.update(m=ds_m.sample(B, g))),
                       ("forward+backward", lambda: restored.backward(
                           h["b"], True, True, g, mixed_batch=h["m"])),
                       ("optimizer",
                        lambda: restored.apply_gradients(True, True))])):
        dev_ms, host_ms = _split_step(parts, SPLIT_STEPS)
        splits[label] = dict(device_ms=dev_ms, host_ms=host_ms)
        print(f"   a {label} LDP step, device timeline between events (mean "
              f"of {SPLIT_STEPS - 5}): {json.dumps(dev_ms)} ms; host time "
              f"to enqueue: {json.dumps(host_ms)} ms [{smoke.card}]",
              flush=True)
    out["step_split"] = splits
    return out


def _unet_against_twin(smoke, what, net, cond, x_init, table, clip, packed,
                       seeded=None, hold_max=True) -> dict:
    """Kernel B on ``net`` against its rounding twin: after all of
    ``table`` the mean within 5e-3 and, with ``hold_max``, no element beyond
    0.1 (phase B's bars), and closer to the twin than the fp32 net is after
    one step and after all. Phase B's share of elements within 5e-3 after
    one step (99%) is calibrated on seeded nets; a trained net's larger
    activations put more of them next to a bf16 boundary (the trained
    action U-Net: 97–98% for the kernel where the fp32 net lands far further
    off), so it is printed here as a reading. The largest error is a single
    element's worst bf16 flip carried through the steps: over 1024 samples ×
    25 steps at the reference widths it passed 0.1 once (0.149; the fp32
    net 0.252), so the timing shapes print it as a reading too. With
    ``seeded``, also how far the seeded weights' twin lands (a stale pack
    would sit there)."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    twin = KB.rounding_twin(net)
    ts, coefs = table
    plain = lambda m, n=None: KB.unet1d_ddim_sample_plain(
        m, cond, x_init, ts[:n], coefs[:n], clip)
    kernel = lambda n=None: KB.fused_unet1d_ddim_sample(
        net, cond, x_init, ts[:n], coefs[:n], clip_range=clip, packed=packed)
    ref1 = plain(twin, 1)
    one, fp32_one = err_stats(kernel(1), ref1), err_stats(plain(net, 1), ref1)
    ref = plain(twin)
    full, fp32 = err_stats(kernel(), ref), err_stats(plain(net), ref)
    print(f"   {what}: after 1 step {one} (the fp32 net {fp32_one}); after "
          f"{len(ts)} steps {full} (the fp32 net {fp32})", flush=True)
    out = dict(one_step=one, fp32_net_one_step=fp32_one, kernel=full,
               fp32_net=fp32)
    if seeded is not None:
        out["seeded_twin"] = err_stats(plain(KB.rounding_twin(seeded)), ref)
        print(f"   {what}: the seeded weights' twin {out['seeded_twin']}",
              flush=True)
    smoke.check(f"{what} mean_abs_err vs the rounding twin", full["mean"], 5e-3)
    if hold_max:
        smoke.check(f"{what} max_abs_err vs the rounding twin", full["max"],
                    0.1)
    if not (one["mean"] < fp32_one["mean"] and full["mean"] < fp32["mean"]):
        raise AssertionError(f"{what}: no closer to the rounding twin than "
                             "the fp32 net is")
    return out


def _time_unet(smoke, what, net, B, table, clip, g) -> dict:
    """Kernel B alone on ``net`` at ``B`` samples over ``table`` (T 8,
    seeded condition and initial sample): held against the rounding twin
    (the max as a reading), timed beside the twin, with its launch
    geometry, the weight bytes it streams and its bound."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    ts, coefs = table
    gc = torch.randn(B, net.global_cond_dim, generator=g, device="cuda")
    x0 = torch.randn(B, 8, net.input_dim, generator=g, device="cuda")
    packed = KB.pack_params(net).to("cuda")
    checks = _unet_against_twin(smoke, what, net, gc, x0, table, clip, packed,
                                hold_max=False)
    twin = KB.rounding_twin(net)
    run_k = lambda: KB.fused_unet1d_ddim_sample(
        net, gc, x0, ts, coefs, clip_range=clip, packed=packed)
    run_p = lambda: KB.unet1d_ddim_sample_plain(twin, gc, x0, ts, coefs, clip)
    ms, plain_ms = time_ms(run_k, iters=3), time_ms(run_p, iters=1)
    smoke.timing(what, ms, plain_ms)
    elem, mm, nbytes = unet_flops_bytes(net, B, 8, int(ts.shape[0]))
    b_ms, b_by = bound(elem, nbytes, bf16_flops=mm)
    shape = KB.kernel_info(net, B, 8, int(ts.shape[0]))
    row_tiles = -(-shape["samples_per_block"] * 8 // 16)
    entry = next(n for n in (2, 4, 8) if row_tiles <= n)
    info = smoke.shape_line(what, f"unet1d_sampler_kernelILi{entry}E", shape,
                            mm, PEAK_BF16_FLOPS, "bf16 tensor-core", ms)
    print(f"   {what}: bound {b_ms:.3f} ms ({b_by}); weights "
          f"{shape['weight_bytes_per_step_and_block'] / 1e6:.1f} MB a step "
          f"and block, {shape['weight_bytes_streamed'] / 1e9:.1f} GB "
          f"streamed in all [{smoke.card}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bf16_flops=mm, fp32_flops=elem, bytes=nbytes, shape=info,
                **checks)


def phase_dp_vae(smoke: Smoke, run: TrainRun):
    """DPVAE on the same latents (``lift_dp_vae_train_config()``: action
    U-Net [64,128,256] over 7 action channels with a 25-wide condition,
    DDPM-50 training, DDIM-25 sampling) for ``DPVAE_STEPS`` steps at batch
    128 through the ``Workspace``, whose eval ends with a closed loop of
    ``EVAL_ENVS`` × 80 steps through kernels C and B; kernel B held against
    its rounding twin on the trained action U-Net; then kernel B alone at
    ``UNET_TIMING_SAMPLES`` samples, DDIM-25, at the recipe's widths and at
    the reference widths [256,512,1024] (``configs/agent/dp_repr_agent.yaml``)."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.models.agents.dp_vae import (
        DPVAEAgent)
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace

    dev = torch.device("cuda")
    out: dict = {}
    cfg = configs.lift_dp_vae_train_config(
        vae_pretrain_path=str(run.vae_snapshot))
    cfg.update(n_grad_steps=DPVAE_STEPS, n_eval_episodes=EVAL_ENVS,
               eval_every=0, save_every=0, log_every=100, resume=False)
    cfg["data"]["env_params"]["env"]["episode_len"] = DEMO_LEN
    meta = cfg["data"]["meta"]
    agent_cfg = {**cfg["agent"], "obs_normalization": meta["obs_normalization"]}
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=run.welded["train"],
                       eval=run.welded["eval"], device=dev)
    ws = Workspace(cfg, run.work / "dp_vae", data=data, device=dev)
    ws.init_agent()
    agent = ws.agent
    if not isinstance(agent, DPVAEAgent):
        raise AssertionError(f"the workspace built a {type(agent).__name__}")
    # prime kernel B's pack with the seeded weights (see the LDP phase)
    agent.sample_action(next(data.eval_dataloader()))
    seeded = DPVAEAgent.create(agent_cfg, meta["shape_meta"], seed=cfg["seed"],
                               device=dev)

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ws.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    curve = ws.loss_curve()
    first, last = _loss_means(curve)
    sps = DPVAE_STEPS / ws.train_seconds
    print(f"   DPVAE: {DPVAE_STEPS} steps at batch {cfg['batch_size']} in "
          f"{ws.train_seconds:.3f} s = {sps:.2f} steps/s, {1e3 / sps:.2f} ms "
          f"a step; run() with its snapshot and eval {run_s:.3f} s; peak "
          f"memory {peak / 2**20:.1f} MiB [{smoke.card}]", flush=True)
    print(f"   DPVAE loss: mean of the first 20 steps {first['loss']:.5f}, of "
          f"the last 20 {last['loss']:.5f}", flush=True)
    _falls(curve, ("loss",), first, last)

    ev = ws.last_eval
    n_dec = math.ceil(DEMO_LEN / cfg["action_horizon"])
    counts = kernels.launch_counts()
    want = {"diffusion_mlp": 0, "diffusion_unet1d": 2 + n_dec,
            "raycast": n_dec}
    print(f"   DPVAE eval: launches {counts} (expected {want}: one offline "
          f"batch of each split through B, then {n_dec} decisions through C "
          f"and B)", flush=True)
    if counts != want:
        raise AssertionError(f"DPVAE eval launches {counts} != {want}")
    print(f"   DPVAE eval: action_mse train {ev['train_action_mse']:.5f}, "
          f"eval {ev['eval_action_mse']:.5f}; closed loop, {EVAL_ENVS} envs "
          f"x {DEMO_LEN} steps after {DPVAE_STEPS} steps: success "
          f"{ev['success']:.4f}, horizon {ev['horizon']:.2f}, "
          f"{ev['env_steps_per_sec']:.1f} env-steps/s to the episodes' ends, "
          f"{ev['computed_env_steps_per_sec']:.1f} computed env-steps/s "
          f"[{smoke.card}]", flush=True)
    bad = [k for k, v in ev.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"DPVAE eval metrics not finite: {bad}")
    out.update(train_steps=DPVAE_STEPS, batch=cfg["batch_size"],
               train_s=ws.train_seconds, steps_per_s=sps,
               ms_per_step=1e3 / sps, run_s=run_s, peak_mib_run=peak / 2**20,
               loss_first20=first, loss_last20=last, eval=ev,
               eval_launches=counts)

    # kernel B on the trained action U-Net (its pack was primed with the
    # seeded weights) against the rounding twin
    batch = next(data.eval_dataloader())
    prepared = agent._prepare(agent._to_device(batch))
    cond = agent._obs_cond(prepared["obs"])
    g = torch.Generator(device=dev).manual_seed(14)
    x_init = torch.randn(cond.shape[0], 8, 7, generator=g, device=dev)
    table = agent.sampler.table()
    ts = table[0]
    clip = agent.sched.clip_range
    net = agent._sampling_net()
    agent.sampler(net, cond, x_init)          # repacks from the trained net
    out["trained_b"] = _unet_against_twin(
        smoke, f"trained DPVAE B ({cond.shape[0]} samples, DDIM-"
        f"{ts.shape[0]})", net, cond, x_init, table, clip,
        agent.sampler._pack, seeded=seeded.planner)

    # kernel B alone at the DPVAE widths, 1024 samples, DDIM-25
    B = UNET_TIMING_SAMPLES
    p = cfg["agent"]["planner"]
    timing = {}
    for name, dd in (("recipe", tuple(p["down_dims"])),
                     ("reference", (256, 512, 1024))):
        if name == "recipe":
            tnet = net
        else:
            torch.manual_seed(15)
            tnet = ConditionalUnet1D(7, 25, p["diffusion_step_embed_dim"], dd,
                                     p["kernel_size"], p["n_groups"]).to(dev)
        timing[name] = _time_unet(smoke, f"DPVAE B {name} {list(dd)} B={B}",
                                  tnet, B, table, clip, g)
    out["unet_timing"] = timing
    return out


def conv_flops(net, x) -> float:
    """Operations of every convolution of ``net`` on ``x`` (2 per
    multiply-add), counted from the shapes the forward gives them."""
    import torch
    total = [0.0]

    def hook(mod, inp, out):
        k = mod.weight[0].numel()           # Cin/groups × kh × kw
        total[0] += 2.0 * out.numel() * k
    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def phase_dp(smoke: Smoke, run: TrainRun):
    """DP on the raw camera frames (``lift_dp_train_config()``: ResNet-18
    with GroupNorm and a spatial-softmax head trained end to end with the
    action U-Net [64,128,256], whose condition is 1024 features + 9 lowdim
    = 1033 wide; DDPM-50 training, DDIM-25 sampling) for ``DP_STEPS`` steps
    at batch 128 through the ``Workspace``, on the demos the VAE phase
    collected; its eval ends with a closed loop of ``EVAL_ENVS`` × 80 steps
    through kernels C and B. Then kernel B on the trained action U-Net
    against its rounding twin (pack primed with the seeded weights), B
    alone at ``UNET_TIMING_SAMPLES`` samples, DDIM-25, the encoder over
    1024 frames and one decision at 1024 envs stage by stage, the state's
    round trip, and a train step timed part by part."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.models.agents.dp import DPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.ops import normalize as nz
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace
    from latent_diffusion_planning_tpu_torch.utils.precision import fp32_math

    dev = torch.device("cuda")
    out: dict = {}
    cfg = configs.lift_dp_train_config()
    cfg.update(n_grad_steps=DP_STEPS, n_eval_episodes=EVAL_ENVS,
               eval_every=0, save_every=0, log_every=100, resume=False)
    meta = cfg["data"]["meta"]
    agent_cfg = {**cfg["agent"], "obs_normalization": meta["obs_normalization"]}
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=run.welded["train"],
                       eval=run.welded["eval"], device=dev)
    ws = Workspace(cfg, run.work / "dp", data=data, device=dev)
    ws.init_agent()
    agent = ws.agent
    if not isinstance(agent, DPAgent):
        raise AssertionError(f"the workspace built a {type(agent).__name__}")
    print(f"   DP: condition {agent.config.cond_dim} wide, kernel B's "
          f"prologue takes {KB.cond_rows(agent.planner)} samples a block",
          flush=True)
    # prime kernel B's pack with the seeded weights (see the LDP phase)
    agent.sample_action(next(data.eval_dataloader()))
    seeded = DPAgent.create(agent_cfg, meta["shape_meta"], seed=cfg["seed"],
                            device=dev)

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ws.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = kernels.launch_counts()
    curve = ws.loss_curve()
    first, last = _loss_means(curve)
    sps = DP_STEPS / ws.train_seconds
    print(f"   DP: {DP_STEPS} steps at batch {cfg['batch_size']} in "
          f"{ws.train_seconds:.3f} s = {sps:.2f} steps/s, {1e3 / sps:.2f} ms "
          f"a step; run() with its snapshot and eval {run_s:.3f} s; peak "
          f"memory {peak / 2**20:.1f} MiB [{smoke.card}]", flush=True)
    print(f"   DP loss: mean of the first 20 steps {first['loss']:.5f}, of "
          f"the last 20 {last['loss']:.5f}", flush=True)
    _falls(curve, ("loss",), first, last)

    ev = ws.last_eval
    n_dec = math.ceil(DEMO_LEN / cfg["action_horizon"])
    want = {"diffusion_mlp": 0, "diffusion_unet1d": 2 + n_dec,
            "raycast": n_dec}
    print(f"   DP eval: launches {counts} (expected {want}: one offline "
          f"batch of each split through B, then {n_dec} decisions through C "
          f"and B)", flush=True)
    if counts != want:
        raise AssertionError(f"DP eval launches {counts} != {want}")
    print(f"   DP eval: action_mse train {ev['train_action_mse']:.5f}, eval "
          f"{ev['eval_action_mse']:.5f}; closed loop, {EVAL_ENVS} envs x "
          f"{DEMO_LEN} steps after {DP_STEPS} steps: success "
          f"{ev['success']:.4f}, horizon {ev['horizon']:.2f}, "
          f"{ev['env_steps_per_sec']:.1f} env-steps/s to the episodes' ends, "
          f"{ev['computed_env_steps_per_sec']:.1f} computed env-steps/s "
          f"[{smoke.card}]", flush=True)
    bad = [k for k, v in ev.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"DP eval metrics not finite: {bad}")
    out.update(train_steps=DP_STEPS, batch=cfg["batch_size"],
               train_s=ws.train_seconds, steps_per_s=sps,
               ms_per_step=1e3 / sps, run_s=run_s, peak_mib_run=peak / 2**20,
               loss_first20=first, loss_last20=last, eval=ev,
               eval_launches=counts, cond_dim=agent.config.cond_dim)

    # kernel B on the trained action U-Net (its pack was primed with the
    # seeded weights) against the rounding twin, at the 1033-wide condition
    batch = next(data.eval_dataloader())
    obs = nz.normalize_tree({k: v.to(dev) for k, v in batch["obs"].items()},
                            agent.obs_normalization["obs"])
    with torch.no_grad(), fp32_math():
        cond = agent._obs_cond(agent.encoders, obs)
    g = torch.Generator(device=dev).manual_seed(16)
    x_init = torch.randn(cond.shape[0], 8, 7, generator=g, device=dev)
    table = agent.sampler.table()
    ts = table[0]
    clip = agent.sched.clip_range
    net = agent._sampling_net()
    agent.sampler(net, cond, x_init)          # repacks from the trained net
    out["trained_b"] = _unet_against_twin(
        smoke, f"trained DP B ({cond.shape[0]} samples, cond "
        f"{cond.shape[1]}, DDIM-{ts.shape[0]})", net, cond, x_init, table,
        clip, agent.sampler._pack, seeded=seeded.planner)

    # kernel B alone at DP's widths, 1024 samples, DDIM-25
    B = UNET_TIMING_SAMPLES
    out["unet_timing"] = _time_unet(
        smoke, f"DP B {list(net.down_dims)} cond {net.global_cond_dim} B={B}",
        net, B, table, clip, g)

    # the encoder over 1024 frames and one decision at 1024 envs, stage by
    # stage (CUDA events; fp32 with TF32 off, as the agent runs it)
    env = configs.make_bench_env(EPISODE_LEN)
    state = physics_states(env, N_ENVS, "cuda", seed=8)
    eobs = env.obs(state)
    window = {k: eobs[k][:, None] for k in configs.BENCH_POLICY_KEYS}
    acts = torch.rand(N_ENVS, 7, device=dev) * 2 - 1
    enc = agent.encoders["agentview_image"]
    frames = window["agentview_image"]

    def encode():
        with torch.no_grad(), fp32_math():
            return agent._obs_cond(agent.encoders, nz.normalize_tree(
                window, agent.obs_normalization["obs"]))
    dcond = encode()
    dx = torch.randn(N_ENVS, 8, 7, generator=g, device=dev)
    stages = {
        "normalize + ResNet-18 encode": encode,
        "action U-Net (kernel B)": lambda: agent.sampler(net, dcond, dx),
        "physics env: 4 transitions, CUDA graph":
            lambda: [env.transition(state, acts) for _ in range(4)],
        "physics env: render + obs (kernel C)": lambda: env.obs(state),
        "sample_action (encode + B + glue)":
            lambda: agent.sample_action({"obs": window}, g),
    }
    dec = {}
    for name, fn in stages.items():
        dec[name] = time_ms(fn, iters=5)
        print(f"   DP decision, {N_ENVS} envs: {name}: {dec[name]:.3f} ms "
              f"[{smoke.card}]", flush=True)
    x = nz.normalize_tree({"agentview_image": frames[:, 0]},
                          agent.obs_normalization["obs"])["agentview_image"]
    flops = conv_flops(enc, x)
    nbytes = frames.numel() + N_ENVS * enc.n_features * 4 + sum(
        p.numel() * 4 for p in enc.parameters())
    e_ms, e_by = bound(flops, nbytes)
    print(f"   ResNet-18 encode of {N_ENVS} frames: {flops / 1e9:.1f} GFLOP "
          f"of convolutions ({flops / N_ENVS / 1e9:.3f} a frame), fp32 bound "
          f"{e_ms:.3f} ms ({e_by}); measured "
          f"{dec['normalize + ResNet-18 encode']:.3f} ms [{smoke.card}]",
          flush=True)
    out.update(decision_ms=dec, encoder_gflop=flops / 1e9,
               encoder_bound_ms=e_ms, encoder_bound_by=e_by)

    # round trip of the full state, then one step from each copy
    restored = DPAgent.create(agent_cfg, meta["shape_meta"],
                              seed=cfg["seed"] + 1, device=dev)
    out.update(_check_round_trip(ws, restored, "DP"))

    # where a train step's time goes (CUDA events, on the restored copy)
    ds = data.device_dataset("train")
    holder = {}
    torch.cuda.reset_peak_memory_stats()
    split_ms, host_ms = _split_step([
        ("gather", lambda: holder.update(b=ds.sample(cfg["batch_size"], g))),
        ("forward+backward", lambda: restored.backward(holder["b"], g)),
        ("optimizer", restored.apply_gradients)], SPLIT_STEPS)
    peak_steps = torch.cuda.max_memory_allocated()
    print(f"   a DP step, device timeline between events (mean of "
          f"{SPLIT_STEPS - 5}): {json.dumps(split_ms)} ms; host time to "
          f"enqueue: {json.dumps(host_ms)} ms; peak memory over these steps "
          f"{peak_steps / 2**20:.1f} MiB [{smoke.card}]", flush=True)
    out.update(step_split_ms=split_ms, step_host_ms=host_ms,
               peak_mib_train_steps=peak_steps / 2**20)
    return out


def _training_phases(smoke: Smoke) -> None:
    """The recipe's training phases in one scratch run directory under the
    checkout's git-ignored ``build/``, removed after; each phase runs only
    if the ones it reads from passed."""
    import shutil
    import tempfile
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    run = TrainRun(Path(tempfile.mkdtemp(prefix="chip_smoke_train_",
                                         dir=build)))
    try:
        smoke.phase("training: demos and the VAE on Lift at the recipe widths",
                    lambda: phase_vae(smoke, run))
        if run.vae_snapshot is None:
            return
        smoke.phase("training: LDP on the trained VAE's latents at the bench "
                    "widths", lambda: phase_ldp_training(smoke, run))
        if run.ldp_agent is not None:
            smoke.phase("training: mixed and action-free data",
                        lambda: phase_mixed(smoke, run))
        smoke.phase("training: DPVAE on the same latents; kernel B at its "
                    "widths", lambda: phase_dp_vae(smoke, run))
        smoke.phase("training: DP on raw frames at the recipe widths",
                    lambda: phase_dp(smoke, run))
    finally:
        shutil.rmtree(run.work, ignore_errors=True)


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
            _training_phases(smoke)

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
