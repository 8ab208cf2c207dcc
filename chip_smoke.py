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
4b. The rest of the main path's runtime (``phase_video``, ``phase_dist``,
   ``phase_roundtrip``, ``phase_prefetch``): the same 1024 × 400 eval with
   ``video_envs=2`` (C once a decision and once a step for the two filmed
   envs, 100 + 400; B and A 100; every frame equal to its state rendered
   alone; the APNG files decode back bit for bit; the wall beside the eval
   without videos; C timed on the two filmed scenes); a process group of
   one rank over NCCL in this process (one dp update at the bench widths
   equal to the plain one bit for bit, the env-sharded eval equal to the
   plain eval), then two ranks on the card over gloo started by ``torchrun
   --nproc_per_node 2`` on this file's ``--dist-worker`` (each rank's half
   of a 256 × 80 eval launching C, B and A 20 times, the gathered results
   equal to each half run alone); the bench agent's seeded weights through
   the reference's naming and back with the tools, then both agents over
   1024 × 400 on identical seeds (equal actions at every decision, success
   delta exactly 0, launches counted); ``HostPrefetcher`` built here,
   batches of 128 windows of raw frames streamed to the card (equal to the
   device gather at their indices), µs a batch beside
   ``DeviceDataset.sample``.
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
   closed loop of 256 envs × 80 steps that films two envs), launch counts
   checked (every ``Workspace`` eval's closed loop launches C 20 + 80
   times: once a decision for the policy, once a step for the videos). The trained
   agent's kernels are held against their plain versions on its trained
   weights (the bars of A and B above; the packs were built from the seeded
   weights before training, so a missed repack fails here); ``sample_viz``
   runs once (one launch of B and of A); the full state round-trips bit for
   bit, and one step from the restored state equals one from the live state
   (cuDNN deterministic); a train step is timed part by part. Then
   hierarchical LDP on the same latents (``lift_ldp_hier_train_config()``:
   a planner [64,128,256] over 2 strided latents and a chunk IDM [64,128]
   k 3 over chunks of 4 actions, neither downsampling) for ``HIER_STEPS``
   steps at batch 128, both losses falling, its eval's closed loop of 256
   envs × 80 steps launching B twice a decision and C once (counts
   checked exactly), B held against its rounding twin on both trained nets
   (packs primed from the seeded weights), ``sample_viz`` once (B twice),
   the state's round trip, a step timed part by part, and B alone, DDIM-25,
   at the recipe's planner (1024 × T 2) and chunk IDM (2048 × T 4) and at
   the yaml's reference widths, each with its bound (products read off the
   kernel's program, counting only the conv taps inside the sequence).
   Then the mixed-data study of ``tools/run_lift_mixed_study.sh`` on that
   trained agent and its latents: episode resets checked to depend on (seed,
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
6. Drives the Lift pipeline from the command line (``phase_drivers``): the
   lines that ``tools/run_lift_pipeline_torch.sh`` and
   ``tools/run_lift_mixed_study_torch.sh`` run, read off the scripts, with
   their step and episode counts cut, each driver's ``main`` in process at
   the recipe widths, in a scratch folder under ``build/``: demos (256 + 32 envs × 80 steps) to ``.npz``, the VAE
   (``DRIVER_VAE_STEPS``), latents, LDP (``DRIVER_LDP_STEPS`` saved every
   ``DRIVER_SAVE_EVERY``), ``eval_bc`` over the three checkpoints at
   ``DRIVER_EVAL_EPISODES`` episodes with ``sweep_batch=3`` (launches during
   the fused sweep: C once, B and A three times a decision, checked
   exactly; its per-episode success must equal three ``run_batched_eval``
   calls with the same seeds, and where any result differs the first
   decision at which they part is printed), ``collect_data`` of the first
   checkpoint (``DRIVER_COLLECT`` episodes) with its latents, and the mixed
   arm (``DRIVER_MIXED_STEPS``). Every file must be there and read back.
7. Can and Square on the contact engine (``phase_pick_place``): first one
   Can control step on the card from the 72 contact states of
   ``tests/fixtures/can_contact_golden.npz`` against JAX's next states
   (``contact_check``: fp32 from the CUDA graph and eagerly, held within 5
   times the card's own fp32-to-fp64 distance, as the CPU test holds the
   CPU's; kernel C's frames of those states against the plain
   renderer's); kernel C on
   1024 Can and 1024 Square scenes (10 prims, 2 of them spheres) from
   states a few expert steps apart, at C's bar; each scripted expert over
   1024 envs × 300 steps from the CUDA graph (every state finite; success
   not told apart from the JAX expert's over the episodes of
   ``tests/fixtures/pick_place_golden.npz`` (and, for Square, of
   ``square_expert_golden.npz``) by Fisher's exact test at the
   3-sigma level, since the reference's experts reach well under 0.9); the
   Can recipe's lines
   read off ``tools/run_can_pipeline_torch.sh`` (demos 256 + 32 × 300
   steps, the VAE ``PP_VAE_STEPS``, latents, LDP ``PP_LDP_STEPS``) and
   ``eval_bc`` over ``PP_EVAL_EPISODES`` × 400 steps, its launches (C, B
   and A 100 each) stated before the run and checked; B and A alone on
   the trained agent at DDIM-25 with their bounds; one Can decision stage
   by stage; a Square closed loop of ``PP_EVAL_EPISODES`` × 400 steps on
   seeded weights, its launches checked likewise.
8. The JAX package's four default agent configurations (``phase_defaults``,
   ``--only defaults``) and then the options their configs take
   (``phase_options_kernels``, ``phase_options``, ``--only options``):
   kernel B with fp32 weights at every default call and the bench planner
   against the fp32 twin (1e-3 after DDPM-100, 2e-4 after DDIM-10), and
   with fp16 weights at every default call against its fp16 rounding twin
   (phase B's statistics), timed beside the bf16 instance, and on a narrow
   net against the twin with and without each of JAX's fp16 rounding
   points and with one sample's draw times 500 (``_fp16_rounding_points``:
   the samples it holds within 1e-6, the overflow's NaN); B at
   the default DP's 3099-wide condition in both weight types, kernel A on
   five IDM variants (mish, no LayerNorm, fixed time features, hidden 48
   and 512) within 1e-3 of the twin, each timed with its bound; the shapes
   the TPU kernels take that the CUDA kernels gained (``_kernel_shapes``,
   ``--only shapes``: A at hidden 36, 1024 and 1536 and with 1100- and
   2048-wide ``[x|s]`` rows; B at 160, 256 and 320 plan steps (320 in bf16
   and fp16) and at 160 in fp32, in the ordinary mode past its rows (288
   steps on down_dims (8, 16, 32) in bf16 and fp16, 160 on (32, 16, 16) in
   fp32), on down_dims (32, 16, 16)
   in both weight types, in the wide mode at 40 rows and with bf16
   operands in global memory on a [1024,2048,4096] planner), each against
   its twin with its plan, time and bound; then LDP
   with ``OPT_LDP``, DP with ``OPT_DP`` and LDP with
   ``fused_dtype: float16`` through ``train_bc`` and
   ``eval_bc`` on a stable VAE trained in bf16 (``OPT_VAE``), launches
   stated before the closed loops and checked.

Prints the card's name and power limit, a ``kernels`` JSON line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA device, when the port's package is not beside this file,
or when any phase fails. ``--out PATH`` also writes the full record (every
phase's numbers) as JSON; ``--only WORDS`` runs the build and the phases
whose names hold one of the comma-separated words, and prints no kernels
line (a development run).
"""

from __future__ import annotations

import argparse
import importlib
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
HIER_STEPS = 400             # LDP-hier, of the baselines' 15000, at batch 128
# the drivers phase: tools/run_lift_pipeline_torch.sh's stages and
# overrides from the command line, with short runs
DRIVER_VAE_STEPS = 200        # of 4000
DRIVER_LDP_STEPS = 300        # of 30000, saved every DRIVER_SAVE_EVERY
DRIVER_SAVE_EVERY = 100
DRIVER_EVAL_EPISODES = 64     # the pipeline's n_eval_episodes
DRIVER_SWEEP_BATCH = 3
DRIVER_COLLECT = 64           # episodes of collect_data
DRIVER_MIXED_STEPS = 100      # the mixed arm, warm-up cut to 50 steps
# the pick_place phase: kernel C on Can and Square scenes of 1024 envs a
# few expert steps apart, each expert over 1024 envs × 300 steps, the Can
# recipe (tools/run_can_pipeline_torch.sh: demos 256 + 32 × 300 steps at
# full count, the VAE and LDP cut) and eval_bc over PP_EVAL_EPISODES × 400
PP_RENDER_ENVS = 1024
PP_RENDER_SPREAD = 40
PP_EXPERT_ENVS = 1024
PP_EXPERT_LEN = 300
PP_VAE_STEPS = 200            # of 4000
PP_LDP_STEPS = 300            # of 30000
PP_EVAL_EPISODES = 256        # the recipe's n_eval_episodes
# ALOHA (phase_aloha): the phys4 recipe's demos at full count
AL_RENDER_ENVS = 1024
AL_RENDER_SPREAD = 40
AL_EXPERT_ENVS = 1024
AL_EXPERT_LEN = {"cube": 120, "insertion": 160}
AL_VAE_STEPS = 200            # of 4000
AL_LDP_STEPS = 300            # of 200000
AL_EVAL_EPISODES = 256        # the recipe's eval_bc n_eval_episodes
AL_LOOP_ENVS = 256


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
    def __init__(self, card: str, only: list[str] | None = None):
        self.card = card
        self.only = only
        self.record: dict = {"card": card, "phases": {}}
        self.kernels: dict = {}
        self.failures: list[str] = []

    def phase(self, name, fn):
        if self.only and name != "build" and not any(w in name
                                                     for w in self.only):
            return
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


def mlp_entry(net, rows: int, chunked: bool = False) -> str:
    """The mangled-name part of kernel A's instance for ``net`` at ``rows``
    rows a block, its ``[x|s]`` row whole or walked in chunks."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA)
    Hp = KA.padded(KA.hidden(net))
    return (f"mlp_sampler_kernelILi{Hp // 64}ELi{rows}ELb"
            f"{int(net.use_layer_norm)}ELi{KA.passes(Hp)}ELb{int(chunked)}E")


def idm_flops_bytes(net, N, S, A, T, with_noise):
    H = net.trunk.dense0.out_features
    C1 = net.cond.dense[-1].out_features
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
            f"A {mode}", mlp_entry(net, 64),
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


def taps_inside(n_out, k, stride, offset, n_in) -> int:
    """(output row, tap) pairs of a 1-D conv, output row o reading input
    row ``stride·o + j - offset`` at tap j, whose input row lies inside
    [0, n_in): the products the function needs, since a tap on the padding
    multiplies a zero."""
    return sum(0 <= stride * o + j - offset < n_in
               for o in range(n_out) for j in range(k))


def unet_entry(row_tiles: int, wide: bool, fp32: bool = False,
               fp16: bool = False) -> str:
    """The mangled-name part of kernel B's main instance for a tile of
    ``row_tiles`` m16 row tiles (instances of 2, 4, 8 and, bf16 and fp16,
    16; the fp32 wide mode 2; more rows in the largest's copy that walks
    them in groups), in wide mode or not, with bf16, fp16 or fp32
    weights."""
    top = (2 if wide else 8) if fp32 else 16
    entry = next(n for n in (2, 4, 8, 16) if min(row_tiles, top) <= n)
    w = "f" if fp32 else "6__half" if fp16 else "13__nv_bfloat16"
    return (f"unet1d_sampler_kernelI{w}Li{entry}ELb{int(wide)}E"
            f"Lb{int(row_tiles > top)}E")


def unet_flops_bytes(net, B, T, steps, weight_bytes: int = 2):
    """(fp32 elementwise FLOPs, bf16-weight product FLOPs, bytes). The TPU
    kernel multiplies bf16 by bf16 with fp32 accumulation, so its products
    are counted at the bf16 tensor-core peak. A conv counts only the taps
    that land inside the sequence (a 2-long plan under 5 taps reads 4 of
    10); each FiLM projection counts its time half once a step and its
    condition half once a sample, as the kernel's prologue computes them."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)
    recs = K.build_program(net, T, 1)["records"]
    k = net.kernel_size
    same = lambda tl: taps_inside(tl, k, 1, k // 2, tl)
    per = elem = film_t = film_g = 0
    for r in recs:
        if r[0] == K.FILM:
            cin, ch, tl = r[1:4]
            per += 2 * same(tl) * ch * (cin + ch)
            film_t += 2 * net.dsed * 2 * ch
            film_g += 2 * net.global_cond_dim * 2 * ch
            if r[7] >= 0:
                per += 2 * tl * cin * ch
            else:
                elem += tl * ch
            elem += 2 * 12 * tl * ch         # two GroupNorm + Mish passes
        elif r[0] == K.DOWN:                 # k 3, stride 2, pad (0, 1)
            ch, tin = r[1:3]
            per += 2 * taps_inside(tin // 2, 3, 2, 0, tin) * ch * ch
        elif r[0] == K.UP:                   # x[t] w[j] -> y[2t + 2 - j]
            ch, tin = r[1:3]
            per += 2 * taps_inside(tin, 4, 2, 1, 2 * tin) * ch * ch
        elif r[0] == K.FINAL_BLOCK:
            per += 2 * same(r[3]) * r[1] * r[2]
            elem += 12 * r[3] * r[2]
        elif r[0] == K.FINAL_CONV:
            per += 2 * r[3] * r[1] * r[2]
    d = net.dsed
    once = 2 * (d * 4 * d + 4 * d * d) + film_t
    mm = steps * (once + B * per) + B * film_g
    elem = steps * B * (elem + 10 * T * net.input_dim)
    weights = sum(p.numel() for p in net.parameters()) * weight_bytes
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
            ("reference torch-init", (256, 512, 1024), 64,
             p["diffusion_step_embed_dim"], False),
            ("padded", (24, 40), 16, 64, False)):
        # the port's own init (Flax's draws) from seed 3; the second
        # reference net holds torch's default draws, U(±1/√fan_in) for
        # weights and biases: Flax's init zeroes every bias, so the
        # kernel's bias paths show only on these
        net = ConditionalUnet1D(25, 25, dsed, dd, p["kernel_size"],
                                p["n_groups"],
                                generator=torch.Generator().manual_seed(3))
        if "torch-init" in name:
            torch.manual_seed(3)
            for m in net.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters()
        net = net.to(dev)
        twin_net = K.rounding_twin(net)
        # the same rounded function with fp64 sums: bf16 products are exact
        # in fp64, so it stands for no particular summation order
        twin64 = K.rounding_twin(net).double()
        g = torch.Generator(device=dev).manual_seed(4)
        gc = torch.randn(B, 25, generator=g, device=dev)
        x0 = torch.randn(B, 8, 25, generator=g, device=dev)
        nudge = x0 * (1 + 2e-7 * torch.randn(x0.shape, generator=g, device=dev))
        packed = K.pack_params(net).to(dev)
        run_k = lambda n=10: K.fused_unet1d_ddim_sample(
            net, gc, x0, ts[:n], coefs[:n], packed=packed)
        run_p = lambda n=10, x=x0, m=twin_net: K.unet1d_ddim_sample_plain(
            m, gc, x, ts[:n], coefs[:n])
        run_64 = torch.no_grad()(lambda n=1: dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, gc.double()), x0.double(), ts[:n],
            coefs[:n].double(), None, 1.0))
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and got.shape == (B, 8, 25)
        one = err_stats(run_k(1), run_p(1))
        ref64 = run_64(1)
        # after 1 step, each beside the fp64-sum twin: the kernel, the fp32
        # twin (torch's summation order), the fp32 twin from an input moved
        # by 2e-7, and the unrounded fp32 net
        one64 = {"kernel": err_stats(run_k(1), ref64),
                 "twin fp32": err_stats(run_p(1), ref64),
                 "twin fp32, input moved by 2e-7": err_stats(
                     run_p(1, nudge), ref64),
                 "unrounded fp32 net": err_stats(run_p(1, x0, net), ref64)}
        full = err_stats(got, ref)
        self_move = err_stats(ref, run_p(10, nudge))
        fp32 = err_stats(run_p(10, x0, net), ref)
        what = f"B {name} {list(dd)} B={B}"
        print(f"   {what}: after 1 step {one}", flush=True)
        for k, v in one64.items():
            print(f"   {what}: after 1 step, {k} against the fp64-sum twin: "
                  f"{v}", flush=True)
        print(f"   {what}: after 10 steps {full}", flush=True)
        print(f"   {what}: the twin against itself, input moved by 2e-7: "
              f"{self_move}", flush=True)
        print(f"   {what}: the unrounded fp32 net against the twin: {fp32}",
              flush=True)
        # bf16 roundings flip where a value lies within fp32 rounding of a
        # bf16 tie, so any fp32 summation order departs from the fp64-sum
        # twin in some elements: the kernel may depart in as many as the
        # fp32 twin does, or in 1%
        beyond = {k: 1 - v["frac_within_5e3"] for k, v in one64.items()}
        smoke.check(f"{what} share of elements beyond 5e-3 after 1 step "
                    "(kernel against the fp64-sum twin)", beyond["kernel"],
                    max(1e-2, beyond["twin fp32"]))
        if "torch-init" in name:     # the bar as it was set on these weights
            smoke.check(f"{what} share of elements beyond 5e-3 after 1 step",
                        1 - one["frac_within_5e3"], 1e-2)
        smoke.check(f"{what} mean_abs_err after 10 steps", full["mean"], 5e-3)
        smoke.check(f"{what} max_abs_err after 10 steps", full["max"], 0.1)
        if not full["mean"] < fp32["mean"]:
            raise AssertionError(f"{what}: the kernel is no closer to the "
                                 "rounding twin than the fp32 net is")
        out[name] = dict(max_abs_err=full["max"], mean_abs_err=full["mean"],
                         one_step=one, one_step_vs_fp64_twin=one64,
                         ten_steps=full, twin_self_move=self_move,
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
        info = smoke.shape_line(
            f"B {name}", unet_entry(row_tiles, False), shape, mm,
            PEAK_BF16_FLOPS, "bf16 tensor-core", ms)
        out[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, bf16_flops=mm, fp32_flops=elem,
                         bytes=nbytes, shape=info)
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
    for name, scene, cam, n_convex in (
            ("lift", env.scene(state), env.camera, 0),
            ("convex", convex_scenes(64, dev),
             R.look_at((0.55, 0.0, 1.25), (0.0, 0.0, 0.85)), 1),
            ("physics", penv.scene(pstate), penv.camera, 0)):
        out[name] = raycast_case(smoke, name, scene, cam, n_convex)
    smoke.kernels["raycast"] = dict(out["physics"])
    return out


def raycast_case(smoke: Smoke, name: str, scene, cam, n_convex: int,
                 H: int = 64, W: int = 64) -> dict:
    """Kernel C on ``scene`` against its twin (at least 99.9% of pixels
    within 2.0, the image finite), timed through its wrapper and as the
    launch alone beside the twin, with its operations counted from
    ``csrc/raycast.cu`` and its bound. ``cam`` is one camera for every env
    or an ``R.CameraBatch``, one per env."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops import render as R
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build
    from latent_diffusion_planning_tpu_torch.ops.kernels import raycast as K

    dev = scene.pos.device
    per_env = isinstance(cam, R.CameraBatch)
    rays = K.default_rays(cam, H, W, dev)
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
    # per k-DOP 15 and 6 a half-space; with a camera per env, the ray's
    # rotation into the env's frame 18 and the plane's reciprocal 1
    boxes = [n_convex + i for i, k in enumerate(kinds) if k == 0]
    slab_tests = 0
    if per_env:
        origin = cam.pos[:, None]                         # (N, 1, 3)
        world = torch.einsum("nij,xj->nxi", cam.basis,
                             rays.reshape(-1, 3))         # (N, HW, 3)
    else:
        origin = torch.tensor(cam.pos, device=dev)
        world = rays.reshape(1, -1, 3)
    for box in boxes:      # one box at a time: (N, HW) at most
        oc = origin.reshape(-1, 3) - scene.pos[:, box]    # (N, 3)
        b = (world * oc[:, None]).sum(-1)                 # (N, HW)
        c_bound = ((oc * oc).sum(-1) - 1.0201 * (
            scene.size[:, box] ** 2).sum(-1))[:, None]
        passes = (b * b - c_bound >= 0) & ~((b > 0) & (c_bound > 0))
        slab_tests += int(passes.sum())
    per_pixel = (43 + 7 * n_box + 10 * n_sphere
                 + (15 + 6 * K_planes) * n_convex + (19 if per_env else 0))
    ops = N * H * W * per_pixel + 24 * slab_tests
    per_pixel = ops / (N * H * W)
    nbytes = 4 * (N * H * W * 3 + H * W * 3 + 12
                  + (12 * N if per_env else 0)) + scene_bytes(scene,
                                                              n_convex)
    b_ms, b_by = bound(ops, nbytes)
    E = args[-1]
    print(f"   C {name}: {slab_tests / max(1, N * H * W * n_box):.2%} of "
          "the (ray, box) pairs pass the bounding sphere", flush=True)
    info = smoke.shape_line(
        f"C {name}", f"raycast_kernelILb1ELb{int(per_env)}E",
        dict(pixels_per_thread=4, pixels_per_block=1024,
             envs_per_block=E, grid=[-(-H * W // 1024), -(-N // E)],
             camera_per_env=per_env,
             smem_bytes=K.smem_bytes(P, K_planes, n_convex, E, per_env),
             flops_per_pixel=per_pixel, weight_bytes_streamed=0), ops,
        PEAK_FP32_FLOPS, "fp32 CUDA-core", ms)
    return dict(max_abs_err=err, frac_within_2=frac, ms=ms,
                launch_only_ms=launch_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, ops=ops, bytes=nbytes,
                shape=info)


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


def eval_raycasts(n_dec: int, action_horizon: int) -> int:
    """Kernel C's launches in a ``Workspace`` eval's closed loop: one a
    decision for the policy's frames, and one every env step for the two
    envs it films (``video_envs = min(2, n_eval_episodes)``)."""
    return n_dec + n_dec * action_horizon


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
            "raycast": eval_raycasts(n_dec, cfg["action_horizon"])}
    print(f"   eval: launches {counts} (expected {want}: one offline batch "
          f"of each split through A and B, then {n_dec} decisions, C also "
          f"every step for the two filmed envs)", flush=True)
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
                "raycast": eval_raycasts(n_dec, cfg["action_horizon"])}
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
                       seeded=None, hold_max=True, plan=None,
                       dtype=None) -> dict:
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
    would sit there). ``plan`` overrides the kernel's plan (``nb``,
    ``wide``); ``dtype`` the weight type (bf16, or fp16 against its own
    rounding twin)."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    dtype = dtype or KB.WEIGHT_DTYPE
    twin = KB.rounding_twin(net, dtype)
    ts, coefs = table
    plain = lambda m, n=None: KB.unet1d_ddim_sample_plain(
        m, cond, x_init, ts[:n], coefs[:n], clip)
    kernel = lambda n=None: KB.fused_unet1d_ddim_sample(
        net, cond, x_init, ts[:n], coefs[:n], clip_range=clip, packed=packed,
        dtype=dtype, **(plan or {}))
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


def _time_unet(smoke, what, net, B, table, clip, g, T=8, plan=None,
               dtype=None) -> dict:
    """Kernel B alone on ``net`` at ``B`` samples of length ``T`` over
    ``table`` (seeded condition and initial sample): held against the
    rounding twin (the max as a reading), timed beside the twin, with its
    launch geometry, the weight bytes it streams and its bound; ``plan``
    overrides the kernel's plan as ``fused_unet1d_ddim_sample`` takes it;
    ``dtype`` the weight type (bf16 or fp16; fp16's products are counted at
    the same tensor-core peak)."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    dtype = dtype or KB.WEIGHT_DTYPE
    ts, coefs = table
    gc = torch.randn(B, net.global_cond_dim, generator=g, device="cuda")
    x0 = torch.randn(B, T, net.input_dim, generator=g, device="cuda")
    packed = KB.pack_params(net, dtype).to("cuda")
    plan = plan or {}
    checks = _unet_against_twin(smoke, what, net, gc, x0, table, clip, packed,
                                hold_max=False, plan=plan, dtype=dtype)
    twin = KB.rounding_twin(net, dtype)
    run_k = lambda: KB.fused_unet1d_ddim_sample(
        net, gc, x0, ts, coefs, clip_range=clip, packed=packed, dtype=dtype,
        **plan)
    run_p = lambda: KB.unet1d_ddim_sample_plain(twin, gc, x0, ts, coefs, clip)
    ms, plain_ms = time_ms(run_k, iters=3), time_ms(run_p, iters=1)
    smoke.timing(what, ms, plain_ms)
    elem, mm, nbytes = unet_flops_bytes(net, B, T, int(ts.shape[0]))
    b_ms, b_by = bound(elem, nbytes, bf16_flops=mm)
    shape = KB.kernel_info(net, B, T, int(ts.shape[0]), dtype=dtype, **plan)
    row_tiles = -(-shape["samples_per_block"] * T // 16)
    info = smoke.shape_line(
        what, unet_entry(row_tiles, shape["wide"],
                         fp16=dtype == torch.float16), shape,
        mm, PEAK_BF16_FLOPS, "bf16/fp16 tensor-core", ms)
    print(f"   {what}: bound {b_ms:.3f} ms ({b_by}) = {b_ms / ms:.2%} of "
          f"the kernel's time; weights "
          f"{shape['weight_bytes_per_step_and_block'] / 1e6:.1f} MB a step "
          f"and block, {shape['weight_bytes_streamed'] / 1e9:.1f} GB "
          f"streamed in all [{smoke.card}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / ms, bf16_flops=mm, fp32_flops=elem,
                bytes=nbytes, shape=info, **checks)


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
            "raycast": eval_raycasts(n_dec, cfg["action_horizon"])}
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


def phase_ldp_hier(smoke: Smoke, run: TrainRun):
    """Hierarchical LDP (stage 3 of ``tools/run_lift_baselines.sh``,
    ``lift_ldp_hier_train_config()``: a planner [64,128,256] k 5 over P = 2
    strided latents and a chunk IDM [64,128] k 3 over chunks of 4 actions,
    neither downsampling; DDPM-50 training, DDIM-25 sampling) on the LDP
    phase's latents, through the ``Workspace`` for ``HIER_STEPS`` of its
    15000 steps at batch 128; its eval ends with a closed loop of
    ``EVAL_ENVS`` × 80 steps that launches kernel B twice a decision
    (planner, then chunk IDM) and C once. Then kernel B on both trained
    nets against their rounding twins (packs primed from the seeded
    weights), ``sample_viz`` once, the state's round trip, a step timed
    part by part, and kernel B alone at the recipe's shapes and at the
    yaml's reference widths."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.data.datasets import OfflineData
    from latent_diffusion_planning_tpu_torch.models.agents.ldp_hier import (
        LDPHierAgent)
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        unet_from_config)
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.train.loop import Workspace

    dev = torch.device("cuda")
    out: dict = {}
    cfg = configs.lift_ldp_hier_train_config(
        vae_pretrain_path=str(run.vae_snapshot))
    cfg.update(n_grad_steps=HIER_STEPS, n_eval_episodes=EVAL_ENVS,
               eval_every=0, save_every=0, log_every=100, resume=False)
    cfg["data"]["env_params"]["env"]["episode_len"] = DEMO_LEN
    meta = cfg["data"]["meta"]
    agent_cfg = {**cfg["agent"], "obs_normalization": meta["obs_normalization"]}
    data_kw = {k: v for k, v in cfg["data"].items() if not k.endswith("path")}
    data = OfflineData(**data_kw, train=run.welded["train"],
                       eval=run.welded["eval"], device=dev)
    ws = Workspace(cfg, run.work / "ldp_hier", data=data, device=dev)
    ws.init_agent()
    agent = ws.agent
    if not isinstance(agent, LDPHierAgent):
        raise AssertionError(f"the workspace built a {type(agent).__name__}")
    P, k = agent.plan_length, agent.config.idm_horizon
    # prime both packs with the seeded weights (see the LDP phase):
    # sample_action packs the chunk IDM, sample_plan_stats the planner
    primer = next(data.eval_dataloader())
    agent.sample_action(primer)
    agent.sample_plan_stats(primer)
    seeded = LDPHierAgent.create(agent_cfg, meta["shape_meta"],
                                 seed=cfg["seed"], device=dev)

    # the eval that ends run(): per split one sample_action (B on the chunk
    # IDM) and one sample_plan_stats (B on the planner at the window's
    # length), then per decision B on the planner, B on the chunk IDM and
    # C for the frame; no MLP-IDM
    n_dec = math.ceil(DEMO_LEN / cfg["action_horizon"])
    want = {"diffusion_mlp": 0, "diffusion_unet1d": 2 * 2 + 2 * n_dec,
            "raycast": eval_raycasts(n_dec, cfg["action_horizon"])}
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ws.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    curve = ws.loss_curve()
    first, last = _loss_means(curve)
    sps = HIER_STEPS / ws.train_seconds
    print(f"   LDP-hier: {HIER_STEPS} steps at batch {cfg['batch_size']} in "
          f"{ws.train_seconds:.3f} s = {sps:.2f} steps/s, {1e3 / sps:.2f} ms "
          f"a step; run() with its snapshot and eval {run_s:.3f} s; peak "
          f"memory {peak / 2**20:.1f} MiB [{smoke.card}]", flush=True)
    for key in ("plan_loss", "idm_loss"):
        print(f"   LDP-hier {key}: mean of the first 20 steps "
              f"{first[key]:.5f}, of the last 20 {last[key]:.5f}", flush=True)
    _falls(curve, ("plan_loss", "idm_loss"), first, last)
    print(f"   LDP-hier eval: launches {counts} (expected {want}: per split "
          f"one sample_action and one sample_plan_stats through B, then "
          f"{n_dec} decisions through B twice and C once)", flush=True)
    if counts != want:
        raise AssertionError(f"LDP-hier eval launches {counts} != {want}")
    ev = ws.last_eval
    for split in ("train", "eval"):
        print(f"   LDP-hier eval {split}: action_mse "
              f"{ev[f'{split}_action_mse']:.5f}, plan_mse "
              f"{ev[f'{split}_plan_mse']:.6f} against plan_mse_persist "
              f"{ev[f'{split}_plan_mse_persist']:.6f}", flush=True)
    print(f"   LDP-hier closed loop, {EVAL_ENVS} envs x {DEMO_LEN} steps after "
          f"{HIER_STEPS} steps (a reading): success {ev['success']:.4f}, "
          f"horizon {ev['horizon']:.2f}, {ev['env_steps_per_sec']:.1f} "
          f"env-steps/s to the episodes' ends, "
          f"{ev['computed_env_steps_per_sec']:.1f} computed env-steps/s "
          f"[{smoke.card}]", flush=True)
    bad = [key for key, v in ev.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"LDP-hier eval metrics not finite: {bad}")
    out.update(train_steps=HIER_STEPS, batch=cfg["batch_size"],
               train_s=ws.train_seconds, steps_per_s=sps,
               ms_per_step=1e3 / sps, run_s=run_s, peak_mib_run=peak / 2**20,
               loss_first20=first, loss_last20=last, eval=ev,
               eval_launches=counts, eval_launches_expected=want)

    # kernel B on both trained nets against their rounding twins; the
    # packs the agent hands over were primed from the seeded weights, so a
    # missed repack fails here
    g = torch.Generator(device=dev).manual_seed(16)
    emb = agent._obs_cond(agent._prepare_eval_batch(
        next(data.eval_dataloader()))["obs"])
    c = agent.config
    for name, steps, cond, shape in (
            ("planner", c.planner_inference_steps, emb[:, 0],
             (emb.shape[0], P, c.obs_dim)),
            ("idm", c.idm_inference_steps, agent._strided_pairs(emb),
             (emb.shape[0] * (emb.shape[1] - 1) // k, k, c.action_dim))):
        sched = getattr(agent, f"{name}_sched")
        x_init = torch.randn(shape, generator=g, device=dev)
        out[f"trained_b_{name}"] = _unet_against_twin(
            smoke, f"trained LDP-hier B {name} ({shape[0]} samples, T "
            f"{shape[1]}, DDIM-{steps})", agent._inference_net(name), cond,
            x_init, agent._table(sched, steps), agent._clip(sched),
            agent._packed(name), seeded=getattr(seeded, name))

    # plan visualization once, on windows of obs_horizon + P steps (plan_mse
    # against the next P latents, as the JAX agent compares them)
    viz_batch = next(data.eval_dataloader())
    viz_batch = {"obs": {key: v[:, :1 + P]
                         for key, v in viz_batch["obs"].items()}}
    kernels.reset_launch_counts()
    acts, viz = agent.sample_viz(viz_batch, g)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {"diffusion_mlp": 0, "diffusion_unet1d": 2, "raycast": 0}
    pv = viz["plan_viz"]
    print(f"   LDP-hier sample_viz on {acts.shape[0]} eval windows: actions "
          f"{tuple(acts.shape)}, plan_mse {float(viz['plan_mse']):.6f}, "
          f"plan_viz {tuple(pv.shape)} in [{float(pv.min()):.3f}, "
          f"{float(pv.max()):.3f}], launches {counts} (expected {want})",
          flush=True)
    if (counts != want or tuple(pv.shape[:2]) != (acts.shape[0], P * k)
            or not (torch.isfinite(acts).all() and torch.isfinite(pv).all())):
        raise AssertionError(f"LDP-hier sample_viz: launches {counts}, "
                             f"plan_viz {tuple(pv.shape)}")
    out.update(viz_plan_mse=float(viz["plan_mse"]), viz_launches=counts)

    restored = LDPHierAgent.create(agent_cfg, meta["shape_meta"],
                                   seed=cfg["seed"] + 1, device=dev)
    out.update(_check_round_trip(ws, restored, "LDP-hier"))

    ds = data.device_dataset("train")
    holder = {}
    split_ms, host_ms = _split_step([
        ("gather", lambda: holder.update(b=ds.sample(cfg["batch_size"], g))),
        ("forward+backward",
         lambda: restored.backward(holder["b"], True, True, g)),
        ("optimizer", lambda: restored.apply_gradients(True, True))],
        SPLIT_STEPS)
    print(f"   a LDP-hier train step, device timeline between events (mean "
          f"of {SPLIT_STEPS - 5}): {json.dumps(split_ms)} ms; host time to "
          f"enqueue: {json.dumps(host_ms)} ms [{smoke.card}]", flush=True)
    out.update(step_split_ms=split_ms, step_host_ms=host_ms)

    # kernel B alone, DDIM-25: the recipe's planner at 1024 samples of 2
    # latents and its chunk IDM at the 2048 chunks of 1024 decisions, then
    # the yaml's reference widths at the same shapes
    timing = {}
    ref = {"planner": [256, 512, 1024], "idm_net": [256, 512]}
    for name, net_key, B, T in (("planner", "planner", 1024, P),
                                ("idm", "idm_net", 2048, k)):
        sched = getattr(agent, f"{name}_sched")
        steps = getattr(c, f"{name}_inference_steps")
        table, clip = agent._table(sched, steps), agent._clip(sched)
        trained = agent._inference_net(name)
        torch.manual_seed(17)
        wide = unet_from_config({**cfg["agent"][net_key],
                                 "down_dims": ref[net_key]},
                                trained.input_dim,
                                trained.global_cond_dim).to(dev)
        for label, net in (("recipe", trained), ("reference", wide)):
            timing[f"{name}_{label}"] = _time_unet(
                smoke, f"LDP-hier B {name} {label} {list(net.down_dims)} "
                f"B={B} T={T}", net, B, table, clip, g, T=T)
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
          f"prologue takes {KB.COND_ROWS} samples a block",
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
            "raycast": eval_raycasts(n_dec, cfg["action_horizon"])}
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


# ---------------------------------------------------------------------------
# the command-line drivers
# ---------------------------------------------------------------------------
def recipe_lines(script: str, work: Path, env: dict) -> list:
    """(driver, argv) of each ``python tools/<driver>_torch.py`` line that
    the recipe script ``tools/<script>`` runs, read off a run of a copy of
    it in ``work`` with ``env`` set and a ``python`` on PATH that records
    its arguments and does nothing else (``python -``, the study's report,
    is left out)."""
    import os
    import shutil
    import subprocess
    (work / "tools").mkdir(parents=True, exist_ok=True)
    (work / "bin").mkdir(exist_ok=True)
    shutil.copy(REPO / "tools" / script, work / "tools" / script)
    shim = work / "bin" / "python"
    shim.write_text('#!/bin/bash\n[ "$1" = "-" ] && { cat > /dev/null; '
                    'exit 0; }\nline=$(printf "%s\\037" "$@")\n'
                    'printf "%s\\n" "$line" >> "$CMDS"\n')
    shim.chmod(0o755)
    cmds = work / f"{script}.lines"
    subprocess.run(["bash", str(work / "tools" / script)], cwd=work,
                   check=True, capture_output=True, timeout=60,
                   env={**os.environ, **env, "CMDS": str(cmds),
                        "PATH": f"{work / 'bin'}:{os.environ['PATH']}"})
    lines = [line.split("\x1f")[:-1]
             for line in cmds.read_text().splitlines()]
    return [(Path(line[0]).stem.removesuffix("_torch"), line[1:])
            for line in lines]


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _recording_policy(store: list):
    """A policy that records what it saw and returned, then acts as the
    engine's default does."""
    from latent_diffusion_planning_tpu_torch.rollout import engine

    def policy(agent, view, gen):
        actions = engine.agent_sample_policy(agent, view, gen)
        store.append(({k: v.clone() for k, v in view.items()},
                      actions.clone()))
        return actions
    return policy


def _first_parting(env, agents, n, seeds, kw) -> dict:
    """Replay the fused sweep and the sequential evals with recording
    policies; the first decision where an agent's observations or its
    actions differ, and by how much."""
    from latent_diffusion_planning_tpu_torch.rollout import engine
    fused: list = []
    engine.run_batched_eval_multi(env, agents, n, seeds,
                                  policy=_recording_policy(fused), **kw)
    alone = []
    for agent, seed in zip(agents, seeds):
        store: list = []
        engine.run_batched_eval(env, agent, n, seed,
                                policy=_recording_policy(store), **kw)
        alone.append(store)
    K = len(agents)
    for d in range(len(alone[0])):
        for k in range(K):
            (view_f, act_f), (view_s, act_s) = fused[d * K + k], alone[k][d]
            obs = {key: float((view_f[key].double() - view_s[key].double())
                              .abs().max()) for key in view_f}
            if any(v != 0.0 for v in obs.values()):
                return dict(decision=d, agent=k, part="observations (the "
                            "env's states or their render)", max_diff=obs)
            act = float((act_f.double() - act_s.double()).abs().max())
            if act != 0.0:
                return dict(decision=d, agent=k, part="actions (the policy)",
                            max_diff=act)
    return dict(decision=None)


def phase_drivers(smoke: Smoke, device: str = "cuda"):
    """The stages of ``tools/run_lift_pipeline_torch.sh`` and
    ``tools/run_lift_mixed_study_torch.sh`` from the command line: the
    lines the scripts run (``recipe_lines``) with their step and episode
    counts cut, each driver's ``main`` called in process in a scratch
    folder under the checkout's git-ignored ``build/`` (removed after), at
    the recipe widths: demos (256 + 32 physics
    envs × 80 steps), the VAE (``DRIVER_VAE_STEPS``), latents, LDP
    (``DRIVER_LDP_STEPS``, saved every ``DRIVER_SAVE_EVERY``), ``eval_bc``
    over the three checkpoints at ``DRIVER_EVAL_EPISODES`` episodes with
    ``sweep_batch=3`` (launches during the fused sweep counted: C once, B
    and A three times a decision), the fused sweep's per-episode results
    against three ``run_batched_eval`` calls with the same seeds,
    ``collect_data`` (``DRIVER_COLLECT`` episodes of the first checkpoint)
    and its latents, and the mixed arm (``DRIVER_MIXED_STEPS``). Every file
    must be there and read back."""
    import os
    import shutil
    import tempfile
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_drivers_", dir=build))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        return _drive_pipeline(smoke, work, device)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def _drive_pipeline(smoke: Smoke, work: Path, device: str) -> dict:
    import csv
    import numpy as np
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.data import ingest
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.utils.config import load_config

    # the recipe scripts' stages, their counts cut; the paths are
    # relative, so the drivers run in the scratch folder
    ds, exp = work / "datasets", work / "experiments"
    knobs = {"DATA": "datasets",
             "ARGS": "" if device == "cuda" else f"device={device}"}
    pipeline = recipe_lines("run_lift_pipeline_torch.sh", work, knobs)
    V, L, S, M = (DRIVER_VAE_STEPS, DRIVER_LDP_STEPS, DRIVER_SAVE_EVERY,
                  DRIVER_MIXED_STEPS)
    study = recipe_lines("run_lift_mixed_study_torch.sh", work, {
        **knobs, "STEPS": str(M), "N_EVAL": str(DRIVER_EVAL_EPISODES),
        "SUBOPT_CKPT": f"{S}.ckpt"})
    vae_path = f"experiments/pipeline_torch/vae/ckpt/{V}.ckpt"
    cuts = {
        "train_vae": [f"n_grad_steps={V}", f"eval_every={V}",
                      f"save_every={V}"],
        "process_latents": [f"vae_snapshot_path={vae_path}"],
        "train_bc": [f"agent.vae_pretrain_path={vae_path}",
                     f"n_grad_steps={L}", f"save_every={S}",
                     f"eval_every={L}"],
        "collect_data": [f"n_episodes={DRIVER_COLLECT}"],
        # the study's own STEPS; warm-up cut to half of them
        "train_mixed_bc": [f"agent.vae_pretrain_path={vae_path}",
                           f"warmup_steps={M // 2}"],
    }
    print(f"   stages of the recipe scripts: "
          f"{[d for d, _ in pipeline + study]}", flush=True)
    if [d for d, _ in pipeline] != ["collect_demos", "collect_demos",
                                    "train_vae", "process_latents",
                                    "train_bc"]:
        raise AssertionError(f"pipeline stages {pipeline}")
    out: dict = {"stage_s": {}}

    def stage(name, line):
        driver, argv = line
        module = importlib.import_module(
            f"latent_diffusion_planning_tpu_torch.drivers.{driver}")
        t0 = time.perf_counter()
        module.main(argv + cuts.get(driver, []))
        _sync(device)
        out["stage_s"][name] = time.perf_counter() - t0
        print(f"   {name}: {out['stage_s'][name]:.1f} s [{smoke.card}]",
              flush=True)

    def need(path: Path) -> Path:
        if not path.exists():
            raise AssertionError(f"{path.relative_to(work)} was not written")
        return path

    for (split, _, _), line in zip(DEMO_SPLITS, pipeline[:2]):
        stage(f"collect_demos {split}", line)
    stage("train_vae", pipeline[2])
    need(work / vae_path)
    need(exp / "pipeline_torch" / "vae" / "html" / f"recon_{V}.html")
    stage("process_latents", pipeline[3])
    stage("train_bc", pipeline[4])
    ldp = exp / "pipeline_torch" / "ldp"
    steps = list(range(S, L + 1, S))
    for step in steps:
        need(ldp / "ckpt" / f"{step}.ckpt")

    # every file reads back
    demos = ingest.load_npz(str(need(ds / "demos.npz")),
                            configs.BENCH_POLICY_KEYS)
    lat = ingest.load_npz(str(ds / "demos_eval.npz"),
                          ["robot0_eef_pos", "latent_agentview_image"],
                          latent_path=str(need(ds / "demos_eval_latent.npz")))
    z = lat.arrays["latent_agentview_image"]
    with np.load(ds / "demos_latent.npz") as f:
        bounds = (float(f["data/min_z"]), float(f["data/max_z"]))
    img = demos.arrays["agentview_image"]
    meta = demos.env_meta
    print(f"   read back: {demos.n_demos} demos, {demos.total_steps} frames "
          f"{tuple(img.shape[1:])} {img.dtype}, env {meta}; eval latents "
          f"{tuple(z.shape)}, train bounds {bounds}", flush=True)
    if not (demos.n_demos >= 0.95 * DEMO_SPLITS[0][1]
            and img.dtype == torch.uint8
            and meta["env_name"] == "LiftPhysicsEnv"
            and meta["env_kwargs"]["episode_len"] == DEMO_LEN
            and z.shape[1] == 16 and bool(z.isfinite().all())
            and bool((demos.demo_lengths == DEMO_LEN + 1).all())):
        raise AssertionError("the demos or latents do not read back as "
                             "written")
    run_cfg = load_config(str(need(ldp / "config.json")))
    if run_cfg.agent.planner.down_dims != [64, 128, 256]:
        raise AssertionError(f"config.json: {run_cfg.agent.planner}")
    out.update(demos=demos.n_demos, latent_bounds=bounds)

    # the fused sweep, its launches counted around the engine call
    fused = {}
    real = engine.run_batched_eval_multi

    def counted(*args, **kw):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = real(*args, **kw)
        _sync(device)
        fused.update(counts=kernels.launch_counts(), args=args, kw=kw,
                     results=res, wall_s=time.perf_counter() - t0)
        return res
    engine.run_batched_eval_multi = counted
    try:
        stage("eval_bc", ("eval_bc", [
            f"run_dir={ldp.relative_to(work)}",
            f"n_eval_episodes={DRIVER_EVAL_EPISODES}",
            f"sweep_batch={DRIVER_SWEEP_BATCH}", *knobs["ARGS"].split()]))
    finally:
        engine.run_batched_eval_multi = real
    with open(need(ldp / "eval_sweep" / "eval.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    got_steps = [int(float(r["step"])) for r in rows]
    print(f"   eval_sweep/eval.csv: steps {got_steps}, success "
          f"{[float(r['success']) for r in rows]}", flush=True)
    if got_steps != steps:
        raise AssertionError(f"eval.csv rows {got_steps}, expected {steps}")
    n_dec = math.ceil(80 / 4)
    want = {"raycast": n_dec, "diffusion_unet1d": DRIVER_SWEEP_BATCH * n_dec,
            "diffusion_mlp": DRIVER_SWEEP_BATCH * n_dec}
    print(f"   fused sweep of {DRIVER_SWEEP_BATCH} checkpoints x "
          f"{DRIVER_EVAL_EPISODES} episodes: launches {fused['counts']} "
          f"(stated: {want}), {fused['wall_s']:.3f} s", flush=True)
    if device == "cuda" and fused["counts"] != want:
        raise AssertionError(f"sweep launches {fused['counts']} != {want}")

    # the same episodes one checkpoint at a time, then fused again: the
    # first fused sweep also captured the physics step's graph at K·N envs
    env, agents, n, seeds = fused["args"]
    kw = fused["kw"]
    t0 = time.perf_counter()
    alone = [engine.run_batched_eval(env, a, n, seed, **kw)
             for a, seed in zip(agents, seeds)]
    _sync(device)
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.run_batched_eval_multi(env, agents, n, seeds, **kw)
    _sync(device)
    warm_s = time.perf_counter() - t0
    same = {key: all(np.array_equal(f["per_episode"][key],
                                    a["per_episode"][key])
                     for f, a in zip(fused["results"], alone))
            for key in ("success", "horizon", "reward", "reward_sum")}
    print(f"   sequential: {seq_s:.3f} s; fused {fused['wall_s']:.3f} s "
          f"first, {warm_s:.3f} s warm ({seq_s / warm_s:.2f}x); "
          f"per-episode results equal {same} [{smoke.card}]", flush=True)
    out.update(sweep_launches=fused["counts"], sweep_fused_s=fused["wall_s"],
               sweep_fused_warm_s=warm_s, sweep_sequential_s=seq_s,
               sweep_equal=same,
               success={s: float(r["success"]) for s, r in zip(steps, rows)})
    if not all(same.values()):
        parting = _first_parting(env, agents, n, seeds, kw)
        print(f"   fused and sequential part at {parting}", flush=True)
        out["parting"] = parting
    if not same["success"]:
        raise AssertionError("the fused sweep's per-episode success differs "
                             "from the sequential evals'")

    # the suboptimal corpus and the mixed arm
    if [d for d, _ in study[:2]] != ["collect_data", "process_latents"]:
        raise AssertionError(f"study stages {study}")
    stage("collect_data", study[0])
    stage("process_latents suboptimal", study[1])
    sub = ingest.load_npz(str(need(ds / "suboptimal.npz")),
                          ["robot0_eef_pos", "latent_agentview_image"],
                          latent_path=str(need(ds / "suboptimal_latent.npz")))
    print(f"   suboptimal corpus: {sub.n_demos} failures of "
          f"{DRIVER_COLLECT}", flush=True)
    if sub.n_demos < 1:
        raise AssertionError("collect_data kept no failure")
    arm = [line for line in study if "experiment_name=mixed8" in line[1]]
    stage("train_mixed_bc", arm[0])
    mixed = exp / "mixed_study_torch" / "mixed8"
    need(mixed / "ckpt" / f"{M}.ckpt")
    with open(need(mixed / "eval.csv"), newline="") as f:
        last = list(csv.DictReader(f))[-1]
    if "mixed_data" not in load_config(str(mixed / "config.json")):
        raise AssertionError("the mixed run's config.json has no mixed_data")
    out.update(suboptimal_demos=sub.n_demos,
               mixed_success=float(last["success"]))
    return out


def _training_phases(smoke: Smoke) -> None:
    """The recipe's training phases in one scratch run directory under the
    checkout's git-ignored ``build/``, removed after; each phase runs only
    if the ones it reads from passed."""
    import os
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
            smoke.phase("training: LDP-hier on the trained VAE's latents; "
                        "kernel B on nets that do not downsample",
                        lambda: phase_ldp_hier(smoke, run))
        if run.ldp_agent is not None:
            smoke.phase("training: mixed and action-free data",
                        lambda: phase_mixed(smoke, run))
        smoke.phase("training: DPVAE on the same latents; kernel B at its "
                    "widths", lambda: phase_dp_vae(smoke, run))
        smoke.phase("training: DP on raw frames at the recipe widths",
                    lambda: phase_dp(smoke, run))
    finally:
        shutil.rmtree(run.work, ignore_errors=True)
    smoke.phase("drivers: the Lift pipeline from the command line",
                lambda: phase_drivers(smoke))
    smoke.phase(PP_PHASE, lambda: phase_pick_place(smoke))
    smoke.phase(AL_PHASE, lambda: phase_aloha(smoke))


# ---------------------------------------------------------------------------
# Can and Square (contact physics)
# ---------------------------------------------------------------------------

def _float_leaves(state) -> list:
    """Every floating-point tensor of an env state (through its ``map``)."""
    leaves = []

    def keep(x):
        if x.is_floating_point():
            leaves.append(x)
        return x
    state.map(keep)
    return leaves


def _expert_run(env, n: int, steps: int, device: str, seed: int = 9) -> dict:
    """The env's scripted expert over ``n`` envs × ``steps`` control steps
    (the step from its CUDA graph on the card): the share of episodes that
    succeed, whether every float of every state stayed finite, and, for a
    one-object task (Can, Square), how high the object ever rose above its
    spawn."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    state = env.reset_state(n, g)
    one_object = hasattr(state, "obj_pos")
    z0 = state.obj_pos[:, 2].clone() if one_object else None
    rise = torch.zeros(n, device=device)
    success = torch.zeros(n, dtype=torch.bool, device=device)
    finite = torch.ones((), dtype=torch.bool, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, reward, ok = env.transition(state, env.scripted_action(state))
        success |= ok
        if one_object:
            rise = torch.maximum(rise, state.obj_pos[:, 2] - z0)
        for leaf in [reward] + _float_leaves(state):
            finite &= torch.isfinite(leaf).all()
    _sync(device)
    out = dict(success=float(success.float().mean()),
               wins=int(success.sum()), finite=bool(finite),
               wall_s=time.perf_counter() - t0)
    if one_object:
        out["lifted_share"] = float((rise > 0.02).float().mean())
    return out


# the JAX expert's episodes past the first 8 of pick_place_golden.npz
MORE_EXPERT_EPISODES = {"SquarePhysicsEnv": "square_expert_golden.npz"}


def _expert_against_jax(name: str, wins: int, n: int,
                        fixture: str = "pick_place_golden.npz") -> dict:
    """The expert's ``wins`` of ``n`` envs beside the JAX expert's over the
    episodes of ``tests/fixtures/<fixture>`` and, for Square, of
    ``MORE_EXPERT_EPISODES`` (its ``run_scripted_collection``
    from ``PRNGKey(1)``: 300 steps for Can and Square, 120 and 160 for the
    ALOHA tasks). After the squeeze an object's path hangs on float
    rounding, so episodes are not compared one by one: Fisher's exact test
    must not tell the two rates apart at the 3-sigma level (two-sided p ≥
    0.0027). Success is rare on Square, too rare for a normal
    approximation."""
    import numpy as np
    from scipy.stats import fisher_exact
    f = np.load(REPO / "tests" / "fixtures" / fixture)
    jax_wins = f[f"{name}_expert_success"].any(1)
    if name in MORE_EXPERT_EPISODES:
        more = np.load(REPO / "tests" / "fixtures"
                       / MORE_EXPERT_EPISODES[name])
        jax_wins = np.concatenate([jax_wins,
                                   more[f"{name}_expert_success"].any(1)])
    m = len(jax_wins)
    k = int(jax_wins.sum())
    p = float(fisher_exact([[wins, n - wins], [k, m - k]])[1])
    out = dict(jax=k / m, jax_episodes=m,
               jax_steps=f[f"{name}_expert_success"].shape[1], fisher_p=p)
    if p < 0.0027:
        raise AssertionError(f"{name} expert: {wins} of {n} envs against "
                             f"the JAX expert's {out}")
    return out


def _time_idm(smoke: Smoke, what: str, agent, n_rows: int, g) -> dict:
    """Kernel A alone on ``agent``'s IDM at ``n_rows`` latent pairs over the
    agent's table: within phase A's bar of the fp32 twin (1e-4 for DDIM,
    1e-3 for DDPM with the same per-step noise), timed beside it, with its
    bound (phase A's count)."""
    import torch
    from latent_diffusion_planning_tpu_torch.models.agents import common
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA)
    net = agent.idm
    S, A = 2 * agent.config.obs_dim, agent.config.action_dim
    steps = agent.config.idm_inference_steps
    ts, coefs = agent._table(agent.idm_sched, steps)
    clip = agent._clip(agent.idm_sched)
    s = torch.randn(n_rows, S, generator=g, device="cuda")
    x0 = torch.randn(n_rows, A, generator=g, device="cuda")
    noise = common.step_noise(steps, agent.idm_sched, None, (n_rows, A), g,
                              torch.device("cuda"))
    tol = 1e-4 if noise is None else 1e-3
    packed = agent._packed("idm")
    run_k = lambda: KA.fused_mlp_diffusion_sample(
        net, s, x0, ts, coefs, noise, clip_range=clip, packed=packed)
    run_p = lambda: KA.mlp_diffusion_sample_plain(net, s, x0, ts, coefs,
                                                  noise, clip)
    err = float((run_k() - run_p()).abs().max())
    smoke.check(f"{what} max_abs_err vs the fp32 twin", err, tol)
    ms, plain_ms = time_ms(run_k), time_ms(run_p)
    smoke.timing(what, ms, plain_ms)
    products, rest, nbytes = idm_flops_bytes(net, n_rows, S, A,
                                             int(ts.shape[0]),
                                             noise is not None)
    b_ms, b_by = bound(rest, nbytes, fp32_products=products)
    print(f"   {what}: bound {b_ms:.4f} ms ({b_by}) [{smoke.card}]",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


CONTACT_FIXTURE = REPO / "tests" / "fixtures" / "can_contact_golden.npz"
CONTACT_ROUNDING = 5.0     # tests/test_torch_can_parity.py's ROUNDING
CONTACT_FLOORS = {"pos": 1e-6, "quat": 1e-5, "linvel": 1e-5, "angvel": 1e-5}


def contact_check(smoke: Smoke, device: str = "cuda") -> dict:
    """One Can control step on the card from the 72 contact states of
    ``tests/fixtures/can_contact_golden.npz`` against JAX's next states,
    at ``test_can_contact_step_matches_jax``'s bar: in each group of 8
    states a body field within ``CONTACT_ROUNDING`` times the card's own
    fp32-to-fp64 distance plus its floor; the arm and the reward within
    1e-5, success and holding exactly. Stepped in fp32 from the CUDA graph
    and eagerly, and in fp64 eagerly (the yardstick). Then every third
    state's 64x64 frame through kernel C against the plain renderer's: more
    than 98% of each frame's pixels within 2.0 (the CPU test's bar against
    JAX's renderer). Prints the largest err / (ROUNDING own + floor) of
    each field."""
    import numpy as np
    import torch
    from latent_diffusion_planning_tpu_torch.envs import pick_place_physics as P
    from latent_diffusion_planning_tpu_torch.ops import render as R
    from latent_diffusion_planning_tpu_torch.ops.kernels import raycast as K

    with np.load(CONTACT_FIXTURE) as f:
        g = {k: f[k] for k in f}

    def state(dtype, rows=slice(None)):
        t = lambda k: torch.from_numpy(g[k][rows]).to(device, dtype)
        return P.PickPlacePhysState(
            bodies=P.ph.RigidBody(pos=t("pos"), quat=t("quat"),
                                  linvel=t("linvel"), angvel=t("angvel")),
            qpos=t("qpos"), eef_target=t("eef_target"), gripper=t("gripper"),
            t=torch.from_numpy(g["t"][rows]).to(device))

    def step(dtype, graph):
        old = torch.get_default_dtype()
        torch.set_default_dtype(dtype)
        try:
            env = P.CanPhysicsEnv(render_images=False, cuda_graph=graph)
            new, reward, success = env.transition(
                state(dtype), torch.from_numpy(g["action"]).to(device, dtype))
            return new, reward, success, env.holding(new)
        finally:
            torch.set_default_dtype(old)

    new64 = step(torch.float64, False)[0]
    groups = len(g["t"]) // 8
    out: dict = {}
    for route, graph in (("graphed", True), ("eager", False)):
        new, reward, success, held = step(torch.float32, graph)
        ratios = {}
        for k, floor in CONTACT_FLOORS.items():
            got = getattr(new.bodies, k).double().cpu().numpy()
            own = np.abs(got - getattr(new64.bodies, k).cpu().numpy())
            err = np.abs(got - g[f"next_{k}"])
            own, err = (x.reshape(groups, -1).max(1) for x in (own, err))
            ratios[k] = float((err / (CONTACT_ROUNDING * own + floor)).max())
        ratios["qpos"] = float(np.abs(new.qpos.double().cpu().numpy()
                                      - g["next_qpos"]).max() / 1e-5)
        ratios["reward"] = float(np.abs(reward.double().cpu().numpy()
                                        - g["reward"]).max() / 1e-5)
        exact = {"success": bool((success.cpu().numpy()
                                  == g["success"]).all()),
                 "holding": bool((held.cpu().numpy() == g["holding"]).all())}
        print(f"   Can contact step on the card, fp32 {route}: largest "
              f"err / bar {json.dumps({k: round(v, 4) for k, v in ratios.items()})}"
              f", {exact} [{smoke.card}]", flush=True)
        out[route] = {"ratios": ratios, **exact}
        if max(ratios.values()) > 1 or not all(exact.values()):
            raise AssertionError(f"Can contact step ({route}) departs from "
                                 f"JAX's: {ratios} {exact}")
    env = P.CanPhysicsEnv(image_size=64)
    st = state(torch.float32, slice(None, None, 3))
    scene = env.scene(st)
    n_convex = int((scene.kind[0] == 2).sum())
    got = K.render_batch_cuda(scene, env.camera, 64, 64, n_convex)
    want = R.render_batch(scene, env.camera, 64, 64)
    share = ((got - want).abs().amax(-1) < 2.0).double().mean((1, 2))
    out["frames"] = {"n": int(share.numel()), "least_share": float(share.min()),
                     "finite": bool(torch.isfinite(got).all())}
    print(f"   C on {share.numel()} contact states at 64x64: least share of "
          f"pixels within 2.0 {float(share.min()):.4f} (bar > 0.98)",
          flush=True)
    if not (out["frames"]["least_share"] > 0.98 and out["frames"]["finite"]):
        raise AssertionError(f"C on the contact states: {out['frames']}")
    return out


def phase_pick_place(smoke: Smoke, device: str = "cuda"):
    """Can and Square on the contact engine: the card's Can contact step
    and frames against JAX's (``contact_check``), kernel C on their scenes,
    the scripted experts from the CUDA graph, the Can recipe from the command
    line (``tools/run_can_pipeline_torch.sh``'s lines, counts cut, in a
    scratch folder under ``build/``) with ``eval_bc`` over
    ``PP_EVAL_EPISODES`` × 400 steps, kernels B and A alone at the recipe's
    DDIM-25 on the trained agent, and a Square closed loop on seeded
    weights; both closed loops with their launch counts stated before the
    run and checked after."""
    import os
    import shutil
    import tempfile
    from latent_diffusion_planning_tpu_torch.envs import pick_place_physics

    out: dict = {"can contact": contact_check(smoke, device)}
    for name in ("can", "square"):
        cls = getattr(pick_place_physics, f"{name.title()}PhysicsEnv")
        env = cls(render_images=False)
        states = physics_states(env, PP_RENDER_ENVS, device, seed=5,
                                spread=PP_RENDER_SPREAD)
        scene = env.scene(states)
        kinds = scene.kind[0].tolist()
        print(f"   C {name}: {len(kinds)} prims ({kinds.count(1)} spheres, "
              f"{kinds.count(2)} convex)", flush=True)
        if len(kinds) != 10 or kinds.count(2):
            raise AssertionError(f"C {name}: scene kinds {kinds}")
        if device == "cuda":
            out[f"C {name}"] = raycast_case(smoke, name, scene, env.camera, 0)

        # the expert over many envs: every state finite, and its success
        # rate not told apart from the JAX expert's
        res = _expert_run(cls(render_images=False), PP_EXPERT_ENVS,
                          PP_EXPERT_LEN, device)
        print(f"   {name} expert, {PP_EXPERT_ENVS} envs x {PP_EXPERT_LEN} "
              f"steps: success {res['success']:.4f}, object lifted 2 cm in "
              f"{res['lifted_share']:.4f}, all finite {res['finite']}, wall "
              f"{res['wall_s']:.2f} s incl. the graph's capture "
              f"[{smoke.card}]", flush=True)
        if not res["finite"]:
            raise AssertionError(f"{name} expert: {res}")
        res["jax"] = _expert_against_jax(cls.__name__, res["wins"],
                                         PP_EXPERT_ENVS)
        print(f"   {name} expert against the JAX expert: {res['jax']}",
              flush=True)
        out[f"{name} expert"] = res

    build = REPO / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_can_", dir=build))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out.update(_drive_can(smoke, work, device))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    out.update(_square_loop(smoke, device))
    return out


def _drive_can(smoke: Smoke, work: Path, device: str) -> dict:
    """The Can recipe's lines, counts cut, then ``eval_bc`` with its
    launches counted and the recipe's B and A timed on the trained agent."""
    import torch
    from latent_diffusion_planning_tpu_torch.data import ingest
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine

    knobs = {"DATA": "datasets",
             "ARGS": "" if device == "cuda" else f"device={device}"}
    lines = recipe_lines("run_can_pipeline_torch.sh", work, knobs)
    V, L = PP_VAE_STEPS, PP_LDP_STEPS
    vae_path = f"experiments/can_pipeline/vae/ckpt/{V}.ckpt"
    cuts = {
        "train_vae": [f"n_grad_steps={V}", f"eval_every={V}",
                      f"save_every={V}"],
        "process_latents": [f"vae_snapshot_path={vae_path}"],
        # eval_bc scores the run: the run's own eval is cut to 0 episodes
        "train_bc": [f"agent.vae_pretrain_path={vae_path}",
                     f"n_grad_steps={L}", f"save_every={L}",
                     f"eval_every={L}", "n_eval_episodes=0"],
    }
    stages = [d for d, _ in lines]
    print(f"   stages of run_can_pipeline_torch.sh: {stages}", flush=True)
    if stages != ["collect_demos", "collect_demos", "train_vae",
                  "process_latents", "train_bc"]:
        raise AssertionError(f"Can pipeline stages {stages}")
    out: dict = {"stage_s": {}}

    def stage(name, line):
        driver, argv = line
        module = importlib.import_module(
            f"latent_diffusion_planning_tpu_torch.drivers.{driver}")
        t0 = time.perf_counter()
        module.main(argv + cuts.get(driver, []))
        _sync(device)
        out["stage_s"][name] = time.perf_counter() - t0
        print(f"   {name}: {out['stage_s'][name]:.1f} s [{smoke.card}]",
              flush=True)

    for split, line in zip(("train", "eval"), lines[:2]):
        stage(f"collect_demos {split}", line)
    demos = ingest.load_npz("datasets/demos.npz",
                            ["robot0_eef_pos", "object", "agentview_image"])
    meta = demos.env_meta
    print(f"   Can demos: {demos.n_demos} of 256 kept, frames "
          f"{tuple(demos.arrays['agentview_image'].shape)}, object "
          f"{tuple(demos.arrays['object'].shape[1:])}, env {meta}",
          flush=True)
    if not (demos.n_demos >= 1 and meta["env_name"] == "CanPhysicsEnv"
            and demos.arrays["object"].shape[1] == 14
            and bool((demos.demo_lengths == 301).all())):
        raise AssertionError("the Can demos do not read back as written")
    stage("train_vae", lines[2])
    stage("process_latents", lines[3])
    stage("train_bc", lines[4])
    ldp = Path("experiments/can_pipeline/ldp")
    if not (ldp / "ckpt" / f"{L}.ckpt").exists():
        raise AssertionError("train_bc wrote no checkpoint")

    # eval_bc: one checkpoint, PP_EVAL_EPISODES envs × 400 steps = 100
    # decisions, each one render (C), one plan (B) and one IDM decode (A)
    want = {"raycast": 100, "diffusion_unet1d": 100, "diffusion_mlp": 100}
    print(f"   eval_bc launches stated before the run: {want}", flush=True)
    seen = {}
    real = engine.run_batched_eval_multi

    def counted(env, agents, n, seeds, **kw):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = real(env, agents, n, seeds, **kw)
        _sync(device)
        seen.update(launches=kernels.launch_counts(), env=env,
                    agent=agents[0], wall_s=time.perf_counter() - t0,
                    metrics=res[0]["metrics"])
        return res
    engine.run_batched_eval_multi = counted
    try:
        stage("eval_bc", ("eval_bc", [
            f"run_dir={ldp}", f"n_eval_episodes={PP_EVAL_EPISODES}",
            *knobs["ARGS"].split()]))
    finally:
        engine.run_batched_eval_multi = real
    if seen.get("env") is None or seen["env"].episode_len != 400:
        raise AssertionError("eval_bc did not evaluate in a 400-step env")
    m = seen["metrics"]
    print(f"   Can eval_bc: {PP_EVAL_EPISODES} envs x 400 steps, launches "
          f"{seen['launches']} (stated: {want}), success {m['success']:.4f}, "
          f"{PP_EVAL_EPISODES * 400 / seen['wall_s']:.1f} computed "
          f"env-steps/s, wall {seen['wall_s']:.3f} s [{smoke.card}]",
          flush=True)
    if device == "cuda" and seen["launches"] != want:
        raise AssertionError(f"Can eval_bc launches {seen['launches']} != "
                             f"{want}")
    out["can_eval"] = {k: v for k, v in seen.items()
                       if k not in ("env", "agent")}
    agent = seen["agent"]
    if device == "cuda":
        g = torch.Generator(device="cuda").manual_seed(11)
        table = agent._table(agent.planner_sched,
                             agent.config.planner_inference_steps)
        out["B can"] = _time_unet(
            smoke, f"B can planner {list(agent.planner.down_dims)} "
            f"{PP_EVAL_EPISODES} x T 8, DDIM-{len(table[0])}", agent.planner,
            PP_EVAL_EPISODES, table, agent._clip(agent.planner_sched), g)
        # a decision decodes the plan's pred_horizon latent pairs an env
        rows = PP_EVAL_EPISODES * agent.config.pred_horizon
        out["A can"] = _time_idm(
            smoke, f"A can IDM {rows} rows, DDIM-"
            f"{agent.config.idm_inference_steps}", agent, rows, g)
        out["can decision ms"] = _can_decision(smoke, seen["env"], agent,
                                               PP_EVAL_EPISODES)
    out["demos"] = demos.n_demos
    return out


def _can_decision(smoke: Smoke, env, agent, n: int) -> dict:
    """One decision of the Can eval at ``n`` envs, stage by stage (CUDA
    events over repeated calls, as ``phase_breakdown`` times the main
    path's)."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.agents import common

    g = torch.Generator(device="cuda").manual_seed(8)
    state = physics_states(env, n, "cuda", seed=8, spread=PP_RENDER_SPREAD)
    c = agent.config
    obs = env.obs(state)
    window = {k: obs[k][:, None] for k in configs.BENCH_POLICY_KEYS}
    emb = agent._obs_cond(agent._prepare_eval_batch({"obs": window})["obs"])
    cond = emb[:, 0]
    x_plan = torch.randn(n, c.pred_horizon, c.obs_dim, device="cuda")
    pairs = common.consecutive_pairs(torch.cat(
        [emb, agent._plan(cond, x_plan, g)], 1))
    x_idm = torch.randn(pairs.shape[0], c.action_dim, device="cuda")
    acts = torch.rand(n, 7, device="cuda") * 2 - 1
    scene = env.scene(state)
    stages = {
        "Can env: render + obs (fk, scene, kernel C)": lambda: env.obs(state),
        "Can env: render alone (kernel C through its wrapper)":
            lambda: env.render_scene(scene),
        "Can env: 4 transitions, CUDA graph":
            lambda: [env.transition(state, acts)
                     for _ in range(c.action_horizon)],
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
        print(f"   Can decision at {n} envs, {name}: {out[name]:.3f} ms "
              f"[{smoke.card}]", flush=True)
    return out


def _square_loop(smoke: Smoke, device: str) -> dict:
    """The LDP agent of the Can recipe's widths on seeded weights closing
    the loop on ``SquarePhysicsEnv``, its launches stated and checked."""
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.envs.pick_place_physics import (
        SquarePhysicsEnv)
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine

    cfg = dict(configs.bench_agent_config(), planner_inference_steps=25,
               idm_inference_steps=25)
    agent = LDPAgent.create(cfg, configs.SHAPE_META, seed=0, device=device)
    env = SquarePhysicsEnv(episode_len=400)
    n = PP_EVAL_EPISODES
    want = {"raycast": 100, "diffusion_unet1d": 100, "diffusion_mlp": 100}
    print(f"   Square closed loop launches stated before the run: {want}",
          flush=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.run_batched_eval(
        env, agent, n, 1, obs_horizon=cfg["obs_horizon"],
        action_horizon=cfg["action_horizon"], episode_len=400,
        policy_obs_keys=configs.BENCH_POLICY_KEYS, device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    m = res["metrics"]
    print(f"   Square closed loop (seeded weights): {n} envs x 400 steps, "
          f"launches {counts}, success {m['success']:.4f}, "
          f"{n * 400 / wall:.1f} computed env-steps/s, wall {wall:.3f} s "
          f"[{smoke.card}]", flush=True)
    if device == "cuda" and counts != want:
        raise AssertionError(f"Square closed loop: launches {counts} != "
                             f"{want}")
    if not (0 <= m["success"] <= 1 and math.isfinite(m["reward"])):
        raise AssertionError(f"Square closed loop: implausible metrics {m}")
    return {"square_loop": dict(launches=counts, metrics=m, wall_s=wall,
                                env_steps_per_s=n * 400 / wall)}


# ---------------------------------------------------------------------------
# ALOHA: bimanual transfer-cube and insertion
# ---------------------------------------------------------------------------

def phase_aloha(smoke: Smoke, device: str = "cuda"):
    """Bimanual ALOHA: kernel C with a camera per env (``wrist64``) on
    transfer-cube scenes in both mesh modes and on insertion scenes; both
    scripted experts from the CUDA graph; the phys4 recipe from the command
    line (``tools/run_aloha_phys4_torch.sh``'s lines, counts cut, in a
    scratch folder under ``build/``) with ``eval_bc`` at
    ``eval_action_horizon=1`` and ``plan_blend=0.7``; kernels B (x0
    prediction) and A (S = 540) alone on the trained agent; an insertion
    closed loop on seeded weights. Launch counts are stated before each
    closed loop and checked after."""
    import os
    import shutil
    import tempfile
    from latent_diffusion_planning_tpu_torch.envs import aloha_base as AB
    from latent_diffusion_planning_tpu_torch.envs.aloha_cube import (
        AlohaTransferCubeEnv)
    from latent_diffusion_planning_tpu_torch.envs.aloha_insertion import (
        AlohaInsertionEnv)

    out: dict = {}
    # prims: box mode the cube, 2 x 4 arm boxes, 4 pad spheres (insertion:
    # peg, socket, 8 arm boxes); kdop 18 hulls first
    cases = (("cube box", AlohaTransferCubeEnv, {"mesh_mode": "box"}, 13, 0),
             ("cube kdop", AlohaTransferCubeEnv, {"mesh_mode": "kdop"}, 23,
              18),
             ("insertion", AlohaInsertionEnv, {}, 10, 0))
    for name, cls, kw, n_prims, n_convex in cases:
        env = cls(render_images=False, **kw)
        states = physics_states(env, AL_RENDER_ENVS, device, seed=5,
                                spread=AL_RENDER_SPREAD)
        scene, cam = env.scene(states), AB.wrist64_camera(states.right)
        kinds = scene.kind[0].tolist()
        print(f"   C aloha {name}: {len(kinds)} prims ({kinds.count(1)} "
              f"spheres, {kinds.count(2)} convex), a camera per env",
              flush=True)
        if len(kinds) != n_prims or kinds.count(2) != n_convex:
            raise AssertionError(f"C aloha {name}: scene kinds {kinds}")
        if device == "cuda":
            out[f"C aloha {name}"] = raycast_case(
                smoke, f"aloha {name}", scene, cam, env.n_convex)

    for name, key, cls in (("cube", "cube", AlohaTransferCubeEnv),
                           ("insertion", "ins", AlohaInsertionEnv)):
        steps = AL_EXPERT_LEN[name]
        res = _expert_run(cls(render_images=False, episode_len=steps),
                          AL_EXPERT_ENVS, steps, device)
        print(f"   ALOHA {name} expert, {AL_EXPERT_ENVS} envs x {steps} "
              f"steps: success {res['success']:.4f}, all finite "
              f"{res['finite']}, wall {res['wall_s']:.2f} s incl. the "
              f"graph's capture [{smoke.card}]", flush=True)
        if not res["finite"]:
            raise AssertionError(f"ALOHA {name} expert: {res}")
        res["jax"] = _expert_against_jax(key, res["wins"], AL_EXPERT_ENVS,
                                         "aloha_golden.npz")
        print(f"   ALOHA {name} expert against the JAX expert: "
              f"{res['jax']}", flush=True)
        out[f"aloha {name} expert"] = res

    build = REPO / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_aloha_", dir=build))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out.update(_drive_aloha(smoke, work, device))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return out


def _drive_aloha(smoke: Smoke, work: Path, device: str) -> dict:
    """The phys4 recipe's lines, counts cut (demos at full count), then
    ``eval_bc`` as the recipe runs it with its launches counted, B and A
    alone on the trained agent, and an insertion closed loop."""
    import torch
    from latent_diffusion_planning_tpu_torch.data import ingest
    from latent_diffusion_planning_tpu_torch.drivers import run_data
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA)
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.loop import build_agent
    from latent_diffusion_planning_tpu_torch.utils.config import load_config

    knobs = {"DATA": "datasets",
             "ARGS": "" if device == "cuda" else f"device={device}"}
    lines = recipe_lines("run_aloha_phys4_torch.sh", work, knobs)
    V, L = AL_VAE_STEPS, AL_LDP_STEPS
    vae_path = f"experiments/aloha_phys4/vae/ckpt/{V}.ckpt"
    cuts = {
        "train_vae": [f"n_grad_steps={V}", f"eval_every={V}",
                      f"save_every={V}"],
        "process_latents": [f"vae_snapshot_path={vae_path}"],
        # eval_bc scores the run: the run's own eval is cut to 0 episodes;
        # the recipe's 500 warm-up steps to 100 of the 300
        "train_bc": [f"agent.vae_pretrain_path={vae_path}",
                     f"n_grad_steps={L}", f"save_every={L}",
                     f"eval_every={L}", "n_eval_episodes=0",
                     f"warmup_steps={L // 3}"],
    }
    stages = [d for d, _ in lines]
    print(f"   stages of run_aloha_phys4_torch.sh: {stages}", flush=True)
    if stages != ["collect_demos"] * 4 + ["train_vae", "process_latents",
                                          "train_bc"]:
        raise AssertionError(f"ALOHA recipe stages {stages}")
    out: dict = {"stage_s": {}}

    def stage(name, line):
        driver, argv = line
        module = importlib.import_module(
            f"latent_diffusion_planning_tpu_torch.drivers.{driver}")
        t0 = time.perf_counter()
        module.main(argv + cuts.get(driver, []))
        _sync(device)
        out["stage_s"][name] = time.perf_counter() - t0
        print(f"   {name}: {out['stage_s'][name]:.1f} s [{smoke.card}]",
              flush=True)

    for split, line in zip(("clean", "noise 0.003", "noise 0.005", "eval"),
                           lines[:4]):
        stage(f"collect_demos {split}", line)
    kept = {}
    for split in ("demos", "demos_n3", "demos_n5", "demos_eval"):
        demos = ingest.load_npz(f"datasets/{split}.npz",
                                ["qpos", "wrist64_image"])
        kept[split] = demos.n_demos
        if not (demos.n_demos >= 1
                and demos.env_meta["env_name"] == "AlohaTransferCubeEnv"
                and demos.arrays["qpos"].shape[1] == 14
                and tuple(demos.arrays["wrist64_image"].shape[1:])
                == (64, 64, 3)):
            raise AssertionError(f"the ALOHA demos {split} do not read back")
    print(f"   ALOHA demos kept (of 128, 288, 320, 32): {kept}", flush=True)
    out["demos"] = kept
    stage("train_vae", lines[4])
    stage("process_latents", lines[5])
    stage("train_bc", lines[6])
    ldp = Path("experiments/aloha_phys4/ldp")
    if not (ldp / "ckpt" / f"{L}.ckpt").exists():
        raise AssertionError("train_bc wrote no checkpoint")

    # eval_bc as the recipe runs it: one checkpoint, AL_EVAL_EPISODES envs
    # x 400 steps at eval_action_horizon=1 = 400 decisions, each one
    # render (C), one plan (B) and one IDM decode of the plan's 8 pairs (A)
    want = {"raycast": 400, "diffusion_unet1d": 400, "diffusion_mlp": 400}
    print(f"   eval_bc launches stated before the run: {want}", flush=True)
    seen = {}
    real = engine.run_batched_eval_multi

    def counted(env, agents, n, seeds, **kw):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = real(env, agents, n, seeds, **kw)
        _sync(device)
        seen.update(launches=kernels.launch_counts(), env=env,
                    agent=agents[0], wall_s=time.perf_counter() - t0,
                    metrics=res[0]["metrics"], kw=kw)
        return res
    engine.run_batched_eval_multi = counted
    try:
        stage("eval_bc", ("eval_bc", [
            f"run_dir={ldp}", f"n_eval_episodes={AL_EVAL_EPISODES}",
            "eval_action_horizon=1", "plan_blend=0.7",
            *knobs["ARGS"].split()]))
    finally:
        engine.run_batched_eval_multi = real
    env = seen.get("env")
    if not (type(env).__name__ == "AlohaTransferCubeEnv"
            and env.episode_len == 400
            and seen["kw"]["action_horizon"] == 1
            and seen["kw"]["plan_blend"] == 0.7):
        raise AssertionError(f"eval_bc did not run the recipe's eval: {seen}")
    m = seen["metrics"]
    print(f"   ALOHA eval_bc: {AL_EVAL_EPISODES} envs x 400 steps, launches "
          f"{seen['launches']} (stated: {want}), success {m['success']:.4f}, "
          f"max reward {m['reward']:.3f}, "
          f"{AL_EVAL_EPISODES * 400 / seen['wall_s']:.1f} computed "
          f"env-steps/s, wall {seen['wall_s']:.3f} s [{smoke.card}]",
          flush=True)
    if device == "cuda" and seen["launches"] != want:
        raise AssertionError(f"ALOHA eval_bc launches {seen['launches']} != "
                             f"{want}")
    out["aloha_eval"] = {k: v for k, v in seen.items()
                         if k not in ("env", "agent", "kw")}
    agent = seen["agent"]
    print(f"   the trained agent: planner {list(agent.planner.down_dims)} "
          f"predicting {agent.planner_sched.prediction_type!r} over "
          f"{agent.config.obs_dim} channels, IDM S = "
          f"{2 * agent.config.obs_dim}, A = {agent.config.action_dim}",
          flush=True)
    if device == "cuda":
        g = torch.Generator(device="cuda").manual_seed(11)
        table = agent._table(agent.planner_sched,
                             agent.config.planner_inference_steps)
        out["B aloha"] = _time_unet(
            smoke, f"B aloha planner {list(agent.planner.down_dims)} x "
            f"{agent.config.obs_dim} ch, x0 prediction, {AL_EVAL_EPISODES} "
            f"x T 8, DDIM-{len(table[0])}", agent.planner, AL_EVAL_EPISODES,
            table, agent._clip(agent.planner_sched), g)
        rows = AL_EVAL_EPISODES * agent.config.pred_horizon
        what = (f"A aloha IDM S={2 * agent.config.obs_dim} {rows} rows, "
                f"DDIM-{agent.config.idm_inference_steps}")
        out["A aloha"] = _time_idm(smoke, what, agent, rows, g)
        S = 2 * agent.config.obs_dim
        products, _, _ = idm_flops_bytes(
            agent.idm, rows, S, agent.config.action_dim,
            agent.config.idm_inference_steps, False)
        info = KA.kernel_info(agent.idm, rows, agent.config.action_dim, S,
                              agent.config.idm_inference_steps)
        entry = mlp_entry(agent.idm, info["rows_per_block"])
        out["A aloha"]["shape"] = smoke.shape_line(
            what, entry, info, 3 * products, PEAK_TF32_FLOPS,
            "TF32 tensor-core", out["A aloha"]["ms"])
    # the recipe's agent on seeded weights, for the insertion closed loop
    data, agent_cfg = run_data(load_config(str(ldp / "config.json")),
                               torch.device(device))
    seeded = build_agent(agent_cfg, data.shape_meta, 0, device)
    out.update(_insertion_loop(smoke, seeded, device))
    return out


def _insertion_loop(smoke: Smoke, agent, device: str) -> dict:
    """``agent`` (the recipe's widths, seeded weights) closing the loop on
    ``AlohaInsertionEnv`` (``AL_LOOP_ENVS`` × 400 steps at the recipe's
    action horizon 4: 100 decisions), its launches stated and checked."""
    from latent_diffusion_planning_tpu_torch.envs.aloha_insertion import (
        AlohaInsertionEnv)
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine

    c = agent.config
    env = AlohaInsertionEnv(episode_len=400)
    n = AL_LOOP_ENVS
    want = {"raycast": 100, "diffusion_unet1d": 100, "diffusion_mlp": 100}
    print(f"   insertion closed loop launches stated before the run: {want}",
          flush=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.run_batched_eval(
        env, agent, n, 1, obs_horizon=c.obs_horizon,
        action_horizon=c.action_horizon, episode_len=400,
        policy_obs_keys=("qpos", "wrist64_image"), device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    m = res["metrics"]
    print(f"   insertion closed loop (seeded weights): {n} envs x 400 "
          f"steps, launches {counts}, success {m['success']:.4f}, "
          f"{n * 400 / wall:.1f} computed env-steps/s, wall {wall:.3f} s "
          f"[{smoke.card}]", flush=True)
    if device == "cuda" and counts != want:
        raise AssertionError(f"insertion closed loop: launches {counts} != "
                             f"{want}")
    if not (0 <= m["success"] <= 1 and math.isfinite(m["reward"])):
        raise AssertionError(f"insertion closed loop: implausible {m}")
    return {"insertion_loop": dict(launches=counts, metrics=m, wall_s=wall,
                                   env_steps_per_s=n * 400 / wall)}


# ---------------------------------------------------------------------------
# eval videos, training and eval across ranks, the reference-naming round
# trip, host prefetch
# ---------------------------------------------------------------------------

class _Filmed:
    """An env whose ``render`` keeps every state it is handed (the engine's
    video frames), delegating everything else."""

    def __init__(self, env):
        self.env = env
        self.states = []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def render(self, state):
        self.states.append(state)
        return self.env.render(state)


def phase_video(smoke: Smoke):
    """The main path's eval with videos: the bench agent (seeded weights)
    on 1024 ``LiftPhysicsEnv`` envs × 400 steps with ``video_envs=2``,
    launch counts read around it (C once a decision for the policy and once
    a step for the two filmed envs: 100 + 400; B and A 100 each). Every
    frame equals its env's state rendered alone through C; the two videos
    written by ``save_video`` decode back bit for bit; the wall time stands
    beside the same eval without videos, and C is timed on the two filmed
    scenes against its twin."""
    import shutil
    import numpy as np
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.utils import media

    cfg = configs.bench_agent_config()
    agent = LDPAgent.create(cfg, configs.SHAPE_META, seed=0, device="cuda")
    env = configs.make_bench_env(EPISODE_LEN)
    K = 2
    run = lambda e, n, steps, video: engine.run_batched_eval(
        e, agent, n, 1, obs_horizon=cfg["obs_horizon"],
        action_horizon=cfg["action_horizon"], episode_len=steps,
        policy_obs_keys=configs.BENCH_POLICY_KEYS, video_envs=video,
        device="cuda")
    run(env, N_ENVS, 8, K)          # warm-up: the graph, cuDNN plans
    walls = {}
    for video in (0, K):
        filmed = _Filmed(env)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = run(filmed, N_ENVS, EPISODE_LEN, video)
        torch.cuda.synchronize()
        walls[video] = time.perf_counter() - t0
        counts = kernels.launch_counts()
    n_dec = math.ceil(EPISODE_LEN / cfg["action_horizon"])
    want = {"diffusion_mlp": n_dec, "diffusion_unet1d": n_dec,
            "raycast": n_dec + n_dec * cfg["action_horizon"]}
    plain_s, video_s = walls[0], walls[K]
    print(f"   launches {counts} (expected {want}); wall {video_s:.3f} s "
          f"with {K} videos against {plain_s:.3f} s without "
          f"(+{(video_s / plain_s - 1):.2%}) [{smoke.card}]", flush=True)
    if counts != want:
        raise AssertionError(f"video eval launches {counts} != {want}")
    videos = res["videos"]
    T = n_dec * cfg["action_horizon"]
    if videos.shape != (K, T, 64, 64, 3) or videos.dtype != np.uint8:
        raise AssertionError(f"videos {videos.shape} {videos.dtype}")
    # every frame: the filmed state's envs rendered one at a time
    if len(filmed.states) != T:
        raise AssertionError(f"{len(filmed.states)} filmed states, {T} steps")
    for t, state in enumerate(filmed.states):
        for k in range(K):
            alone = env.render(state.map(lambda x: x[k:k + 1]))
            alone = alone.to(torch.uint8)[0].cpu().numpy()
            if not np.array_equal(alone, videos[k, t]):
                raise AssertionError(f"video {k} frame {t} differs from its "
                                     "state rendered alone")
    moving = int((videos[:, 0] != videos[:, -1]).any(-1).sum())
    print(f"   {K} x {T} frames equal their states rendered alone through "
          f"C; {moving} pixels differ between the first and last frames",
          flush=True)
    out_dir = REPO / "build" / "smoke_video"
    shutil.rmtree(out_dir, ignore_errors=True)
    sizes = []
    for k in range(K):
        path = media.save_video(out_dir / f"0_{k}.mp4", videos[k])
        if not np.array_equal(media.read_video(path), videos[k]):
            raise AssertionError(f"{path} does not decode to its frames")
        sizes.append(path.stat().st_size)
    print(f"   save_video: {[p.name for p in sorted(out_dir.iterdir())]} "
          f"decode back bit for bit, {sizes} bytes", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    scene = env.scene(filmed.states[-1])
    c_video = raycast_case(smoke, "video", scene, env.camera, 0)
    return {"video_eval": dict(launches=counts, wall_s=video_s,
                               wall_s_without=plain_s,
                               overhead=video_s / plain_s - 1,
                               metrics=res["metrics"], file_bytes=sizes),
            "C video": c_video,
            **{f"{k} main": dict(smoke.kernels[name]) for k, name in
               (("B", "diffusion_unet1d"), ("A", "diffusion_mlp"))
               if name in smoke.kernels}}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _bench_batch(B: int, seed: int):
    """A latent-form training batch at the bench agent's shapes."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    H = 9
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    return {"obs": {
        "robot0_eef_pos": t(rng.normal(size=(B, H, 3)) * 0.1 + [0, 0, 1.0]),
        "robot0_eef_quat": t(rng.uniform(-1, 1, (B, H, 4))),
        "robot0_gripper_qpos": t(rng.uniform(size=(B, H, 2)) * [0.05, -0.05]),
        "latent_agentview_image": t(rng.normal(0, 3, (B, H, 16)))},
        "actions": t(rng.uniform(-1, 1, (B, H, 7)))}


DIST_EPISODES, DIST_LEN = 256, 80


def phase_dist(smoke: Smoke):
    """(a) A process group of one rank over NCCL in this process: one LDP
    update at the bench widths through ``replicate``, ``sharded_draws`` and
    the train states' all-reduce equals the plain update bit for bit (cuDNN
    deterministic), and ``run_batched_eval`` over the env mesh (the gather
    included) equals it without one. (b) Two ranks on the one card over
    gloo, started by ``torchrun --nproc_per_node 2`` running this file's
    ``--dist-worker``: each rank's half of a 256 × 80 eval launches C, B
    and A 20 times each, and the gathered per-episode results equal each
    half run alone; a rank that fails fails the phase."""
    import json as _json
    import os
    import shutil
    import torch
    import torch.distributed as dist
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.parallel import mesh as meshlib
    from latent_diffusion_planning_tpu_torch.rollout import engine

    out = {}
    cfg = configs.bench_agent_config()
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = meshlib.make_mesh()
        dp = meshlib.replicate(LDPAgent.create(
            cfg, configs.SHAPE_META, seed=0, device="cuda"), mesh)
        plain = LDPAgent.create(cfg, configs.SHAPE_META, seed=0,
                                device="cuda")
        batch = _bench_batch(128, 3)
        gens = [torch.Generator(device="cuda").manual_seed(5)
                for _ in range(2)]
        with meshlib.sharded_draws(mesh):
            m_dp = dp.update(meshlib.shard_batch(batch, mesh), 0, gens[0])
        m_plain = plain.update(batch, 0, gens[1])
        torch.cuda.synchronize()
        diff = _max_diff(dp.state_dict(), plain.state_dict())
        print(f"   (a) world 1 over NCCL, mesh {mesh.shape}: one dp update "
              f"vs the plain update, max |diff| over the whole state "
              f"{diff:.3e} (bar 0: bit for bit); losses "
              f"{float(m_dp['loss']):.6f} / {float(m_plain['loss']):.6f}",
              flush=True)
        if diff != 0.0:
            raise AssertionError(f"dp update differs from the plain one: "
                                 f"{diff}")
        env = configs.make_bench_env(DIST_LEN)
        run = lambda **kw: engine.run_batched_eval(
            env, plain, DIST_EPISODES, 1, obs_horizon=cfg["obs_horizon"],
            action_horizon=cfg["action_horizon"],
            policy_obs_keys=configs.BENCH_POLICY_KEYS, device="cuda",
            **kw)["per_episode"]
        sharded, alone = run(env_mesh=meshlib.make_env_mesh()), run()
        same = all((sharded[k] == alone[k]).all() for k in alone)
        print(f"   (a) env-sharded eval at world 1 ({DIST_EPISODES} x "
              f"{DIST_LEN}) equals run_batched_eval: {same}", flush=True)
        if not same:
            raise AssertionError("the env-sharded eval differs at world 1")
        out["world1"] = dict(max_diff=diff, eval_equal=same)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            prev)

    work = REPO / "build" / "smoke_dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_addr", "localhost",
           "--master_port", str(_free_port()), str(REPO / "chip_smoke.py"),
           "--dist-worker", str(work)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    wall = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).splitlines()[-30:]:
        print(f"   | {line}", flush=True)
    if proc.returncode:
        raise AssertionError(f"torchrun exited {proc.returncode}")
    ranks = [_json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    shutil.rmtree(work, ignore_errors=True)
    n_dec = math.ceil(DIST_LEN / cfg["action_horizon"])
    want = {"diffusion_mlp": n_dec, "diffusion_unet1d": n_dec,
            "raycast": n_dec}
    for r in ranks:
        print(f"   (b) rank {r['rank']} of 2 (gloo, one card): launches "
              f"{r['launches']} (expected {want}); its half alone equals "
              f"its slice of the gathered results: {r['half_equal']}; "
              f"eval {r['wall_s']:.3f} s [{smoke.card}]", flush=True)
        if r["launches"] != want or not r["half_equal"]:
            raise AssertionError(f"rank {r['rank']}: {r}")
    if ranks[0]["gathered"] != ranks[1]["gathered"]:
        raise AssertionError("the ranks gathered different results")
    print(f"   (b) both ranks gathered the same {DIST_EPISODES} episodes "
          f"(success {ranks[0]['success']:.4f}); torchrun wall {wall:.1f} s",
          flush=True)
    out["two_ranks"] = dict(ranks=[{k: v for k, v in r.items()
                                    if k != "gathered"} for r in ranks],
                            torchrun_wall_s=wall)
    return out


def dist_worker(work: Path) -> int:
    """One rank of ``phase_dist`` (b), under ``torchrun``: its half of the
    env-sharded eval, its launches, and its half run alone."""
    import json as _json
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.parallel import mesh as meshlib
    from latent_diffusion_planning_tpu_torch.rollout import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    meshlib.maybe_init_distributed(backend="gloo")
    mesh = meshlib.make_env_mesh()
    cfg = configs.bench_agent_config()
    agent = meshlib.replicate(LDPAgent.create(
        cfg, configs.SHAPE_META, seed=0, device="cuda"), mesh)
    env = configs.make_bench_env(DIST_LEN)
    run = lambda n, **kw: engine.run_batched_eval(
        env, agent, n, 1, obs_horizon=cfg["obs_horizon"],
        action_horizon=cfg["action_horizon"],
        policy_obs_keys=configs.BENCH_POLICY_KEYS, device="cuda", **kw)
    run(DIST_EPISODES, env_mesh=mesh, episode_len=8)        # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(DIST_EPISODES, env_mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n = DIST_EPISODES // mesh.world
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    half = run(n, episode_seeds=torch.arange(DIST_EPISODES)[rows])
    equal = all((res["per_episode"][k][rows] == v).all()
                for k, v in half["per_episode"].items())
    (work / f"rank{mesh.rank}.json").write_text(_json.dumps(dict(
        rank=mesh.rank, launches=counts, half_equal=bool(equal), wall_s=wall,
        success=res["metrics"]["success"],
        gathered={k: v.tolist() for k, v in res["per_episode"].items()})))
    torch.distributed.destroy_process_group()
    return 0


def phase_roundtrip(smoke: Smoke):
    """The bench agent's seeded weights written as a snapshot, exported to
    the reference's naming and imported back by the tools
    (``tools/{export,import}_reference_ckpt_torch.py``), every planner and
    IDM tensor bit for bit; then ``tools/roundtrip_eval_torch.py``'s check:
    both agents over 1024 × 400 on identical seeds (cuDNN deterministic),
    equal actions at every decision and a success delta of exactly 0,
    launches of each eval counted."""
    import importlib
    import shutil
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train.checkpoint import (
        Checkpointer)

    sys.path.insert(0, str(REPO / "tools"))
    exp_tool = importlib.import_module("export_reference_ckpt_torch")
    imp_tool = importlib.import_module("import_reference_ckpt_torch")
    rt = importlib.import_module("roundtrip_eval_torch")
    work = REPO / "build" / "smoke_roundtrip"
    shutil.rmtree(work, ignore_errors=True)
    agent = LDPAgent.create(configs.bench_agent_config(), configs.SHAPE_META,
                            seed=0, device="cuda")
    src = Checkpointer(work).save_params(0, agent.get_params())
    t0 = time.perf_counter()
    exp_tool.main([f"src={src}", f"dst={work / 'ref_format.npz'}"])
    imp_tool.main([f"src={work / 'ref_format.npz'}",
                   f"dst={work / 'reimported.ckpt'}"])
    tools_s = time.perf_counter() - t0
    reimported = Checkpointer(work).restore_raw(work / "reimported.ckpt")
    rt.compare(agent, reimported)
    npz_bytes = (work / "ref_format.npz").stat().st_size
    shutil.rmtree(work, ignore_errors=True)
    counts = []
    real = engine.run_batched_eval

    def counted(*args, **kw):
        kernels.reset_launch_counts()
        res = real(*args, **kw)
        counts.append(kernels.launch_counts())
        return res

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    engine.run_batched_eval = counted
    try:
        t0 = time.perf_counter()
        res = rt.roundtrip_eval(agent, reimported,
                                configs.make_bench_env(EPISODE_LEN), N_ENVS,
                                7, configs.BENCH_POLICY_KEYS, "cuda")
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        engine.run_batched_eval = real
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            prev)
    n_dec = math.ceil(EPISODE_LEN / 4)
    want = {"diffusion_mlp": n_dec, "diffusion_unet1d": n_dec,
            "raycast": n_dec}
    print(f"   export + import: {npz_bytes} bytes of reference-named "
          f".npz, {tools_s:.1f} s; planner and IDM bit for bit", flush=True)
    print(f"   {N_ENVS} x {EPISODE_LEN} twice on identical seeds: success "
          f"{res['original']:.4f} / {res['roundtrip']:.4f}, delta "
          f"{res['delta_pp']} pp (bar: exactly 0), actions equal at all "
          f"{res['decisions']} decisions; launches {counts} (expected "
          f"{want} each); {eval_s:.1f} s [{smoke.card}]", flush=True)
    if res["delta_pp"] != 0 or any(c != want for c in counts):
        raise AssertionError(f"round trip: {res}, launches {counts}")
    return {"roundtrip_eval": dict(res, launches=counts[0], eval_s=eval_s,
                                   npz_bytes=npz_bytes)}


PREFETCH_DEMOS, PREFETCH_LEN, PREFETCH_BATCH = 256, 81, 128


def phase_prefetch(smoke: Smoke):
    """``HostPrefetcher`` built on this machine's host compiler over host
    arrays at the Lift demos' shapes with raw 64×64 frames (256 demos × 81
    frames, 255 MB), batches of 128 windows of 9 streamed to the card from
    pinned slots: every batch of a check run equals ``DeviceDataset.gather``
    on the card at its indices; µs a batch beside ``DeviceDataset.sample``
    of the same arrays held on the card."""
    import numpy as np
    import torch
    from latent_diffusion_planning_tpu_torch.data import host_prefetch
    from latent_diffusion_planning_tpu_torch.data.ingest import WeldedDemos
    from latent_diffusion_planning_tpu_torch.data.windows import DeviceDataset

    t0 = time.perf_counter()
    if not host_prefetch.available():
        raise AssertionError("the host prefetcher does not build")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    total = PREFETCH_DEMOS * PREFETCH_LEN
    arrays = {
        "robot0_eef_pos": rng.normal(size=(total, 3)).astype(np.float32),
        "robot0_eef_quat": rng.normal(size=(total, 4)).astype(np.float32),
        "robot0_gripper_qpos": rng.normal(size=(total, 2)).astype(np.float32),
        "agentview_image": rng.integers(0, 256, (total, 64, 64, 3),
                                        dtype=np.uint8),
        "actions": rng.uniform(-1, 1, (total, 7)).astype(np.float32)}
    obs = ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos",
           "agentview_image")
    welded = WeldedDemos(
        arrays={k: torch.from_numpy(v) for k, v in arrays.items()},
        demo_starts=torch.arange(PREFETCH_DEMOS) * PREFETCH_LEN,
        demo_lengths=torch.full((PREFETCH_DEMOS,), PREFETCH_LEN),
        obs_keys=obs, dataset_keys=("actions",))
    dd = DeviceDataset.from_welded(welded, 1, 9, "cuda")
    batch_bytes = sum(PREFETCH_BATCH * 9 * a[0].nbytes
                      for a in arrays.values())
    out = {"build_s": build_s, "batch_bytes": batch_bytes}
    for threads in (2, 4):
        pf = host_prefetch.HostPrefetcher(
            welded, 1, 9, PREFETCH_BATCH, n_slots=4, n_threads=threads,
            seed=1, device="cuda")
        try:
            for _ in range(5):      # check, and warm up
                got, idx = pf.next_batch(return_indices=True)
                ref = dd.gather(idx.cuda())
                same = all(torch.equal(got["obs"][k], ref["obs"][k])
                           for k in obs)
                if not (same and torch.equal(got["actions"], ref["actions"])):
                    raise AssertionError("a streamed batch differs from "
                                         "the gather at its indices")
            torch.cuda.synchronize()
            n = 200
            t0 = time.perf_counter()
            for _ in range(n):
                got = pf.next_batch()
            torch.cuda.synchronize()
            us = (time.perf_counter() - t0) / n * 1e6
        finally:
            pf.close()
        out[f"us_per_batch_{threads}_threads"] = us
        print(f"   HostPrefetcher, {threads} threads, 4 pinned slots: "
              f"{us:.1f} us a batch of {PREFETCH_BATCH} windows x 9 "
              f"({batch_bytes / 1e6:.2f} MB, {batch_bytes / us / 1e3:.2f} "
              f"GB/s to the card) [{smoke.card}]", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    dev_us = time_ms(lambda: dd.sample(PREFETCH_BATCH, g), iters=50) * 1e3
    out["device_sample_us"] = dev_us
    print(f"   DeviceDataset.sample of the same arrays on the card: "
          f"{dev_us:.1f} us a batch; the engine built in {build_s:.1f} s "
          f"[{smoke.card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# the JAX package's default agent configurations (DDPM-100)
# ---------------------------------------------------------------------------
DEF_AGENTS = ("ldp_agent", "ldp_hier_agent", "dp_agent", "dp_repr_agent")
DEF_DATA = {"ldp_agent": "lift/latent_img", "ldp_hier_agent": "lift/latent_img",
            "dp_agent": "lift/img", "dp_repr_agent": "lift/latent_img"}
DEF_DEMO_SPLITS = (("train", 128, 0), ("eval", 32, 77))
DEF_VAE_STEPS = 25           # of train_vae's 300000, at its batch 128
DEF_TRAIN_STEPS = 60         # of train_bc's 500000, at its batch 256
DEF_EVAL_ENVS = 256          # the closed loop: 256 envs x 40 steps, five
DEF_EVAL_LEN = 40            # decisions at train_bc's action horizon 8 (cut
                             # from 80, with the two counts above, to keep
                             # the whole smoke near 600 s on one H100)
DEF_KERNEL_PHASE = ("defaults: kernel B at the default agents' shapes, "
                    "DDPM-100, and its wide mode")
DEF_PHASE = ("defaults: the four default agent configurations from the "
             "command line, trained and closed-loop")


def default_command_line(name: str) -> list[str]:
    """``train_bc agent=<name> data=...`` with the JAX command line's
    defaults. LDP and LDP-hier plan the window after ``obs_horizon``: at
    the yaml's horizon 16 their 15 targets fail the U-Net's stride (in the
    JAX package too), so they take ``horizon=17 pred_horizon=16``."""
    horizon = (["horizon=17", "pred_horizon=16"]
               if name.startswith("ldp") else [])
    return [f"agent={name}", f"data={DEF_DATA[name]}", *horizon]


def default_agents(device) -> dict:
    """The four default agents built on ``device`` from ``conf/`` through
    ``load_config`` (seeded weights; building one on the card runs its
    kernel check)."""
    from latent_diffusion_planning_tpu_torch.train.loop import build_agent
    from latent_diffusion_planning_tpu_torch.utils.config import load_config
    out = {}
    for name in DEF_AGENTS:
        cfg = load_config("train_bc", default_command_line(name))
        agent_cfg = {k: v for k, v in dict(cfg.agent).items()
                     if k != "vae_pretrain_path"}
        out[name] = build_agent(agent_cfg, cfg.data["meta"]["shape_meta"], 3,
                                device)
    return out


def default_unets(agents: dict) -> dict:
    """Kernel B's calls in the default agents: record name -> (agent name,
    net, its schedule, plan length, samples). LDP-hier plans P = 4 latents
    a decision and the window's 16 in ``sample_plan_stats`` (the wide
    mode); its chunk IDM decodes 4 chunks of 4 actions an env."""
    ldp, hier = agents["ldp_agent"], agents["ldp_hier_agent"]
    dp, dpr = agents["dp_agent"], agents["dp_repr_agent"]
    E = DEF_EVAL_ENVS
    return {
        "B ldp planner": ("ldp_agent", ldp.planner, ldp.planner_sched, 16, E),
        "B ldp_hier planner": ("ldp_hier_agent", hier.planner,
                               hier.planner_sched, hier.plan_length, E),
        "B ldp_hier window (wide)": ("ldp_hier_agent", hier.planner,
                                     hier.planner_sched, 16, E),
        "B ldp_hier chunk IDM": ("ldp_hier_agent", hier.idm, hier.idm_sched,
                                 hier.config.idm_horizon,
                                 E * hier.plan_length),
        "B dp": ("dp_agent", dp.planner, dp.sched, 16, E),
        "B dp_repr": ("dp_repr_agent", dpr.planner, dpr.sched, 16, E),
    }


def _ddpm_against_twin(smoke, what, net, cond, x_init, noise, table,
                       packed, dtype=None, grids=(None,)) -> dict:
    """Kernel B's DDPM on ``net`` against its rounding twin with the same
    per-step noise, by phase B's statistics, which bf16 rounding flips
    cannot move: after the first step, the share of elements beyond 5e-3
    of the fp64-sum twin at most the fp32 twin's or 1%; after all the
    steps, the mean within 5e-3 of the fp32 twin and closer to it than the
    unrounded fp32 net lands. The largest error is one element's worst
    flip carried through the steps and noise (over 1024 samples × 25 DDIM
    steps it passed 0.1 once): a reading, as at the DDIM timing shapes.
    ``dtype``: the weight type (bf16, or fp16 against its own rounding
    twin); ``grids``: fp16's mode, each of them held against the same
    references (None: the wrapper's choice; True or False: forced); the
    record is the first's, with every mode's under ``modes``."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    dtype = dtype or KB.WEIGHT_DTYPE
    ts, coefs = table
    twin = KB.rounding_twin(net, dtype)
    twin64 = KB.rounding_twin(net, dtype).double()
    kernel = lambda grid, n=None: KB.fused_unet1d_ddim_sample(
        net, cond, x_init, ts[:n], coefs[:n], noise[:n], clip_range=1.0,
        packed=packed, dtype=dtype, grid=grid)
    plain = lambda m, n=None: KB.unet1d_ddim_sample_plain(
        m, cond, x_init, ts[:n], coefs[:n], 1.0, noise[:n])
    with torch.no_grad():
        ref64 = dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, cond.double()), x_init.double(),
            ts[:1], coefs[:1].double(), noise[:1].double(), 1.0)
    one64 = {"twin fp32": err_stats(plain(twin, 1), ref64),
             "unrounded fp32 net": err_stats(plain(net, 1), ref64)}
    ref = plain(twin)
    fp32 = err_stats(plain(net), ref)
    n = int(ts.shape[0])
    for k, v in one64.items():
        print(f"   {what}: after 1 step, {k} against the fp64-sum twin: {v}",
              flush=True)
    modes, names = {}, {None: "chosen", True: "grid", False: "ordinary"}
    for grid in grids:
        label = what if len(grids) == 1 else f"{what} [{names[grid]} mode]"
        one = err_stats(kernel(grid, 1), ref64)
        got = kernel(grid)
        if not (bool(torch.isfinite(got).all())
                and got.shape == x_init.shape):
            raise AssertionError(f"{label}: output not finite or misshapen")
        full = err_stats(got, ref)
        print(f"   {label}: after 1 step, kernel against the fp64-sum twin: "
              f"{one}", flush=True)
        print(f"   {label}: after {n} steps {full} (the fp32 net {fp32})",
              flush=True)
        smoke.check(f"{label} share of elements beyond 5e-3 after 1 step "
                    "(kernel against the fp64-sum twin)",
                    1 - one["frac_within_5e3"],
                    max(1e-2, 1 - one64["twin fp32"]["frac_within_5e3"]))
        smoke.check(f"{label} mean_abs_err after {n} steps", full["mean"],
                    5e-3)
        if not full["mean"] < fp32["mean"]:
            raise AssertionError(f"{label}: the kernel is no closer to the "
                                 "rounding twin than the fp32 net is")
        modes[label] = dict(max_abs_err=full["max"], mean_abs_err=full["mean"],
                            one_step_vs_fp64_twin=dict(one64, kernel=one),
                            all_steps=full)
    rec = dict(modes[next(iter(modes))], fp32_net_vs_twin=fp32, tol=5e-3)
    if len(grids) > 1:
        rec["modes"] = modes
    return rec


def phase_defaults_kernels(smoke: Smoke):
    """Kernel B at every call the four default agents make (DDPM-100,
    their YAML widths, seeded weights from the port's init, 256 envs):
    held against its rounding twin with the same noise after 1 and 100
    steps, timed beside the twin and its bound (products by operations,
    from ``unet_flops_bytes`` with 100 steps; the noise read once), with
    its launch geometry. LDP-hier's planner at the window's 16 latents runs
    in the wide mode. Kernel A at LDP's default IDM over 4096 pairs
    (DDPM-100) and kernel C at 256 physics Lift scenes, the closed loops'
    shapes, are timed for the kernels line. Every agent is built on the
    card, so none of the four configurations raises there."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)

    dev = torch.device("cuda")
    agents = default_agents(dev)
    out: dict = {}
    g = torch.Generator(device=dev).manual_seed(21)
    for key, (name, net, sched, T, B) in default_unets(agents).items():
        ts, coefs = dlib.ddpm_coef_table(sched.to("cpu"))
        table = (ts.to(dev, torch.int32), coefs.to(dev))
        S = int(ts.shape[0])
        if S != 100:
            raise AssertionError(f"{key}: {S} steps, not DDPM-100")
        cond = torch.randn(B, net.global_cond_dim, generator=g, device=dev)
        x0 = torch.randn(B, T, net.input_dim, generator=g, device=dev)
        noise = torch.randn(S, B, T, net.input_dim, generator=g, device=dev)
        packed = KB.pack_params(net).to(dev)
        what = (f"{key} {list(net.down_dims)} B={B} T={T}"
                f"{'' if net.downsample else ' no-downsample'}")
        rec = _ddpm_against_twin(smoke, what, net, cond, x0, noise, table,
                                 packed)
        twin = KB.rounding_twin(net)
        run_k = lambda: KB.fused_unet1d_ddim_sample(
            net, cond, x0, *table, noise, packed=packed)
        run_p = lambda: KB.unet1d_ddim_sample_plain(twin, cond, x0, *table,
                                                    1.0, noise)
        ms = time_ms(run_k, iters=2)
        plain_ms = time_ms(run_p, iters=1, warmup=0)
        smoke.timing(what, ms, plain_ms)
        elem, mm, nbytes = unet_flops_bytes(net, B, T, S)
        nbytes += noise.numel() * 4
        b_ms, b_by = bound(elem, nbytes, bf16_flops=mm)
        shape = KB.kernel_info(net, B, T, S)
        row_tiles = -(-shape["samples_per_block"] * T // 16)
        info = smoke.shape_line(
            what, unet_entry(row_tiles, shape["wide"]),
            shape, mm, PEAK_BF16_FLOPS, "bf16 tensor-core", ms)
        print(f"   {what}: bound {b_ms:.3f} ms ({b_by}) = {b_ms / ms:.2%} of "
              f"the kernel's time; weights "
              f"{shape['weight_bytes_per_step_and_block'] / 1e6:.1f} MB a step "
              f"and block, {shape['weight_bytes_streamed'] / 1e9:.1f} GB "
              f"streamed in all{'; wide mode' if shape['wide'] else ''} "
              f"[{smoke.card}]", flush=True)
        if (key == "B ldp_hier window (wide)") != shape["wide"]:
            raise AssertionError(f"{what}: wide mode {shape['wide']}")
        out[key] = dict(rec, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, bf16_flops=mm, fp32_flops=elem,
                        bytes=nbytes, shape=info)
    out["wide mode cost"] = _wide_mode_cost(smoke, agents["ldp_hier_agent"],
                                            g)
    ldp = agents["ldp_agent"]
    out["A ldp"] = _time_idm(smoke, "A ldp default IDM DDPM-100 4096 rows",
                             ldp, DEF_EVAL_ENVS * 16, g)
    penv = configs.make_bench_env(render_images=False)
    out["C 256"] = raycast_case(smoke, "physics 256",
                                penv.scene(physics_states(penv, DEF_EVAL_ENVS,
                                                          dev)),
                                penv.camera, 0)
    return out


def _wide_mode_cost(smoke: Smoke, agent, g) -> dict:
    """What the wide mode's global scratch costs: LDP-hier's planner at P =
    4 latents, 256 samples, DDPM-100, one sample a block, in the ordinary
    program and in the wide one, timed in turns (ordinary, wide, wide,
    ordinary). Both run the same records over the same shared-memory
    operands, so their results must be equal bit for bit."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    net, T, B = agent.planner, agent.plan_length, DEF_EVAL_ENVS
    ts, coefs = dlib.ddpm_coef_table(agent.planner_sched.to("cpu"))
    ts, coefs = ts.to("cuda", torch.int32), coefs.to("cuda")
    cond = torch.randn(B, net.global_cond_dim, generator=g, device="cuda")
    x0 = torch.randn(B, T, net.input_dim, generator=g, device="cuda")
    noise = torch.randn(len(ts), B, T, net.input_dim, generator=g,
                        device="cuda")
    packed = KB.pack_params(net).to("cuda")
    run = lambda wide: KB.fused_unet1d_ddim_sample(
        net, cond, x0, ts, coefs, noise, packed=packed, nb=1, wide=wide)
    same = bool(torch.equal(run(False), run(True)))
    ms = {False: [], True: []}
    for wide in (False, True, True, False):
        ms[wide].append(time_ms(lambda: run(wide), iters=2))
    ordinary, wide = sum(ms[False]) / 2, sum(ms[True]) / 2
    print(f"   wide mode at LDP-hier's planner, {B} samples x T {T}, one a "
          f"block: ordinary {ms[False]} ms, wide {ms[True]} ms, "
          f"{wide / ordinary - 1:+.1%}; outputs equal bit for bit: {same} "
          f"[{smoke.card}]", flush=True)
    if not same:
        raise AssertionError("the wide program's output differs from the "
                             "ordinary one's")
    return dict(ordinary_ms=ms[False], wide_ms=ms[True],
                overhead=wide / ordinary - 1)


def phase_defaults(smoke: Smoke, device: str = "cuda"):
    """The JAX package's four default agent configurations from the command
    line, in a scratch folder under the checkout's git-ignored ``build/``
    (removed after): demos (128 + 32 physics envs × 80 steps), the default
    VAE (``stable_vae``: 6 stages [128,256,256,256,256,256], patch 1, a
    16-dim latent) for ``DEF_VAE_STEPS`` steps, the demos' latents, then
    for each agent ``train_bc agent=<name>`` at its YAML widths with
    DDPM-100 and ``train_bc``'s batch 256 for ``DEF_TRAIN_STEPS`` steps (the
    warm-up cut to a quarter of them; losses must fall; the run's final
    eval without episodes: offline action MSE and plan statistics, launches
    counted), and ``eval_bc`` over ``DEF_EVAL_ENVS`` episodes of
    ``DEF_EVAL_LEN`` steps, its launches stated before the run (one a
    decision: LDP B, A and C; LDP-hier B twice and C; DP and DPVAE B and
    C); then kernel B (and A) on each
    trained agent's nets against their twins, LDP-hier's planner at the
    window's 16 latents in the wide mode once more, and one LDP decision
    at 256 envs stage by stage."""
    import os
    import shutil
    import tempfile
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_defaults_", dir=build))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        return _drive_defaults(smoke, work, device)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


# (run name, agent, its command line beyond default_command_line)
DEF_RUNS = tuple((name, name, ()) for name in DEF_AGENTS)


def _drive_defaults(smoke: Smoke, work: Path, device: str,
                    runs: tuple = DEF_RUNS, vae_args: tuple = ()) -> dict:
    import torch
    from latent_diffusion_planning_tpu_torch.drivers import (
        agent_from_snapshot, run_data)
    from latent_diffusion_planning_tpu_torch.ops import kernels
    from latent_diffusion_planning_tpu_torch.rollout import engine
    from latent_diffusion_planning_tpu_torch.train import loop
    from latent_diffusion_planning_tpu_torch.utils.config import load_config

    args = [] if device == "cuda" else [f"device={device}"]
    V, N = DEF_VAE_STEPS, DEF_TRAIN_STEPS
    out: dict = {"stage_s": {}, "agents": {}}
    kernel_rec = smoke.record["phases"].get(DEF_KERNEL_PHASE, {})
    out.update({k: v for k, v in kernel_rec.items()
                if k.startswith(("A ", "B ", "C "))})
    workspaces: list = []
    real_run = loop.Workspace.run

    def run(ws):
        workspaces.append(ws)
        return real_run(ws)

    def stage(name, driver, argv):
        module = importlib.import_module(
            f"latent_diffusion_planning_tpu_torch.drivers.{driver}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        module.main(argv + args)
        _sync(device)
        out["stage_s"][name] = time.perf_counter() - t0
        print(f"   {name}: {out['stage_s'][name]:.1f} s [{smoke.card}]",
              flush=True)
        return kernels.launch_counts()

    for split, n, seed in DEF_DEMO_SPLITS:
        suffix = "" if split == "train" else "_eval"
        stage(f"collect_demos {split}", "collect_demos", [
            f"n_episodes={n}", f"episode_len={DEMO_LEN}",
            f"out_path=datasets/demos{suffix}.npz", f"seed={seed}"])
    paths = ["data.train_path=datasets/demos.npz",
             "data.eval_path=datasets/demos_eval.npz"]
    latent_paths = ["data.train_latent_path=datasets/demos_latent.npz",
                    "data.eval_latent_path=datasets/demos_eval_latent.npz"]
    loop.Workspace.run = run
    try:
        stage("train_vae (stable_vae)", "train_vae", [
            "data=lift/img", *paths, *vae_args, f"n_grad_steps={V}",
            f"warmup_steps={V // 4}", f"eval_every={V}", f"save_every={V}",
            "experiment_folder=defaults", "experiment_name=vae"])
    finally:
        loop.Workspace.run = real_run
    vae_ws = workspaces.pop()
    curve = vae_ws.loss_curve()
    first, last = _loss_means(curve)
    print(f"   stable_vae {' '.join(vae_args)} {V} steps at batch "
          f"{vae_ws.cfg['batch_size']}: {V / vae_ws.train_seconds:.2f} "
          f"steps/s; loss {first} -> {last} [{smoke.card}]", flush=True)
    _falls(curve, ("loss",), first, last)
    vae = f"experiments/defaults/vae/ckpt/{V}.ckpt"
    if not (work / vae).exists():
        raise AssertionError(f"{vae} was not written")
    stage("process_latents (stable_vae)", "process_latents", [
        f"vae_snapshot_path={vae}",
        "src_paths=[datasets/demos.npz,datasets/demos_eval.npz]",
        "dst_paths=[datasets/demos_latent.npz,datasets/demos_eval_latent.npz]"])
    out.update(vae_loss_first20=first, vae_loss_last20=last,
               vae_steps_per_s=V / vae_ws.train_seconds)

    n_dec = math.ceil(DEF_EVAL_LEN / 8)
    for run_name, name, extra in runs:
        rec: dict = {}
        line = default_command_line(name) + list(extra) + paths + [
            f"data.env_params.env.episode_len={DEF_EVAL_LEN}",
            f"n_grad_steps={N}", f"warmup_steps={N // 4}", f"eval_every={N}",
            f"save_every={N}", "n_eval_episodes=0",
            "experiment_folder=defaults", f"experiment_name={run_name}"]
        if DEF_DATA[name] == "lift/latent_img":
            line += latent_paths + [f"agent.vae_pretrain_path={vae}"]
        cfg = load_config("train_bc", line)
        steps = {k: cfg.agent.get(k) for k in (
            "n_diffusion_steps", "inference_steps", "planner_n_diffusion_steps",
            "planner_inference_steps", "idm_n_diffusion_steps",
            "idm_inference_steps") if k in cfg.agent}
        print(f"   {run_name}: {' '.join(default_command_line(name))} "
              f"{' '.join(extra)}; batch {cfg.batch_size}, widths "
              f"{cfg.agent['planner']['down_dims']}, {steps}", flush=True)
        if (cfg.batch_size != 256 or cfg.action_horizon != 8
                or any(v not in (None, 100) for v in steps.values())):
            raise AssertionError(f"{name}: not the defaults: {steps}")
        loop.Workspace.run = run
        try:
            train_counts = stage(f"train_bc {run_name}", "train_bc", line)
        finally:
            loop.Workspace.run = real_run
        ws = workspaces.pop()
        curve = ws.loss_curve()
        first, last = _loss_means(curve)
        print(f"   {run_name}: {N} steps at batch {cfg.batch_size} in "
              f"{ws.train_seconds:.3f} s "
              f"= {N / ws.train_seconds:.2f} steps/s; losses first 20 "
              f"{first}, last 20 {last} [{smoke.card}]", flush=True)
        _falls(curve, ws.agent.LOSS_KEYS, first, last)
        # the run's final eval: one offline batch of each split through
        # sample_action and, for LDP and LDP-hier, sample_plan_stats
        want = {"diffusion_mlp": 2 if name == "ldp_agent" else 0,
                "diffusion_unet1d": {"ldp_agent": 2,
                                     "ldp_hier_agent": 4}.get(name, 2),
                "raycast": 0}
        print(f"   {run_name} train_bc (its final eval): launches "
              f"{train_counts} (stated: {want})", flush=True)
        if device == "cuda" and train_counts != want:
            raise AssertionError(f"{run_name}: train_bc launches "
                                 f"{train_counts}")
        rec.update(steps_per_s=N / ws.train_seconds, loss_first20=first,
                   loss_last20=last, train_launches=train_counts,
                   final_eval=dict(ws.last_eval))

        # the closed loop through eval_bc, its launches counted around it
        counted: dict = {}
        real = engine.run_batched_eval_multi

        def counting(*a, **kw):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = real(*a, **kw)
            _sync(device)
            counted.update(counts=kernels.launch_counts(),
                           grid=kernels.diffusion_unet1d
                           .fused_unet1d_ddim_sample.grid_launches,
                           wall_s=time.perf_counter() - t0, results=res)
            return res
        engine.run_batched_eval_multi = counting
        try:
            stage(f"eval_bc {run_name}", "eval_bc", [
                f"run_dir=experiments/defaults/{run_name}",
                f"n_eval_episodes={DEF_EVAL_ENVS}"])
        finally:
            engine.run_batched_eval_multi = real
        # the engine renders the window's obs_horizon states a decision
        want = {"raycast": n_dec * cfg.obs_horizon,
                "diffusion_unet1d": n_dec * (2 if name == "ldp_hier_agent"
                                             else 1),
                "diffusion_mlp": n_dec if name == "ldp_agent" else 0}
        m = counted["results"][0]["metrics"]
        print(f"   {run_name} closed loop {DEF_EVAL_ENVS} x {DEF_EVAL_LEN}: "
              f"launches {counted['counts']} (stated: {want}), "
              f"{counted['wall_s']:.3f} s = "
              f"{DEF_EVAL_ENVS * DEF_EVAL_LEN / counted['wall_s']:.1f} "
              f"computed env-steps/s, success {m['success']:.4f} "
              f"[{smoke.card}]", flush=True)
        if device == "cuda" and counted["counts"] != want:
            raise AssertionError(f"{run_name} closed-loop launches "
                                 f"{counted['counts']} != {want}")
        # fp16 B at the default planner's 256 samples: every launch in the
        # grid mode
        grid_want = (want["diffusion_unet1d"]
                     if "agent.fused_dtype=float16" in extra else 0)
        print(f"   {run_name} closed loop: B's grid-mode launches "
              f"{counted['grid']} (stated: {grid_want})", flush=True)
        if device == "cuda" and counted["grid"] != grid_want:
            raise AssertionError(f"{run_name}: B's grid-mode launches "
                                 f"{counted['grid']} != {grid_want}")
        rec.update(loop_launches=counted["counts"],
                   loop_grid_launches=counted["grid"],
                   loop_wall_s=counted["wall_s"],
                   loop_success=float(m["success"]))

        # kernel B (A for LDP's IDM) on the trained nets against the twins
        run_dir = work / "experiments" / "defaults" / run_name
        run_cfg = load_config(str(run_dir / "config.json"))
        data, agent_cfg = run_data(run_cfg, torch.device(device))
        agent = agent_from_snapshot(agent_cfg, data,
                                    run_dir / "ckpt" / f"{N}.ckpt",
                                    torch.device(device))
        rec["trained"] = _trained_default_checks(smoke, name, agent, device,
                                                 run_name)
        if name == "ldp_hier_agent":
            kernels.reset_launch_counts()
            stats = agent.sample_plan_stats(next(data.eval_dataloader()))
            _sync(device)
            counts = kernels.launch_counts()
            print(f"   {name} sample_plan_stats at the window's 16 latents "
                  f"(wide mode): {({k: float(v) for k, v in stats.items()})},"
                  f" launches {counts}", flush=True)
            if device == "cuda" and counts["diffusion_unet1d"] != 1:
                raise AssertionError(f"plan stats launches {counts}")
            out["hier_window"] = {"launches": counts}
        if run_name == "ldp_agent":
            out["ldp_decision_ms"] = _default_decision(smoke, agent, device)
        out["agents"][run_name] = rec
        out[f"{run_name} loop"] = {"launches": counted["counts"]}
    return out


def _trained_default_checks(smoke, name: str, agent, device: str,
                            run_name: str | None = None) -> dict:
    """Kernel B's DDPM on a trained default agent's U-Nets (kernel A's on
    LDP's IDM) against the twins, at the closed loop's shapes, the same
    noise handed to both: with ``fused_dtype: float32`` B in fp32 against
    the fp32 twin (1e-3), with ``float16`` against its fp16 rounding twin
    by phase B's statistics."""
    import torch
    from latent_diffusion_planning_tpu_torch.models.agents import common
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA)
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(31)
    E = DEF_EVAL_ENVS
    if name.startswith("ldp"):
        calls = [("planner", agent.config.planner_inference_steps,
                  agent.plan_length if name == "ldp_hier_agent" else 16, E)]
        if name == "ldp_hier_agent":
            calls.append(("idm", agent.config.idm_inference_steps,
                          agent.config.idm_horizon, E * agent.plan_length))
    else:
        calls = [("sampler", agent.config.inference_steps, 16, E)]
    out = {}
    for net_name, steps, T, B in calls:
        if net_name == "sampler":
            net, sched = agent._sampling_net(), agent.sched
            table = agent.sampler.table()
        else:
            net = agent._inference_net(net_name)
            sched = getattr(agent, f"{net_name}_sched")
            table = agent._table(sched, steps)
        dtype = common.fused_weight_dtype(agent.config.fused_dtype)
        packed = KB.pack_params(net, dtype).to(dev)
        cond = torch.randn(B, net.global_cond_dim, generator=g, device=dev)
        x0 = torch.randn(B, T, net.input_dim, generator=g, device=dev)
        noise = common.step_noise(steps, sched, None, tuple(x0.shape), g, dev)
        what = (f"trained {run_name or name} B {net_name} ({B} samples, T "
                f"{T}, DDPM-{int(table[0].shape[0])})")
        if dtype == torch.float32:
            out[net_name] = _fp32_against_twin(smoke, what, net, cond, x0,
                                               noise, table, packed)
        else:
            out[net_name] = _ddpm_against_twin(smoke, what, net, cond, x0,
                                               noise, table, packed, dtype)
    if name == "ldp_agent":
        c = agent.config
        steps = c.idm_inference_steps
        ts, coefs = agent._table(agent.idm_sched, steps)
        rows = E * 16
        s = torch.randn(rows, 2 * c.obs_dim, generator=g, device=dev)
        x0 = torch.randn(rows, c.action_dim, generator=g, device=dev)
        noise = common.step_noise(steps, agent.idm_sched, None,
                                  (rows, c.action_dim), g, dev)
        net = agent._inference_net("idm")
        got = KA.fused_mlp_diffusion_sample(net, s, x0, ts, coefs, noise,
                                            packed=agent._packed("idm"))
        ref = KA.mlp_diffusion_sample_plain(net, s, x0, ts, coefs, noise)
        err = float((got - ref).abs().max())
        smoke.check(f"trained {run_name or name} A ({rows} rows, "
                    f"DDPM-{len(ts)}) max_abs_err vs the fp32 twin", err, 1e-3)
        out["idm"] = dict(max_abs_err=err)
    return out


def _default_decision(smoke: Smoke, agent, device: str) -> dict:
    """One decision of the trained default LDP agent at 256 envs, stage by
    stage (CUDA events over repeated calls): the stable VAE's encode, the
    plan (B, DDPM-100), the IDM decode (A, DDPM-100), eight physics
    transitions from the CUDA graph, the render and observation."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.agents import common

    n, c = DEF_EVAL_ENVS, agent.config
    env = configs.make_bench_env(DEF_EVAL_LEN)
    g = torch.Generator(device=device).manual_seed(8)
    state = physics_states(env, n, device, seed=8)
    obs = env.obs(state)
    window = {k: obs[k][:, None] for k in configs.BENCH_POLICY_KEYS}
    emb = agent._obs_cond(agent._prepare_eval_batch({"obs": window})["obs"])
    cond = emb[:, 0]
    x_plan = torch.randn(n, c.pred_horizon, c.obs_dim, device=device)
    pairs = common.consecutive_pairs(torch.cat(
        [emb, agent._plan(cond, x_plan, g)], 1))
    x_idm = torch.randn(pairs.shape[0], c.action_dim, device=device)
    acts = torch.rand(n, 7, device=device) * 2 - 1
    stages = {
        "render + obs (kernel C)": lambda: env.obs(state),
        f"{c.action_horizon} transitions, CUDA graph":
            lambda: [env.transition(state, acts)
                     for _ in range(c.action_horizon)],
        "normalize + stable VAE encode": lambda: agent._prepare_eval_batch(
            {"obs": window}),
        "plan (kernel B, DDPM-100)": lambda: agent._plan(cond, x_plan, g),
        "IDM decode (kernel A, DDPM-100)":
            lambda: agent._idm_decode(pairs, x_idm, g),
        "sample_fast (VAE + B + A + glue)": lambda: agent.sample_fast(
            {"obs": window}, generator=g),
    }
    out = {}
    for name, fn in stages.items():
        out[name] = time_ms(fn, iters=2)
        print(f"   default LDP decision at {n} envs, {name}: "
              f"{out[name]:.3f} ms [{smoke.card}]", flush=True)
    return out


OPT_KERNEL_PHASE = ("options: kernel B with fp32 and fp16 weights at the "
                    "default agents' calls and the bench planner, B at a "
                    "3099-wide condition, kernel A's IDM variants, and the "
                    "shapes the TPU kernels take")
OPT_PHASE = ("options: LDP with fp32 B, a mish IDM with dropout and a bf16 "
             "planner, and DP at obs_horizon 3 with a bf16 encoder, from the "
             "command line on a stable VAE trained in bf16; the default LDP "
             "with fp16 B in a closed loop")
OPT_LDP = ("agent.fused_dtype=float32", "agent.idm_net.cond_activation=mish",
           "agent.idm_net.dropout_rate=0.1",
           "agent.planner.compute_dtype=bfloat16")
OPT_DP = ("obs_horizon=3", "agent.encoder.compute_dtype=bfloat16")
OPT_RUNS = (("ldp_options", "ldp_agent", OPT_LDP),
            ("dp_options", "dp_agent", OPT_DP),
            ("ldp_fp16", "ldp_agent", ("agent.fused_dtype=float16",)))
OPT_VAE = ("model.vae.compute_dtype=bfloat16",)
OPT_IDM_ROWS = 4096          # kernel A's variants: 256 envs x 16 pairs
# kernel A's variants of the default LDP IDM (hidden 256, swish, LayerNorm,
# learnable time features): the upstream recipe's mish, and one option each
OPT_IDM_VARIANTS = {
    "A mish": dict(cond_activation="mish"),
    "A no LayerNorm": dict(use_layer_norm=False),
    "A fixed time features": dict(learnable_time=False),
    "A hidden 48": dict(hidden_dim=48),
    "A hidden 512": dict(hidden_dim=512),
}


# kernel B's fp32 instance in its first design (one block a sample at the
# default widths, a block-wide barrier a 16 KB tile): its times (ms) on one
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6)
FIRST_FP32_MS = {
    "B ldp planner fp32": 3172.793, "B ldp_hier planner fp32": 3025.593,
    "B ldp_hier window (wide) fp32": 3587.166,
    "B ldp_hier chunk IDM fp32": 927.848, "B dp fp32": 3161.044,
    "B dp_repr fp32": 3119.260, "B dp 3099 fp32": 3184.466,
    "B bench planner fp32": 16.915,
}


def _fp32_against_twin(smoke, what, net, cond, x_init, noise, table, packed,
                       tol: float = 1e-3) -> dict:
    """Kernel B with fp32 weights on ``net`` against its fp32 twin (the net
    computing in fp32 with TF32 off) with the same per-step noise (None for
    DDIM): the largest error within ``tol`` (1e-3 after DDPM-100, whose
    first steps scale the net's output by up to 1e3; 2e-4 after DDIM-10,
    the JAX package's kernel-against-scan bar)."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    from latent_diffusion_planning_tpu_torch.utils.precision import fp32_math
    ts, coefs = table
    got = KB.fused_unet1d_ddim_sample(net, cond, x_init, ts, coefs, noise,
                                      clip_range=1.0, packed=packed,
                                      dtype=torch.float32)
    with fp32_math():
        ref = KB.unet1d_ddim_sample_plain(KB.fp32_twin(net), cond, x_init, ts,
                                          coefs, 1.0, noise)
    if not (bool(torch.isfinite(got).all()) and got.shape == x_init.shape):
        raise AssertionError(f"{what}: output not finite or misshapen")
    e = err_stats(got, ref)
    print(f"   {what}: after {len(ts)} steps against the fp32 twin {e}",
          flush=True)
    smoke.check(f"{what} max_abs_err vs the fp32 twin", e["max"], tol)
    return dict(max_abs_err=e["max"], mean_abs_err=e["mean"], tol=tol)


def _time_unet_fp32(smoke, what, net, cond, x0, noise, table, packed,
                    key: str) -> dict:
    """Kernel B with fp32 weights timed beside its fp32 twin, with its
    launch geometry (samples a block, mode, grid and its waves on the card,
    ring stages, the bytes it streams to the SMs) and its bound: the
    products at three TF32 passes (``unet_flops_bytes``, fp32 weights read
    once); the first design's time (``FIRST_FP32_MS[key]``, where it has
    one) beside it."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    from latent_diffusion_planning_tpu_torch.utils.precision import fp32_math
    ts, coefs = table
    B, T = x0.shape[:2]
    S = int(ts.shape[0])
    twin = KB.fp32_twin(net)
    run_k = lambda: KB.fused_unet1d_ddim_sample(
        net, cond, x0, ts, coefs, noise, packed=packed, dtype=torch.float32)

    def run_p():
        with fp32_math():
            KB.unet1d_ddim_sample_plain(twin, cond, x0, ts, coefs, 1.0, noise)
    ms = time_ms(run_k, iters=1)
    plain_ms = time_ms(run_p, iters=1, warmup=0)
    smoke.timing(what, ms, plain_ms)
    elem, mm, nbytes = unet_flops_bytes(net, B, T, S, weight_bytes=4)
    if noise is not None:
        nbytes += noise.numel() * 4
    b_ms, b_by = bound(elem, nbytes, fp32_products=mm)
    sms = torch.cuda.get_device_properties(x0.device).multi_processor_count
    shape = KB.kernel_info(net, B, T, S, dtype=torch.float32, sms=sms)
    print(f"   {what}: plan: {shape['samples_per_block']} samples a block"
          f"{' (wide mode)' if shape['wide'] else ''}, grid {shape['grid']} "
          f"({shape['waves']} wave(s) on {sms} SMs), ring "
          f"{shape['ring_stages']} tiles, "
          f"{shape['weight_bytes_streamed'] / 1e12:.4f} TB of weights to the "
          f"SMs a call", flush=True)
    old = FIRST_FP32_MS.get(key)
    if old is not None:
        print(f"   {what}: {ms:.3f} ms against the first design's {old:.3f} "
              f"ms ({old / ms:.2f}x), twin {plain_ms:.3f} ms [{smoke.card}]",
              flush=True)
    row_tiles = -(-shape["samples_per_block"] * T // 16)
    info = smoke.shape_line(what, unet_entry(row_tiles, shape["wide"], True),
                            shape, 3 * mm, PEAK_TF32_FLOPS,
                            "TF32 tensor-core (3 passes)", ms)
    print(f"   {what}: bound {b_ms:.3f} ms ({b_by}: three TF32 passes) = "
          f"{b_ms / ms:.2%} of the kernel's time; weights "
          f"{shape['weight_bytes_per_step_and_block'] / 1e6:.1f} MB a step "
          f"and block{'; wide mode' if shape['wide'] else ''} [{smoke.card}]",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                first_ms=old, tf32_products=mm, fp32_flops=elem, bytes=nbytes,
                shape=info,
                source="latent_diffusion_planning_tpu_torch/csrc/"
                "diffusion_unet1d_f32.cu")


def _fp16_call(smoke, key, net, cond, x0, noise, table) -> dict:
    """Kernel B with fp16 weights (``fused_dtype: float16``) at one default
    call (DDPM-100) in both modes, the grid mode (forced: the wrapper keeps
    the ordinary mode at the chunk IDM, ``choose_grid``) and the ordinary
    one: each against its fp16 rounding twin by phase B's statistics; the
    same bits from two grid-mode launches; the grid mode timed beside that
    twin and, in alternating turns, beside the bf16 instance and the
    ordinary fp16 mode at the same call, with its bound (the products at
    the fp16 tensor-core peak, bf16's) and launch geometry."""
    import torch
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    f16 = torch.float16
    B, T = x0.shape[:2]
    S = int(table[0].shape[0])
    what = (f"{key} fp16 {list(net.down_dims)} B={B} T={T}"
            f"{'' if net.downsample else ' no-downsample'}, DDPM-{S}")
    sms = torch.cuda.get_device_properties(x0.device).multi_processor_count
    chosen = KB.choose_grid(net, T, B, f16, sms)
    print(f"   {what}: the wrapper's mode here: "
          f"{'grid' if chosen else 'ordinary'}", flush=True)
    packed = KB.pack_params(net, f16).to(x0.device)
    KB.fused_unet1d_ddim_sample.grid_launches = 0
    rec = _ddpm_against_twin(smoke, what, net, cond, x0, noise, table, packed,
                             dtype=f16, grids=(True, False))
    if KB.fused_unet1d_ddim_sample.grid_launches != 2:
        raise AssertionError(f"{what}: the twin check ran "
                             f"{KB.fused_unet1d_ddim_sample.grid_launches} "
                             "grid launches, not 2")
    twin = KB.rounding_twin(net, f16)
    bf16_pack = KB.pack_params(net).to(x0.device)
    run_k = lambda: KB.fused_unet1d_ddim_sample(
        net, cond, x0, *table, noise, packed=packed, dtype=f16, grid=True)
    run_o = lambda: KB.fused_unet1d_ddim_sample(
        net, cond, x0, *table, noise, packed=packed, dtype=f16, grid=False)
    run_b = lambda: KB.fused_unet1d_ddim_sample(
        net, cond, x0, *table, noise, packed=bf16_pack)
    run_p = lambda: KB.unet1d_ddim_sample_plain(twin, cond, x0, *table, 1.0,
                                                noise)
    same = torch.equal(run_k(), run_k())
    print(f"   {what}: two grid-mode launches give the same bits: {same}",
          flush=True)
    if not same:
        raise AssertionError(f"{what}: two launches differ")
    # every mode has run once above (the bf16 and ordinary ones now)
    run_b(), run_o()
    turns = {"grid": [], "bf16": [], "fp16 ordinary": []}
    for _ in range(2):
        for name, fn in (("grid", run_k), ("bf16", run_b),
                         ("fp16 ordinary", run_o)):
            turns[name].append(time_ms(fn, iters=1, warmup=0))
    ms, bf16_ms = min(turns["grid"]), min(turns["bf16"])
    plain_ms = time_ms(run_p, iters=1, warmup=0)
    smoke.timing(what, ms, plain_ms)
    print(f"   {what}: in turns (ms) {json.dumps(turns)}: the grid mode "
          f"{ms:.3f}, the bf16 instance {bf16_ms:.3f} ({ms / bf16_ms:.3f}x), "
          f"the ordinary fp16 mode {min(turns['fp16 ordinary']):.3f} "
          f"[{smoke.card}]", flush=True)
    elem, mm, nbytes = unet_flops_bytes(net, B, T, S)
    b_ms, b_by = bound(elem, nbytes + noise.numel() * 4, bf16_flops=mm)
    shape = KB.kernel_info(net, B, T, S, dtype=f16, sms=sms, grid=True)
    ordinary = KB.kernel_info(net, B, T, S, dtype=f16, sms=sms, grid=False)
    print(f"   {what}: the grid mode's blocks read "
          f"{shape['weight_bytes_streamed'] / 1e12:.4f} TB of weights and "
          f"move {shape['activation_bytes'] / 1e12:.4f} TB of activations "
          f"a call ({shape['hbm_weight_bytes'] / 1e9:.2f} GB of weights "
          f"from HBM, {shape['barriers']} barriers); the ordinary mode's "
          f"{ordinary['grid']} blocks stream "
          f"{ordinary['weight_bytes_streamed'] / 1e12:.4f} TB", flush=True)
    info = smoke.shape_line(what, "unet1d_grid_kernel", shape, mm,
                            PEAK_BF16_FLOPS, "fp16 tensor-core", ms)
    return dict(rec, ms=ms, plain_ms=plain_ms, bf16_ms=bf16_ms,
                ordinary_ms=min(turns["fp16 ordinary"]), turns=turns,
                mode="grid", wrapper_mode="grid" if chosen else "ordinary",
                bound_ms=b_ms, bound_by=b_by, shape=info,
                ordinary_weight_bytes=ordinary["weight_bytes_streamed"],
                source="latent_diffusion_planning_tpu_torch/csrc/"
                "unet1d_grid.cuh")


# the JAX fp16 kernel's rounding points that the fp16 instance and
# ``rounding_twin(net, float16)`` keep and the bf16 program lacks
FP16_POINTS = ("groupnorm", "film", "down", "final conv")


def fp16_twin_without(net, points=FP16_POINTS):
    """``rounding_twin(net, float16)`` without the JAX kernel's rounding
    points named in ``points``: GroupNorm's statistics from the unrounded
    values ("groupnorm"), FiLM's scale and bias and the downsample's output
    unrounded ("film", "down"), the final 1x1 conv's input rounded like
    every other operand ("final conv"). Without all four it is the bf16
    program with fp16 operands."""
    import functools
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConvBlock1D)
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    hooks = {KB._round_film: "film", KB._round_down: "down"}
    twin = KB.rounding_twin(net, torch.float16)
    for m in twin.modules():
        if "groupnorm" in points and isinstance(m, ConvBlock1D):
            m.norm = m.norm.norm
        for k, h in list(m._forward_hooks.items()):
            if hooks.get(getattr(h, "func", None)) in points:
                del m._forward_hooks[k]
    if "final conv" in points:
        twin.final_conv.register_forward_pre_hook(
            functools.partial(KB._round_input, torch.float16))
    return twin


def _fp16_rounding_points(smoke, g) -> dict:
    """The fp16 instance computes JAX's fp16 function, each rounding point
    included, not the bf16 program in fp16. On a narrow net where every
    point shows (5 channels, down_dims (8, 8, 16): widths not a multiple of
    128, an identity residual after the downsample), 256 samples of 8 steps,
    DDIM-2 of a 12-step cosine schedule: the samples on which the kernel
    holds the fp64-sum rounding twin within 1e-6 (those no fp16 rounding
    flip between the two orders of summation touches; 145 of 256 for the
    fp32-sum twin on the CPU) are at least an eighth, and more than four
    times as many as the twin without any one point (or all four) holds
    (none on the CPU). Then the overflow: 4 samples, sample 1's initial draw
    times 500, so x * x overflows fp16 in the GroupNorm statistics; the
    kernel's output is NaN and inf exactly where the twin's is, and the
    other samples are finite."""
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    f16, dev, B = torch.float16, torch.device("cuda"), 256
    net = ConditionalUnet1D(5, 5, 32, (8, 8, 16), 5, 4,
                            generator=torch.Generator().manual_seed(3)).to(dev)
    ts, coefs = dlib.ddim_coef_table(
        dlib.DiffusionSchedule.create(12, "squaredcos_cap_v2"), 2)
    ts, coefs = ts.to(dev, torch.int32), coefs.to(dev)
    cond = torch.randn(B, 5, generator=g, device=dev)
    x0 = torch.randn(B, 8, 5, generator=g, device=dev)
    packed = KB.pack_params(net, f16).to(dev)
    run_k = lambda c, x: KB.fused_unet1d_ddim_sample(
        net, c, x, ts, coefs, packed=packed, dtype=f16)
    twin64 = KB.rounding_twin(net, f16).double()
    with torch.no_grad():
        ref = dlib.sample_with_coefs(
            lambda x, t: twin64(x, t, cond.double()), x0.double(), ts,
            coefs.double(), None, 1.0)

    def exact(y):
        e = (y.double() - ref).abs().reshape(B, -1).amax(1)
        return int((e <= 1e-6).sum())
    what = "B fp16 rounding points (8, 8, 16) B=256 T=8, DDIM-2"
    run_g = lambda c, x: KB.fused_unet1d_ddim_sample(
        net, c, x, ts, coefs, packed=packed, dtype=f16, grid=True)
    held = {"kernel": exact(run_k(cond, x0)),
            "kernel, grid mode": exact(run_g(cond, x0))}
    for name, pts in [(p, (p,)) for p in FP16_POINTS] + [("all four",
                                                          FP16_POINTS)]:
        held[f"twin without {name}"] = exact(KB.unet1d_ddim_sample_plain(
            fp16_twin_without(net, pts), cond, x0, ts, coefs))
    print(f"   {what}: samples within 1e-6 of the fp64-sum twin: {held}",
          flush=True)
    worst = max(v for k, v in held.items() if k.startswith("twin"))
    for k in ("kernel", "kernel, grid mode"):
        if not (held[k] >= B // 8 and held[k] > 4 * worst):
            raise AssertionError(f"{what}: the {k} holds the twin on "
                                 f"{held[k]} samples (at least {B // 8} and "
                                 f"more than 4 x {worst} wanted)")

    c4, x4 = cond[:4].clone(), x0[:4].clone()
    x4[1] *= 500
    want = KB.unet1d_ddim_sample_plain(KB.rounding_twin(net, f16), c4, x4,
                                       ts, coefs)
    out = {}
    for k, run in (("kernel", run_k), ("kernel, grid mode", run_g)):
        got = run(c4, x4)
        same = (torch.equal(got.isnan(), want.isnan())
                and torch.equal(got.isinf(), want.isinf()))
        print(f"   {what}: sample 1 times 500: the {k}'s non-finite "
              f"elements {int((~got.isfinite()).sum())} (NaN "
              f"{int(got.isnan().sum())}), the twin's "
              f"{int((~want.isfinite()).sum())} (NaN "
              f"{int(want.isnan().sum())}); the same places: {same}",
              flush=True)
        if not (same and bool(want[1].isnan().all())
                and bool(got[[0, 2, 3]].isfinite().all())):
            raise AssertionError(f"{what}: the {k}'s overflow NaN and inf "
                                 "differ from the twin's")
        out[f"overflow_same_places ({k})"] = same
    a, b = run_g(cond, x0), run_g(cond, x0)
    print(f"   {what}: two grid-mode launches give the same bits: "
          f"{torch.equal(a, b)}", flush=True)
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: two grid-mode launches differ")
    return dict(held, **out)


# the bf16 instance's output at the default LDP planner on the recipe of
# tools/probe_unet_kernel.py's turns (widths (256, 512, 1024), 25 channels,
# the port's init from seed 3, noise, condition and start from the CPU's
# generator seeded 4, DDPM-100 cosine, 256 plans of 16), as the tree
# before the grid mode computed it (probe_unet_kernel.py --turns, one
# NVIDIA H100 80GB HBM3, torch 2.11 + CUDA 12.8). The kernel's sums do not
# depend on torch, but the net's init and the draws pass through it:
# recompute the digest with the parent's tree after a torch upgrade, as
# after a change to the bf16 instance.
PARENT_BF16_LDP_SHA256 = ("5aae4b85b02056f3e4af798d3015c1cc944dbd1d3f2448"
                          "8966031ad6e1a29e82")


def _bf16_planner_unchanged(smoke) -> dict:
    """The bf16 instance is the parent's: its output at the default LDP
    planner has the parent's SHA-256 bit for bit."""
    import hashlib
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    net = ConditionalUnet1D(25, 25, 256, (256, 512, 1024), 5, 8,
                            generator=torch.Generator().manual_seed(3)).to(dev)
    ts, coefs = dlib.ddpm_coef_table(
        dlib.DiffusionSchedule.create(100, "squaredcos_cap_v2"))
    noise = torch.randn(100, 256, 16, 25, generator=g).to(dev)
    gc = torch.randn(256, 25, generator=g).to(dev)
    x0 = torch.randn(256, 16, 25, generator=g).to(dev)
    out = KB.fused_unet1d_ddim_sample(
        net, gc, x0, ts.to(dev, torch.int32), coefs.to(dev), noise,
        packed=KB.pack_params(net).to(dev))
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    same = digest == PARENT_BF16_LDP_SHA256
    print(f"   B bf16 default LDP planner: output SHA-256 {digest}, the "
          f"parent's {PARENT_BF16_LDP_SHA256}: the same {same} "
          f"[{smoke.card}]", flush=True)
    if not same:
        raise AssertionError("the bf16 instance's output is not the "
                             "parent's")
    return dict(sha256=digest, same_as_parent=same)


def options_dp_agent(device):
    """The default DP agent at ``obs_horizon=3`` (a (1024 + 9) × 3 = 3099-wide
    condition), built on ``device`` from the command line."""
    from latent_diffusion_planning_tpu_torch.train.loop import build_agent
    from latent_diffusion_planning_tpu_torch.utils.config import load_config
    cfg = load_config("train_bc", default_command_line("dp_agent")
                      + ["obs_horizon=3"])
    agent_cfg = {k: v for k, v in dict(cfg.agent).items()
                 if k != "vae_pretrain_path"}
    return build_agent(agent_cfg, cfg.data["meta"]["shape_meta"], 3, device)


def options_idm(variant: dict, device, S: int = 50, A: int = 7):
    """The default LDP IDM (``conf/agent/ldp_agent.json``'s ``idm_net``) with
    one option changed, the port's init from seed 5."""
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.mlp import (
        MLPDiffusion)
    from latent_diffusion_planning_tpu_torch.utils.config import load_config
    i = {**dict(load_config("train_bc", default_command_line("ldp_agent"))
                .agent["idm_net"]), **variant}
    return MLPDiffusion(S, A, i.get("time_dim", 64),
                        tuple(i.get("cond_hidden_dims", (128, 128))),
                        i.get("cond_activation", "swish"),
                        i.get("n_blocks", 3), i.get("hidden_dim", 256),
                        i.get("use_layer_norm", True), i.get("dropout_rate"),
                        i.get("learnable_time", True),
                        torch.Generator().manual_seed(5)).to(device)


def phase_options_kernels(smoke: Smoke):
    """Kernel B with fp32 weights (``fused_dtype: float32``) at every call
    the four default agents make (DDPM-100, YAML widths, 256 samples; LDP-
    hier's planner at the window's 16 latents in the wide mode) and at the
    bench planner, DDIM-10 over 1024 samples: each against its fp32 twin
    (1e-3 after DDPM-100, 2e-4 after DDIM-10), timed beside it and beside
    its first design's time, with its bound (three TF32 passes) and launch
    geometry; at the default LDP planner it must be faster than its twin.
    Kernel B at the default DP's condition at ``obs_horizon=3`` (3099 wide,
    the prologue walking it in chunks) in bf16 against the rounding twin by
    phase B's statistics, and in fp32 against the fp32 twin. Kernel B with
    fp16 weights at every default call (``_fp16_call``): against its fp16
    rounding twin, timed beside it and beside the bf16 instance; then
    ``_fp16_rounding_points``. Kernel A on the default LDP IDM with
    the upstream recipe's mish, with no LayerNorm, with fixed time features
    and at hidden 48 and 512, 4096 rows DDPM-100, each within 1e-3 of its
    fp32 twin. Then the shapes the JAX package's Pallas kernels take that
    the CUDA kernels once refused (``_kernel_shapes``)."""
    import torch
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA)
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    from latent_diffusion_planning_tpu_torch.utils.precision import fp32_math

    dev = torch.device("cuda")
    f32 = torch.float32
    agents = default_agents(dev)
    out: dict = {}
    g = torch.Generator(device=dev).manual_seed(41)

    def inputs(net, B, T, S):
        cond = torch.randn(B, net.global_cond_dim, generator=g, device=dev)
        x0 = torch.randn(B, T, net.input_dim, generator=g, device=dev)
        noise = torch.randn(S, B, T, net.input_dim, generator=g, device=dev)
        return cond, x0, noise

    for key, (name, net, sched, T, B) in default_unets(agents).items():
        ts, coefs = dlib.ddpm_coef_table(sched.to("cpu"))
        table = (ts.to(dev, torch.int32), coefs.to(dev))
        cond, x0, noise = inputs(net, B, T, len(ts))
        packed = KB.pack_params(net, f32).to(dev)
        what = (f"{key} fp32 {list(net.down_dims)} B={B} T={T}"
                f"{'' if net.downsample else ' no-downsample'}, DDPM-100")
        rec = _fp32_against_twin(smoke, what, net, cond, x0, noise, table,
                                 packed)
        rec.update(_time_unet_fp32(smoke, what, net, cond, x0, noise, table,
                                   packed, f"{key} fp32"))
        out[f"{key} fp32"] = rec
        if key == "B ldp planner" and rec["ms"] >= rec["plain_ms"]:
            raise AssertionError(
                f"{what}: the fp32 kernel ({rec['ms']:.1f} ms) is not faster "
                f"than its fp32 twin ({rec['plain_ms']:.1f} ms)")
        out[f"{key} fp16"] = _fp16_call(smoke, key, net, cond, x0, noise,
                                        table)
    out["B fp16 rounding points"] = _fp16_rounding_points(smoke, g)
    out["B bf16 ldp planner unchanged"] = _bf16_planner_unchanged(smoke)

    # the bench planner, DDIM-10 over 1024 samples (phase B's net)
    p = configs.BENCH_AGENT["planner"]
    net = ConditionalUnet1D(25, 25, p["diffusion_step_embed_dim"],
                            tuple(p["down_dims"]), p["kernel_size"],
                            p["n_groups"],
                            generator=torch.Generator().manual_seed(3)).to(dev)
    ts, coefs = dlib.ddim_coef_table(dlib.DiffusionSchedule.create(50), 10)
    table = (ts.to(dev, torch.int32), coefs.to(dev))
    cond, x0, _ = inputs(net, 1024, 8, 1)
    packed = KB.pack_params(net, f32).to(dev)
    what = f"B bench planner fp32 {list(net.down_dims)} B=1024 T=8, DDIM-10"
    rec = _fp32_against_twin(smoke, what, net, cond, x0, None, table, packed,
                             tol=2e-4)
    rec.update(_time_unet_fp32(smoke, what, net, cond, x0, None, table,
                               packed, "B bench planner fp32"))
    out["B bench planner fp32"] = rec

    # the default DP at obs_horizon=3: a 3099-wide condition, both types
    dp3 = options_dp_agent(dev)
    net = dp3.planner
    if net.global_cond_dim != 3099:
        raise AssertionError(f"DP at obs_horizon 3: {net.global_cond_dim}")
    ts, coefs = dlib.ddpm_coef_table(dp3.sched.to("cpu"))
    table = (ts.to(dev, torch.int32), coefs.to(dev))
    cond, x0, noise = inputs(net, DEF_EVAL_ENVS, 16, len(ts))
    what = f"B dp 3099 bf16 [256,512,1024] B={DEF_EVAL_ENVS} T=16, DDPM-100"
    packed = KB.pack_params(net).to(dev)
    rec = _ddpm_against_twin(smoke, what, net, cond, x0, noise, table, packed)
    twin = KB.rounding_twin(net)
    run_k = lambda: KB.fused_unet1d_ddim_sample(net, cond, x0, *table, noise,
                                                packed=packed)
    run_p = lambda: KB.unet1d_ddim_sample_plain(twin, cond, x0, *table, 1.0,
                                                noise)
    ms, plain_ms = time_ms(run_k, iters=1), time_ms(run_p, iters=1, warmup=0)
    smoke.timing(what, ms, plain_ms)
    elem, mm, nbytes = unet_flops_bytes(net, DEF_EVAL_ENVS, 16, len(ts))
    b_ms, b_by = bound(elem, nbytes + noise.numel() * 4, bf16_flops=mm)
    shape = KB.kernel_info(net, DEF_EVAL_ENVS, 16, len(ts))
    info = smoke.shape_line(
        what, unet_entry(-(-shape["samples_per_block"] * 16 // 16), False),
        shape, mm, PEAK_BF16_FLOPS, "bf16 tensor-core", ms)
    out["B dp 3099 bf16"] = dict(rec, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, shape=info)
    what = f"B dp 3099 fp32 [256,512,1024] B={DEF_EVAL_ENVS} T=16, DDPM-100"
    packed = KB.pack_params(net, f32).to(dev)
    rec = _fp32_against_twin(smoke, what, net, cond, x0, noise, table, packed)
    rec.update(_time_unet_fp32(smoke, what, net, cond, x0, noise, table,
                               packed, "B dp 3099 fp32"))
    out["B dp 3099 fp32"] = rec

    # kernel A's variants of the default LDP IDM
    ldp = agents["ldp_agent"]
    ts, coefs = dlib.ddpm_coef_table(ldp.idm_sched.to("cpu"))
    ts, coefs = ts.to(dev, torch.int32), coefs.to(dev)
    N, S, A = OPT_IDM_ROWS, 2 * ldp.config.obs_dim, ldp.config.action_dim
    for key, variant in OPT_IDM_VARIANTS.items():
        net = options_idm(variant, dev, S, A)
        s = torch.randn(N, S, generator=g, device=dev)
        x0 = torch.randn(N, A, generator=g, device=dev)
        noise = torch.randn(len(ts), N, A, generator=g, device=dev)
        packed = KA.pack_params(net).to(dev)
        run_k = lambda: KA.fused_mlp_diffusion_sample(
            net, s, x0, ts, coefs, noise, packed=packed)

        def run_p():
            with fp32_math():
                return KA.mlp_diffusion_sample_plain(net, s, x0, ts, coefs,
                                                     noise)
        got, ref = run_k(), run_p()
        if not (bool(torch.isfinite(got).all()) and got.shape == (N, A)):
            raise AssertionError(f"{key}: output not finite or misshapen")
        what = (f"{key} ({variant}) {N} rows, DDPM-{len(ts)}")
        err = float((got - ref).abs().max())
        smoke.check(f"{what} max_abs_err vs the fp32 twin", err, 1e-3)
        ms, plain_ms = time_ms(run_k, iters=2), time_ms(run_p, iters=1)
        smoke.timing(what, ms, plain_ms)
        products, rest, nbytes = idm_flops_bytes(net, N, S, A, len(ts), True)
        b_ms, b_by = bound(rest, nbytes, fp32_products=products)
        info = KA.kernel_info(net, N, A, S, len(ts))
        shape = smoke.shape_line(what, mlp_entry(net, info["rows_per_block"]),
                                 info, 3 * products, PEAK_TF32_FLOPS,
                                 "TF32 tensor-core", ms)
        print(f"   {what}: bound {b_ms:.4f} ms ({b_by}) [{smoke.card}]",
              flush=True)
        out[key] = dict(max_abs_err=err, tol=1e-3, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, shape=shape)
    out.update(_kernel_shapes(smoke, agents["ldp_agent"], g))
    return out


# kernel A at the shapes the JAX kernel takes: (change to the default LDP
# IDM, rows, S, DDPM-100 or DDIM-10)
SHAPE_IDM = {
    "A hidden 36": (dict(hidden_dim=36), 256, None, False),
    "A hidden 1024": (dict(hidden_dim=1024), 4096, None, True),
    "A hidden 1536": (dict(hidden_dim=1536), 4096, None, True),
    "A [x|s] 1100": ({}, 256, 1100, False),
    "A [x|s] 2048": ({}, 256, 2048, False),
}
# kernel B: (down_dims, downsample, samples, length, weight type, plan
# override), DDIM-10
SHAPE_UNET = {
    "B T=160": ((64, 128, 256), True, 16, 160, "bf16", None),
    "B T=256": ((64, 128, 256), True, 16, 256, "bf16", None),
    "B T=320": ((64, 128, 256), True, 16, 320, "bf16", None),
    "B T=320 fp16": ((64, 128, 256), True, 16, 320, "fp16", None),
    "B T=160 fp32": ((64, 128, 256), True, 16, 160, "fp32", None),
    "B (8,16,32) T=288": ((8, 16, 32), True, 16, 288, "bf16", None),
    "B (8,16,32) T=288 fp16": ((8, 16, 32), True, 16, 288, "fp16", None),
    "B (32,16,16) T=160 fp32": ((32, 16, 16), True, 16, 160, "fp32", None),
    "B (32,16,16)": ((32, 16, 16), True, 256, 8, "bf16", None),
    "B (32,16,16) fp32": ((32, 16, 16), True, 256, 8, "fp32", None),
    "B wide 40 rows": ((64, 128, 256), True, 64, 40, "bf16",
                       dict(nb=1, wide=True)),
    "B [1024,2048,4096] no-downsample 8 rows": (
        (1024, 2048, 4096), False, 4, 8, "bf16", None),
    "B [1024,2048,4096] 32 rows": (
        (1024, 2048, 4096), True, 4, 32, "bf16", None),
}
# the entries whose plan is the ordinary mode with rows past its instance's
# (the row groups with their buffers in shared memory)
ORDINARY_ROW_GROUPS = ("B (8,16,32) T=288", "B (8,16,32) T=288 fp16",
                       "B (32,16,16) T=160 fp32")


def _kernel_shapes(smoke: Smoke, ldp, g) -> dict:
    """Each route the CUDA kernels gained for a shape the JAX package's
    Pallas kernels take, launched on the card and held against its plain
    twin, with its plan, time and bound printed. Kernel A on the default
    LDP IDM at hidden 36 (not a multiple of 8), 1024 (16 rows a block, the
    4H layer in 16 passes) and 1536 (ring stages of 8 K-rows; 4096 rows
    DDPM-100, 1e-3) and with 1100- and 2048-wide ``[x|s]`` rows (walked in
    chunks; DDIM-10, 2e-4). Kernel B (the bench planner's embedding width,
    25 channels, DDIM-10) at plans of 160, 256 and 320 steps (one sample a
    block, 16 row tiles; 320 in row groups, in bf16 and fp16) and of 160 in
    fp32 (past its 128 rows, in groups), in the ordinary mode's row groups
    (``ORDINARY_ROW_GROUPS``: 288 steps on down_dims (8, 16, 32) in bf16
    and fp16, 160 on (32, 16, 16) in fp32, each checked to plan so), on
    down_dims (32, 16, 16) (an up
    block without a projection reading its skip in fp32) in bf16 and fp32,
    in the wide mode at 40 rows, and on a [1024,2048,4096] planner, whose
    bf16 operands the plan puts in global memory (at 8 rows without
    downsampling, LDP-hier's topology, and at 32 with): bf16 and fp16 by
    phase B's statistics against their rounding twins, fp32 within 2e-4 of
    the fp32 twin."""
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_mlp as KA)
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as KB)
    from latent_diffusion_planning_tpu_torch.utils.precision import fp32_math
    dev = torch.device("cuda")
    out: dict = {}
    A = ldp.config.action_dim
    for key, (variant, N, S, ddpm) in SHAPE_IDM.items():
        S = S or 2 * ldp.config.obs_dim
        sched = ldp.idm_sched.to("cpu")
        ts, coefs = (dlib.ddpm_coef_table(sched) if ddpm
                     else dlib.ddim_coef_table(sched, 10))
        ts, coefs = ts.to(dev, torch.int32), coefs.to(dev)
        net = options_idm(variant, dev, S, A)
        s = torch.randn(N, S, generator=g, device=dev)
        x0 = torch.randn(N, A, generator=g, device=dev)
        noise = (torch.randn(len(ts), N, A, generator=g, device=dev)
                 if ddpm else None)
        packed = KA.pack_params(net).to(dev)
        run_k = lambda: KA.fused_mlp_diffusion_sample(
            net, s, x0, ts, coefs, noise, packed=packed)

        def run_p():
            with fp32_math():
                return KA.mlp_diffusion_sample_plain(net, s, x0, ts, coefs,
                                                     noise)
        info = KA.kernel_info(net, N, A, S, len(ts))
        what = (f"{key} ({variant or 'default'}, S={S}) {N} rows, "
                f"{'DDPM' if ddpm else 'DDIM'}-{len(ts)}")
        print(f"   {what}: plan: {info['rows_per_block']} rows a block, "
              f"hidden padded to {info['hidden_padded']}, {info['passes']} "
              f"passes over the 4H layer, [x|s] "
              f"{'in chunks' if info['chunked'] else 'whole'}, ring "
              f"{info['ring_stages']} stages, grid {info['grid']}",
              flush=True)
        got, ref = run_k(), run_p()
        if not (bool(torch.isfinite(got).all()) and got.shape == (N, A)):
            raise AssertionError(f"{key}: output not finite or misshapen")
        tol = 1e-3 if ddpm else 2e-4
        err = float((got - ref).abs().max())
        smoke.check(f"{what} max_abs_err vs the fp32 twin", err, tol)
        ms, plain_ms = time_ms(run_k, iters=2), time_ms(run_p, iters=1)
        smoke.timing(what, ms, plain_ms)
        products, rest, nbytes = idm_flops_bytes(net, N, S, A, len(ts), ddpm)
        b_ms, b_by = bound(rest, nbytes, fp32_products=products)
        shape = smoke.shape_line(
            what, mlp_entry(net, info["rows_per_block"], info["chunked"]),
            info, 3 * products, PEAK_TF32_FLOPS, "TF32 tensor-core", ms)
        print(f"   {what}: bound {b_ms:.4f} ms ({b_by}) [{smoke.card}]",
              flush=True)
        out[key] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, shape=shape,
                        source="latent_diffusion_planning_tpu_torch/csrc/"
                        "diffusion_mlp.cu")

    ts, coefs = dlib.ddim_coef_table(dlib.DiffusionSchedule.create(50), 10)
    table = (ts.to(dev, torch.int32), coefs.to(dev))
    for key, (dd, down, B, T, wt, plan) in SHAPE_UNET.items():
        net = ConditionalUnet1D(25, 25, 256, dd, 5, 8 if dd[0] > 32 else 4,
                                downsample=down,
                                generator=torch.Generator().manual_seed(3)
                                ).to(dev)
        what = f"{key} {list(dd)} B={B} T={T} {wt}, DDIM-10"
        dtype = {"bf16": torch.bfloat16, "fp16": torch.float16,
                 "fp32": torch.float32}[wt]
        if key in ORDINARY_ROW_GROUPS:
            info = KB.kernel_info(net, B, T, 10, dtype=dtype)
            rows = info["samples_per_block"] * T
            if info["wide"] or rows <= KB.row_group(False, dtype):
                raise AssertionError(
                    f"{what}: planned {'wide' if info['wide'] else ''} at "
                    f"{rows} rows, not the ordinary mode past its "
                    f"{KB.row_group(False, dtype)}")
        if wt in ("bf16", "fp16"):
            info = KB.kernel_info(net, B, T, 10, dtype=dtype, **(plan or {}))
            print(f"   {what}: plan: {info['samples_per_block']} sample(s) "
                  f"a block ({info['samples_per_block'] * T} rows), "
                  f"{'wide' if info['wide'] else 'ordinary'} mode, operands "
                  f"in {'global' if info['operands_global'] else 'shared'} "
                  f"memory (staging window {info['stage_elems']} elements), "
                  f"ring {info['ring_stages']} stages, grid {info['grid']}",
                  flush=True)
            rec = _time_unet(smoke, what, net, B, table, 1.0, g, T, plan,
                             dtype)
            rec["max_abs_err"] = rec["kernel"]["max"]
            rec["source"] = ("latent_diffusion_planning_tpu_torch/csrc/"
                             "diffusion_unet1d"
                             f"{'_f16' if wt == 'fp16' else ''}.cu")
        else:
            cond = torch.randn(B, 25, generator=g, device=dev)
            x0 = torch.randn(B, T, 25, generator=g, device=dev)
            packed = KB.pack_params(net, torch.float32).to(dev)
            rec = _fp32_against_twin(smoke, what, net, cond, x0, None, table,
                                     packed, tol=2e-4)
            rec.update(_time_unet_fp32(smoke, what, net, cond, x0, None,
                                       table, packed, key))
        out[key] = rec
        del net
        torch.cuda.empty_cache()
    return out


def phase_options(smoke: Smoke, device: str = "cuda"):
    """The options' agents from the command line, in a scratch folder under
    the checkout's git-ignored ``build/`` (removed after): demos (128 + 32
    physics envs × 80 steps), the stable VAE with ``OPT_VAE`` (bf16
    compute) for ``DEF_VAE_STEPS`` steps, its loss falling, the demos'
    latents from it; then ``train_bc`` of the default LDP with ``OPT_LDP``
    (kernel B in fp32, kernel A on a mish IDM with dropout, the planner
    training in bf16; ``horizon=17 pred_horizon=16``) and of the default DP
    with ``OPT_DP`` (a 3099-wide condition, the ResNet in bf16), each
    ``DEF_TRAIN_STEPS`` steps at batch 256, losses falling, then
    ``eval_bc`` over ``DEF_EVAL_ENVS`` × ``DEF_EVAL_LEN`` with its launches
    stated before the run (LDP: B, A and C once a decision; DP: B and C),
    and B (A) on the trained nets against their twins (B in fp32 against
    the fp32 twin); and the same for the default LDP with
    ``fused_dtype: float16`` (B in fp16 against its fp16 rounding twin)."""
    import os
    import shutil
    import tempfile
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_options_", dir=build))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out = _drive_defaults(smoke, work, device, OPT_RUNS, OPT_VAE)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    kernel_rec = smoke.record["phases"].get(OPT_KERNEL_PHASE, {})
    out.update({k: v for k, v in kernel_rec.items()
                if k.startswith(("A ", "B "))})
    c_rec = smoke.record["phases"].get(DEF_KERNEL_PHASE, {}).get("C 256")
    if c_rec is not None:
        out["C 256"] = c_rec
    return out


REPLACES = {   # the pl.pallas_call of each TPU kernel
    "diffusion_mlp": ("latent_diffusion_planning_tpu/ops/pallas/"
                      "diffusion_mlp.py:145"),
    "diffusion_unet1d": ("latent_diffusion_planning_tpu/ops/pallas/"
                         "diffusion_unet1d.py:533"),
    "raycast": "latent_diffusion_planning_tpu/ops/pallas/raycast.py:268",
}

# the paths beside the main path whose launches are counted from 0: (phase,
# path, the phase's record of its launches, each kernel's record at the
# path's shapes)
PP_PHASE = "pick_place: Can and Square on the contact engine"
VIDEO_PHASE = "video: the main path's eval with two videos"
AL_PHASE = "aloha: bimanual transfer-cube and insertion, a camera per env"
PATHS = (
    (VIDEO_PHASE, "Lift eval with 2 videos (C: 100 at 1024 scenes, 400 at "
     "the 2 filmed, timed here)", "video_eval",
     {"raycast": "C video", "diffusion_unet1d": "B main",
      "diffusion_mlp": "A main"}),
    (PP_PHASE, "Can eval_bc", "can_eval",
     {"raycast": "C can", "diffusion_unet1d": "B can",
      "diffusion_mlp": "A can"}),
    (PP_PHASE, "Square closed loop", "square_loop",
     {"raycast": "C square", "diffusion_unet1d": "B can",
      "diffusion_mlp": "A can"}),
    (AL_PHASE, "ALOHA transfer-cube eval_bc", "aloha_eval",
     {"raycast": "C aloha cube box", "diffusion_unet1d": "B aloha",
      "diffusion_mlp": "A aloha"}),
    (AL_PHASE, "ALOHA insertion closed loop", "insertion_loop",
     {"raycast": "C aloha insertion", "diffusion_unet1d": "B aloha",
      "diffusion_mlp": "A aloha"}),
    (DEF_PHASE, "default LDP closed loop (DDPM-100)", "ldp_agent loop",
     {"raycast": "C 256", "diffusion_unet1d": "B ldp planner",
      "diffusion_mlp": "A ldp"}),
    (DEF_PHASE, "default LDP-hier closed loop (DDPM-100; B is the planner "
     "and the chunk IDM, timed here at the planner's shape)",
     "ldp_hier_agent loop",
     {"raycast": "C 256", "diffusion_unet1d": "B ldp_hier planner"}),
    (DEF_PHASE, "default LDP-hier sample_plan_stats at 16 latents (B's wide "
     "mode)", "hier_window", {"diffusion_unet1d": "B ldp_hier window (wide)"}),
    (DEF_PHASE, "default DP closed loop (DDPM-100)", "dp_agent loop",
     {"raycast": "C 256", "diffusion_unet1d": "B dp"}),
    (DEF_PHASE, "default DPVAE closed loop (DDPM-100)", "dp_repr_agent loop",
     {"raycast": "C 256", "diffusion_unet1d": "B dp_repr"}),
    (OPT_PHASE, "LDP with fused_dtype float32 and a mish IDM, closed loop "
     "(DDPM-100; B in fp32)", "ldp_options loop",
     {"raycast": "C 256", "diffusion_unet1d": "B ldp planner fp32",
      "diffusion_mlp": "A mish"}),
    (OPT_PHASE, "DP at obs_horizon 3 (a 3099-wide condition), closed loop "
     "(DDPM-100)", "dp_options loop",
     {"raycast": "C 256", "diffusion_unet1d": "B dp 3099 bf16"}),
    (OPT_PHASE, "LDP with fused_dtype float16, closed loop (DDPM-100; B in "
     "fp16)", "ldp_fp16 loop",
     {"raycast": "C 256", "diffusion_unet1d": "B ldp planner fp16",
      "diffusion_mlp": "A ldp"}),
)


def kernel_entries(smoke: Smoke) -> list:
    """The ``kernels`` line: every kernel on the main path, then on each of
    ``PATHS`` (the launches counted on that path, the times at its shapes;
    B's max_abs_err against its rounding twin after the whole process)."""
    def entry(name, k, launches, path):
        err = k["max_abs_err"] if "max_abs_err" in k else k["kernel"]["max"]
        mode = k.get("mode") or (k.get("shape") or {}).get("mode")
        return {"name": name, "path": path, "route": "cuda",
                **({"mode": mode} if mode else {}),
                "source": k.get("source", "latent_diffusion_planning_tpu_"
                                f"torch/csrc/{name}.cu"),
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None}
    out = [entry(name, k, k["launches"], "Lift main path")
           for name, k in smoke.kernels.items()]
    for phase, path, counted, records in PATHS:
        rec = smoke.record["phases"][phase]
        launches = rec[counted]["launches"]
        out += [entry(name, rec[key], launches[name], path)
                for name, key in records.items()]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full record as JSON here")
    ap.add_argument("--only", default=None,
                    help="comma-separated words: run only the phases whose "
                    "names hold one of them (a development run; it prints "
                    "no kernels line)")
    ap.add_argument("--dist-worker", type=Path, default=None,
                    help=argparse.SUPPRESS)   # one rank of phase_dist (b)
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
    if args.dist_worker is not None:
        return dist_worker(args.dist_worker)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    smoke = Smoke(card, args.only.split(",") if args.only else None)

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
            smoke.phase(VIDEO_PHASE, lambda: phase_video(smoke))
            smoke.phase("dist: one dp update and the env-sharded eval at "
                        "world 1 over NCCL, then two ranks over gloo",
                        lambda: phase_dist(smoke))
            smoke.phase("roundtrip: the bench agent through the reference's "
                        "naming and back", lambda: phase_roundtrip(smoke))
            smoke.phase("prefetch: host windows streamed to the card",
                        lambda: phase_prefetch(smoke))
            _training_phases(smoke)
            smoke.phase(DEF_KERNEL_PHASE, lambda: phase_defaults_kernels(smoke))
            smoke.phase(DEF_PHASE, lambda: phase_defaults(smoke))
            smoke.phase(OPT_KERNEL_PHASE, lambda: phase_options_kernels(smoke))
            smoke.phase(OPT_PHASE, lambda: phase_options(smoke))

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {**smoke.record, "kernels": smoke.kernels,
             "failures": smoke.failures}, indent=1, default=str))
    if smoke.failures:
        print(f"FAILED phases: {smoke.failures}", file=sys.stderr)
        return 1
    if smoke.only:
        print(f"development run of {smoke.only}: phases passed", flush=True)
        return 0

    print(json.dumps({"kernels": kernel_entries(smoke)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
