#!/usr/bin/env python
"""Where kernel B's fp16 grid mode spends its time, and what it gives.

    python3 tools/probe_grid_torch.py [--variants full,nomath,...]
        [--calls]                          # on a machine with the card

Each variant is a scratch copy of ``csrc/`` (under git-ignored
``build/probe_grid/``) holding the fp16 source with a few lines patched
out, all built at once, then timed in this process at the default LDP
planner (256 plans of 16, widths [256,512,1024], DDPM-100) in the grid
mode. A patched kernel's results are wrong by construction; only its time
is read. Variants:

  full       the kernel as committed
  nomath     no products: each item stages its input, starts its ring and
             drains it, and skips the GEMM (the phases' fixed costs)
  nostage    no copy of an item's input rows into the window
  nostream   the ring copies only its first two stages of each stripe
  nomma      the GEMM walks the ring but loads no B fragment, runs no
             ldmatrix and no mma
  noelem     the GroupNorm passes return at once
  nostats    no GroupNorm statistics in the items

``--calls`` first times, with the committed kernel, the six default
calls of kernel B (``chip_smoke.default_unets``) in the grid mode, the
ordinary fp16 mode, the ordinary fp16 program at 8 samples a block with
its buffers in global memory (the wide mode) where that fits (plans of 4:
the wide mode takes 32 rows a block), and bf16, in alternating turns, and
the bench planner (1024 samples, DDIM-10) in both fp16 modes. One JSON
line a measurement, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

GRID = "unet1d_grid.cuh"
PATCHES = {
    "full": [],
    "nomath": [(GRID, "      gemm<kGridMt>(v, tiles, cx.zero_addr);\n"
                "      tiles.ring.drain();", "      tiles.ring.drain();")],
    "nostage": [(GRID, "    ldp::cp_async16(ldp::smem_u32(win + r * ldw + "
                 "8 * q),", "    if (r < 0) ldp::cp_async16(ldp::smem_u32("
                 "win + r * ldw + 8 * q),")],
    "nostream": [("stream.cuh", "    if (left > 0) {\n      const char* s = "
                  "src", "    if (left > 0 && src_stage < 2) {\n      const "
                  "char* s = src")],
    "nomma": [("unet1d.cuh", "          uint4 bq[kCh];\n",
               "          kt += n; continue;\n          uint4 bq[kCh];\n")],
    "noelem": [(GRID, "  if (rlo >= rhi) return;   // block-uniform",
                "  if (rlo >= 0) return;")],
    "nostats": [(GRID, "    if (gn_ch > 0) {\n      // the item's pairs",
                 "    if (gn_ch < 0) {\n      // the item's pairs")],
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def build(names: list[str]) -> dict:
    """Every variant's library, built at once: name -> path."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build
    root = REPO / "build" / "probe_grid"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for n in names:
        d = root / n
        shutil.copytree(_build.CSRC, d / "csrc")
        for f, a, b in PATCHES[n]:
            text = (d / "csrc" / f).read_text()
            if a not in text:
                raise SystemExit(f"{n}: no anchor in {f}")
            (d / "csrc" / f).write_text(text.replace(a, b))
        objs, cmds = [], []
        for src in ("diffusion_unet1d_f16.cu", "errors.cu"):
            o = d / (src + ".o")
            objs.append(str(o))
            cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                         str(d / "csrc" / src), "-o", str(o)])
        cmds.append([_build._nvcc(), "-shared", "-o", str(d / "lib.so"),
                     *objs])
        script = " && ".join(" ".join(f"'{x}'" for x in c) for c in cmds)
        procs[n] = (subprocess.Popen(script, shell=True, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), d)
    out = {}
    for n, (p, d) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"{n}: build failed\n{log[-3000:]}")
        out[n] = d / "lib.so"
    return out


def timed(fn, n: int = 2) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def variants(names: list[str]) -> None:
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)
    t0 = time.time()
    libs = build(names)
    print(json.dumps({"built_s": time.time() - t0}), flush=True)
    dev, f16 = torch.device("cuda"), torch.float16
    net = ConditionalUnet1D(25, 25, 256, (256, 512, 1024), 5, 8,
                            generator=torch.Generator().manual_seed(3)).to(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    ts, coefs = dlib.ddpm_coef_table(
        dlib.DiffusionSchedule.create(100, "squaredcos_cap_v2"))
    noise = torch.randn(100, 256, 16, 25, generator=g, device=dev)
    gc = torch.randn(256, 25, generator=g, device=dev)
    x0 = torch.randn(256, 16, 25, generator=g, device=dev)
    ts, coefs = ts.to(dev, torch.int32), coefs.to(dev)
    packed = K.pack_params(net, f16).to(dev)
    for n, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.ldp_error_string.argtypes = [ctypes.c_int]
        lib.ldp_error_string.restype = ctypes.c_char_p
        _build.library = lambda lib=lib: lib
        ms = timed(lambda: K.fused_unet1d_ddim_sample(
            net, gc, x0, ts, coefs, noise, packed=packed, dtype=f16,
            grid=True))
        print(json.dumps({"variant": n, "ms": ms, "card": card()}),
              flush=True)


def calls() -> None:
    import torch
    import chip_smoke
    from latent_diffusion_planning_tpu_torch import configs
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)
    dev, f16 = torch.device("cuda"), torch.float16
    g = torch.Generator(device=dev).manual_seed(41)
    agents = chip_smoke.default_agents(dev)
    for key, (_, net, sched, T, B) in chip_smoke.default_unets(
            agents).items():
        ts, coefs = dlib.ddpm_coef_table(sched.to("cpu"))
        table = (ts.to(dev, torch.int32), coefs.to(dev))
        cond = torch.randn(B, net.global_cond_dim, generator=g, device=dev)
        x0 = torch.randn(B, T, net.input_dim, generator=g, device=dev)
        noise = torch.randn(len(ts), B, T, net.input_dim, generator=g,
                            device=dev)
        p16, pb = K.pack_params(net, f16).to(dev), K.pack_params(net).to(dev)
        runs = {"grid": lambda: K.fused_unet1d_ddim_sample(
                    net, cond, x0, *table, noise, packed=p16, dtype=f16,
                    grid=True),
                "fp16 ordinary": lambda: K.fused_unet1d_ddim_sample(
                    net, cond, x0, *table, noise, packed=p16, dtype=f16,
                    grid=False),
                "bf16": lambda: K.fused_unet1d_ddim_sample(
                    net, cond, x0, *table, noise, packed=pb)}
        if any(nb == 8 and prog["wide"]
               for nb, prog in K._fits(net, T, f16, every_mode=True)):
            runs["fp16 nb=8 wide"] = lambda: K.fused_unet1d_ddim_sample(
                net, cond, x0, *table, noise, packed=p16, dtype=f16,
                nb=8, wide=True)
        turns = {k: [] for k in runs}
        for _ in range(2):
            for k, fn in runs.items():
                turns[k].append(timed(fn, 1))
        print(json.dumps({"call": key, "ms": turns,
                          "chosen": "grid" if K.choose_grid(
                              net, T, B, f16) else "ordinary",
                          "card": card()}), flush=True)
    p = configs.BENCH_AGENT["planner"]
    net = ConditionalUnet1D(25, 25, p["diffusion_step_embed_dim"],
                            tuple(p["down_dims"]), p["kernel_size"],
                            p["n_groups"],
                            generator=torch.Generator().manual_seed(3)).to(dev)
    ts, coefs = dlib.ddim_coef_table(dlib.DiffusionSchedule.create(50), 10)
    table = (ts.to(dev, torch.int32), coefs.to(dev))
    cond = torch.randn(1024, 25, generator=g, device=dev)
    x0 = torch.randn(1024, 8, 25, generator=g, device=dev)
    p16 = K.pack_params(net, f16).to(dev)
    turns = {"grid": [], "fp16 ordinary": []}
    for _ in range(2):
        for k, grid in (("grid", True), ("fp16 ordinary", False)):
            turns[k].append(timed(lambda: K.fused_unet1d_ddim_sample(
                net, cond, x0, *table, packed=p16, dtype=f16, grid=grid), 3))
    print(json.dumps({"call": "bench planner", "ms": turns, "card": card()}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="full,nomath,nostage,nostream,"
                    "nomma,noelem,nostats")
    ap.add_argument("--calls", action="store_true")
    args = ap.parse_args()
    if args.calls:      # the committed kernels first: the variants swap
        calls()         # the library out
    names = [n for n in args.variants.split(",") if n]
    if names:
        variants(names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
