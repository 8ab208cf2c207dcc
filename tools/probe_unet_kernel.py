#!/usr/bin/env python
"""Where kernel B's time goes: time it with parts of it switched off.

    python3 tools/probe_unet_kernel.py            # on a machine with the card

Each variant is a scratch copy of ``csrc/`` (under git-ignored ``build/``)
with a few lines patched out, built and timed in its own process at the
bench shape (1024 samples, widths [64,128,256], DDIM-10). The results of a
patched kernel are wrong by construction; only its time is read. Variants:

  full        the kernel as committed
  nomma       no B-fragment loads, no ldmatrix, no mma (the ring still runs)
  ldonly      the loads, but an xor in place of each mma
  noldm       the mma on whatever the registers hold: no ldmatrix
  nobload     constants in place of the B fragments read from the ring
  noraddr     no tap row maps (every tap reads row 0)
  noepi       no epilogue stores
  noelem      GroupNorm/Mish/FiLM passes return at once
  nostream    the ring starts no copies
  rows8a+rows8b  always the instance with 8 row tiles a warp (the launch
              picks 2, 4 or 8 by the rows a block holds; the bench shape
              takes 4)
  and the combinations named with ``+``.

Prints one JSON line per variant: {"variant": ..., "ms": ..., "card": ...}.
The ``full`` variant also prints the unpatched kernel's time for 8 samples
(one block of 8) and for 1024 (128 such blocks) at 1 and 10 steps, and the
host time to enqueue one call with the timestep table on the host (a
pageable copy that waits for the stream) and on the device: how the time
scales says what the kernel waits for.

    python3 tools/probe_unet_kernel.py --fp32 [window]   # kernel B in fp32

times the fp32 instance (``dtype=torch.float32``, ``diffusion_unet1d_f32.cu``)
at the default LDP planner (256 samples, widths [256,512,1024], T 16,
DDPM-100; ``window``: LDP-hier's planner at its window's 16 latents, the
same widths without downsampling), each variant built from a copy of
``csrc/`` that holds only that source (and ``errors.cu``), all builds
started together:

  f32           the kernel as committed
  f32nomath     the stream alone: the ring and its barriers run, no B or A
                fragment is read and no product is taken
  f32nostream   the math on a resident tile: the ring refills nothing
  f32nosync     no block-wide barrier per ring stage (``WeightRing``, where
                the main kernel streams through it; ``SliceTiles`` has
                none to remove)
  f32nostream+f32nosync  the math alone
  f32noelem     GroupNorm/Mish/FiLM passes return at once

Each prints {"variant", "ms", "card", "plan", "ptxas"}: the plan is the
launch as ``kernel_info`` gives it (samples a block, grid, waves, ring
stages, bytes to the SMs), ``barriers_per_block`` the ring's block-wide
barriers a call (tiles a step times steps, one a stage, where the ring has
them) and ``ptxas`` the registers and spills of the build. ``f32`` also prints the time at 1, 66, 132 and 256 samples over 10
steps (below, at and over one wave of blocks). Run it from a tree's root to
probe that tree; a variant whose patch finds no anchor in the tree's source
prints "skipped".

    python3 tools/probe_unet_kernel.py --plans    # fp32 plans side by side

times the unpatched fp32 instance at the default LDP planner (as above) under
each of ``F32_PLANS`` (samples a block, wide mode) and under the plan
``choose_tile`` picks, each held against the fp32 twin (1e-3 after
DDPM-100), then the bench planner (1024 samples, [64,128,256], T 8, DDIM-10)
under its chosen plan and at four samples a block (2e-4).

    python3 tools/probe_unet_kernel.py --turns OTHER_TREE

compares this tree's kernel B with another checkout's (say the parent
commit unpacked under ``build/``), in turns in one run (other, this, this,
other), each turn a process that builds its tree's kernel B (both weight
types) and runs ``--time-calls``: fp32 and bf16 at the default LDP planner
(DDPM-100) and at the bench planner (DDIM-10), the kernel's time and the
SHA-256 of its output (bf16 outputs are compared bit for bit). Then the
SASS of each main-kernel instance in the two trees' objects (``cuobjdump
-sass``), matched by weight type, row tiles and mode (an instance that walks
rows in groups has no counterpart in a tree without them): one JSON line an
instance with its instruction count in each tree and whether the
instructions (operands included) and the opcodes alone are the same.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
VARIANTS = ("full", "nomma", "ldonly", "noldm", "nobload", "noraddr", "noepi",
            "noelem", "nostream", "nomma+noelem+nostream", "rows8a+rows8b")

PATCHES = {
    "nobload": ("unet1d.cuh",
                "            bq[j] = *reinterpret_cast<const uint4*>("
                "tile + j * kTileBytes);",
                "            bq[j] = make_uint4(j + lane, j, lane, warp);"),
    "noraddr": ("unet1d.cuh",
                "          const int sr = src_row(g.mode, mt * 16 + (lane & 15),"
                " g.rows, g.Tin,\n"
                "                                 g.Tout, tap, pad);",
                "          const int sr = (mt * 16 + (lane & 15)) < g.rows"
                " ? 0 : -1;"),
    "noepi": ("unet1d.cuh",
              "        if (r < g.rows) {\n#pragma unroll\n"
              "          for (int e = 0; e < 2; ++e) {",
              "        if (r < g.rows && acc[mt][0] == 12345.f) {\n"
              "#pragma unroll\n          for (int e = 0; e < 2; ++e) {"),
    "nomma": ("unet1d.cuh", "        uint4 bq[kChunk];\n",
              "        kt += n; continue;\n        uint4 bq[kChunk];\n"),
    "ldonly": ("unet1d.cuh",
               "                ldp::mma_bf16(p0, a[j][0], bq[j].x, bq[j].y);\n"
               "                ldp::mma_bf16(p1, a[j][1], bq[j].z, bq[j].w);\n",
               "                p0[0] += __uint_as_float(a[j][0][0] ^ a[j][0][1]"
               " ^ a[j][0][2] ^ a[j][0][3] ^ bq[j].x ^ bq[j].y);\n"
               "                p1[0] += __uint_as_float(a[j][1][0] ^ a[j][1][1]"
               " ^ a[j][1][2] ^ a[j][1][3] ^ bq[j].z ^ bq[j].w);\n"),
    "noldm": ("unet1d.cuh",
              "                ldp::ldmatrix_x4(a[j][0], ad + (on ? 64u * j : 0u));\n"
              "                ldp::ldmatrix_x4(a[j][1], "
              "ad + (on ? 64u * j + 32u : 0u));\n",
              "                for (int e = 0; e < 4; ++e) "
              "a[j][0][e] = a[j][1][e] = ad + j + e;\n"),
    "noelem": ("unet1d.cuh",
               "  const int Cg = C / G, n = Tl * Cg;\n",
               "  __syncthreads(); return;\n  const int Cg = C / G, n = Tl * Cg;\n"),
    "nostream": ("stream.cuh", "    if (left > 0) {", "    if (false) {"),
    "rows8a": ("unet1d.cuh", "  if (mt <= 2)\n", "  if (mt < 0)\n"),
    "rows8b": ("unet1d.cuh", "  if (mt <= 4)\n", "  if (mt < 0)\n"),
}


# fp32 variants: each part lists its patch for every source it knows (the
# parent's WeightRing and the thread-private ring); the first applies whose
# anchors are all there
F32_VARIANTS = ("f32", "f32nomath", "f32nostream", "f32nosync",
                "f32nostream+f32nosync", "f32noelem")
F32_SOURCES = ("diffusion_unet1d_f32.cu", "errors.cu")
UNET_SOURCES = F32_SOURCES + ("diffusion_unet1d.cu",)
F32_PATCHES = {   # part -> alternatives, each [(file, anchor, text), ...]
    "f32nomath": [
        [("unet1d.cuh",
          "        const float* tile = reinterpret_cast<const float*>("
          "tiles.take(1))\n            + warp * 256 + lane * 4;\n",
          "        const float* tile = reinterpret_cast<const float*>("
          "tiles.take(1))\n            + warp * 256 + lane * 4;\n"
          "        if (kt >= 0) continue;\n")],
        [("unet1d.cuh",
          "        const float* tile = tiles.tile() + warp * 256 + lane * 4;\n",
          "        const float* tile = tiles.tile() + warp * 256 + lane * 4;\n"
          "        if (kt >= 0) { tiles.release(); continue; }\n"),
         ("unet1d.cuh",
          "        const float* tile = tiles.tile() + kh * 128 + lane * 4;\n",
          "        const float* tile = tiles.tile() + kh * 128 + lane * 4;\n"
          "        if (kt >= 0) { tiles.release(); continue; }\n")]],
    "f32nostream": [   # the thread-private ring and the prologue's
        [("unet1d.cuh", "    if (left > 0) {", "    if (false) {"),
         ("stream.cuh", "    if (left > 0) {", "    if (false) {")],
        [("stream.cuh", "    if (left > 0) {", "    if (false) {")]],
    "f32nosync": [
        [("stream.cuh",
          "    cp_async_wait_pending(stages - 2);\n    __syncthreads();\n",
          "    cp_async_wait_pending(stages - 2);\n")]],
    "f32noelem": [
        [("unet1d.cuh", "  const int Cg = C / G, n = Tl * Cg;\n",
          "  __syncthreads(); return;\n  const int Cg = C / G, n = Tl * Cg;\n")]],
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def prepare(variant: str) -> bool:
    """Point the build at a patched copy of ``csrc/`` for ``variant`` (fp32
    variants: only the fp32 source). False for an fp32 variant whose part
    the source has nothing to patch for."""
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build

    dst = REPO / "build" / f"probe_csrc_{variant}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(REPO / "latent_diffusion_planning_tpu_torch" / "csrc", dst)
    fp32 = variant.startswith("f32")
    if fp32 or variant == "unet":
        keep = F32_SOURCES if fp32 else UNET_SOURCES
        for src in dst.glob("*.cu"):
            if src.name not in keep:
                src.unlink()
    for part in variant.split("+"):
        if part in ("full", "f32", "unet"):
            continue
        if part == "f32nosync" and "SliceTiles" in (dst / "unet1d.cuh"
                                                    ).read_text():
            return False        # the main kernel's ring has no barrier
        alternatives = F32_PATCHES[part] if fp32 else [[PATCHES[part]]]
        for edits in alternatives:
            texts = {name: (dst / name).read_text()
                     for name in {e[0] for e in edits} if (dst / name).exists()}
            if all(name in texts and old in texts[name]
                   for name, old, _ in edits):
                for name, old, new in edits:
                    texts[name] = texts[name].replace(old, new)
                for name, text in texts.items():
                    (dst / name).write_text(text)
                break
        else:
            if fp32:
                return False
            raise SystemExit(f"{part}: the source has none of its anchors")
    _build.CSRC = dst
    _build.BUILD_DIR = REPO / "build" / f"probe_out_{variant}"
    return True


def run_variant(variant: str) -> None:
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib

    if not prepare(variant):
        print(json.dumps({"variant": variant, "skipped": "nothing in this "
                          "tree's source to patch"}), flush=True)
        return
    if variant.startswith("f32"):
        run_f32(variant)
        return
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)

    dev = torch.device("cuda")
    ts, coefs = dlib.ddim_coef_table(dlib.DiffusionSchedule.create(50), 10)
    coefs = coefs.to(dev)
    torch.manual_seed(3)
    net = ConditionalUnet1D(25, 25, 256, (64, 128, 256), 5, 8).to(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    gc = torch.randn(1024, 25, generator=g, device=dev)
    x0 = torch.randn(1024, 8, 25, generator=g, device=dev)
    packed = K.pack_params(net).to(dev)
    run = lambda: K.fused_unet1d_ddim_sample(net, gc, x0, ts, coefs,
                                             packed=packed)
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        run()
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"variant": variant, "ms": start.elapsed_time(end) / 5,
                      "card": card()}), flush=True)
    if variant == "full":
        scaling(K, net, ts, coefs, packed, g, dev)


def scaling(K, net, ts, coefs, packed, g, dev) -> None:
    import time

    import torch

    def timed(fn, iters=5):
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

    out = {}
    for B in (8, 1024):
        gc = torch.randn(B, 25, generator=g, device=dev)
        x0 = torch.randn(B, 8, 25, generator=g, device=dev)
        for n in (1, 10):
            out[f"samples {B}, steps {n}"] = timed(
                lambda: K.fused_unet1d_ddim_sample(
                    net, gc, x0, ts[:n], coefs[:n], packed=packed, nb=8))
    for where, table in (("host", ts), ("device", ts.to(dev, torch.int32))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            K.fused_unet1d_ddim_sample(net, gc, x0, table, coefs,
                                       packed=packed)
        out[f"host ms to enqueue one call, timesteps on the {where}"] = (
            time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    print(json.dumps({"scaling_ms": out, "card": card()}), flush=True)


def _timed(fn, iters: int = 1) -> float:
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


def run_f32(variant: str) -> None:
    """The fp32 instance at the default LDP planner, DDPM-100."""
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        _build, diffusion_unet1d as K)

    dev, f32 = torch.device("cuda"), torch.float32
    B, T, S = 256, 16, 100
    ts, coefs = dlib.ddpm_coef_table(
        dlib.DiffusionSchedule.create(S, "squaredcos_cap_v2"))
    ts, coefs = ts.to(dev, torch.int32), coefs.to(dev)
    window = os.environ.get("PROBE_SHAPE") == "window"
    net = ConditionalUnet1D(25, 25, 256, (256, 512, 1024), 5, 8, not window,
                            generator=torch.Generator().manual_seed(3)).to(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    gc = torch.randn(B, 25, generator=g, device=dev)
    x0 = torch.randn(B, T, 25, generator=g, device=dev)
    noise = torch.randn(S, B, T, 25, generator=g, device=dev)
    packed = K.pack_params(net, f32).to(dev)
    run = lambda b, n: K.fused_unet1d_ddim_sample(
        net, gc[:b], x0[:b], ts[:n], coefs[:n], noise[:n, :b].contiguous(),
        packed=packed, dtype=f32)
    ms = _timed(lambda: run(B, S))
    plan = K.kernel_info(net, B, T, S, dtype=f32)
    spills = [" ".join(line.split()) for line in
              _build.build_log().splitlines()
              if "spill" in line or "registers" in line]
    tiles = K.layout(net, f32)["stream"]["main"]["n_tiles"]
    barriers = (0 if "SliceTiles" in (_build.CSRC / "unet1d.cuh").read_text()
                else tiles * S)
    print(json.dumps({"variant": variant, "shape": "window" if window
                      else "ldp planner", "ms": ms, "card": card(),
                      "plan": plan, "tiles_per_step": tiles,
                      "barriers_per_block": barriers, "ptxas": spills}),
          flush=True)
    if variant == "f32":
        out = {f"samples {b}, steps 10": _timed(lambda: run(b, 10), 2)
               for b in (1, 66, 132, 256)}
        print(json.dumps({"scaling_ms": out, "card": card()}), flush=True)


# (samples a block, wide mode) at the default LDP planner
F32_PLANS = ((1, False), (2, True))


def run_plans() -> None:
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)
    from latent_diffusion_planning_tpu_torch.utils.precision import fp32_math

    prepare("f32")
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build
    _build.library()
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("   " + line.strip(), flush=True)
    dev, f32 = torch.device("cuda"), torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(4)
    for name, widths, T, B, S in (("ldp planner", (256, 512, 1024), 16, 256,
                                   100),
                                  ("bench planner", (64, 128, 256), 8, 1024,
                                   10)):
        net = ConditionalUnet1D(25, 25, 256, widths, 5, 8,
                                generator=torch.Generator().manual_seed(3)
                                ).to(dev)
        if S == 100:
            ts, coefs = dlib.ddpm_coef_table(
                dlib.DiffusionSchedule.create(S, "squaredcos_cap_v2"))
            noise = torch.randn(S, B, T, 25, generator=g, device=dev)
            tol = 1e-3
        else:
            ts, coefs = dlib.ddim_coef_table(dlib.DiffusionSchedule.create(50),
                                             S)
            noise, tol = None, 2e-4
        ts, coefs = ts.to(dev, torch.int32), coefs.to(dev)
        gc = torch.randn(B, 25, generator=g, device=dev)
        x0 = torch.randn(B, T, 25, generator=g, device=dev)
        packed = K.pack_params(net, f32).to(dev)
        with fp32_math():
            ref = K.unet1d_ddim_sample_plain(net, gc, x0, ts, coefs, 1.0, noise)
        plans = [None] + (list(F32_PLANS) if S == 100 else [(4, False)])
        for plan in plans:
            kw = {} if plan is None else dict(nb=plan[0], wide=plan[1])
            run = lambda: K.fused_unet1d_ddim_sample(
                net, gc, x0, ts, coefs, noise, packed=packed, dtype=f32, **kw)
            err = float((run() - ref).abs().max())
            ms = _timed(run)
            info = K.kernel_info(net, B, T, S, dtype=f32, **kw)
            print(json.dumps({"call": name, "plan": plan or "chosen",
                              "ms": ms, "max_abs_err": err, "tol": tol,
                              "ok": err <= tol, "info": info, "card": card()}),
                  flush=True)


def time_calls() -> None:
    """Kernel B at two calls in both weight types: time and output hash."""
    import hashlib

    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import (
        diffusion_unet1d as K)

    prepare("unet")
    dev = torch.device("cuda")
    for name, widths, T, B, S in (("ldp planner", (256, 512, 1024), 16, 256,
                                   100),
                                  ("bench planner", (64, 128, 256), 8, 1024,
                                   10)):
        # the draws on the CPU's generator, which no torch or CUDA build
        # changes, so the hashes compare across trees and machines
        g = torch.Generator().manual_seed(4)
        net = ConditionalUnet1D(25, 25, 256, widths, 5, 8,
                                generator=torch.Generator().manual_seed(3)
                                ).to(dev)
        if S == 100:
            ts, coefs = dlib.ddpm_coef_table(
                dlib.DiffusionSchedule.create(S, "squaredcos_cap_v2"))
            noise = torch.randn(S, B, T, 25, generator=g).to(dev)
        else:
            ts, coefs = dlib.ddim_coef_table(dlib.DiffusionSchedule.create(50),
                                             S)
            noise = None
        ts, coefs = ts.to(dev, torch.int32), coefs.to(dev)
        gc = torch.randn(B, 25, generator=g).to(dev)
        x0 = torch.randn(B, T, 25, generator=g).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            packed = K.pack_params(net, dt).to(dev)
            run = lambda: K.fused_unet1d_ddim_sample(
                net, gc, x0, ts, coefs, noise, packed=packed, dtype=dt)
            out = run()
            digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
            iters = 1 if S == 100 and dt == torch.float32 else 5
            print(json.dumps({"tree": str(REPO), "call": name,
                              "dtype": str(dt), "ms": _timed(run, iters),
                              "sha256": digest, "card": card()}), flush=True)


def sass(tree: Path) -> dict:
    """The main-kernel instances of a tree's kernel B objects (as ``--turns``
    built them): (weight type, row tiles, wide, groups) -> instructions."""
    cuda_bin = Path("/usr/local/cuda/bin")
    tool = lambda name: shutil.which(name) or str(cuda_bin / name)
    out: dict = {}
    for obj in sorted((tree / "build" / "probe_out_unet").glob(
            "*.d/diffusion_unet1d*.o")):
        text = subprocess.run([tool("cuobjdump"), "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        key = None
        for line in text.splitlines():
            if "Function :" in line:
                name = subprocess.run(
                    [tool("cu++filt"), line.split("Function :")[1].strip()],
                    capture_output=True, text=True).stdout.strip()
                m = re.search(r"unet1d_sampler_kernel<([^,]+), ([^,]+), "
                              r"([^,>]+)(?:, ([^,>]+))?>", name)
                # cu++filt writes a template's int and bool as (int)8 and
                # (bool)0; a tree without row groups has no fourth
                norm = lambda v: {"(bool)0": "false", "(bool)1": "true"}.get(
                    v, v.replace("(int)", "")) if v else "false"
                key = tuple(norm(v) for v in m.groups()) if m else None
                if key:
                    out[key] = []
            elif key and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                out[key].append(line.split("*/", 1)[1].split(";")[0].strip())
    return out


def compare_sass(other: Path) -> None:
    mine, theirs = sass(REPO), sass(other)
    for key in sorted(mine):
        a, b = theirs.get(key), mine[key]
        ops = lambda code: [re.sub(r"^@!?U?P[T0-9]\s+", "", i).split()[0]
                            for i in code]
        print(json.dumps({"instance": list(key), "other_instructions":
                          None if a is None else len(a),
                          "this_instructions": len(b),
                          "same_instructions": a == b,
                          "same_opcodes": a is not None and ops(a) == ops(b)}),
              flush=True)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--plans":
        run_plans()
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--time-calls":
        time_calls()
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--turns":
        other = Path(sys.argv[2]).resolve()
        probe = other / "tools" / Path(__file__).name
        shutil.copy(__file__, probe)     # the other tree runs this probe
        for tree in (other, REPO, REPO, other):
            script = probe if tree == other else Path(__file__)
            rc = subprocess.run([sys.executable, str(script), "--time-calls"],
                                cwd=tree).returncode
            if rc:
                return rc
        compare_sass(other)
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--build":
        from latent_diffusion_planning_tpu_torch.ops.kernels import _build
        if prepare(sys.argv[2]):
            _build.library()
        return 0
    if len(sys.argv) > 1 and sys.argv[1] != "--fp32":
        run_variant(sys.argv[1])
        return 0
    if len(sys.argv) > 1:
        if sys.argv[2:3] == ["window"]:
            os.environ["PROBE_SHAPE"] = "window"
        # every fp32 variant's nvcc at once, then the timings one by one
        builds = [subprocess.Popen([sys.executable, __file__, "--build", v])
                  for v in F32_VARIANTS]
        if any(p.wait() for p in builds):
            return 1
        variants = F32_VARIANTS
    else:
        variants = VARIANTS
    for v in variants:
        rc = subprocess.run([sys.executable, __file__, v]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
