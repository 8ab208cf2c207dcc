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
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
VARIANTS = ("full", "nomma", "ldonly", "noldm", "nobload", "noraddr", "noepi",
            "noelem", "nostream", "nomma+noelem+nostream", "rows8a+rows8b")

PATCHES = {
    "nobload": ("diffusion_unet1d.cu",
                "            bq[j] = *reinterpret_cast<const uint4*>("
                "tile + j * kTileBytes);",
                "            bq[j] = make_uint4(j + lane, j, lane, warp);"),
    "noraddr": ("diffusion_unet1d.cu",
                "          const int sr = src_row(g.mode, mt * 16 + (lane & 15),"
                " g.rows, g.Tin,\n"
                "                                 g.Tout, tap, pad);",
                "          const int sr = (mt * 16 + (lane & 15)) < g.rows"
                " ? 0 : -1;"),
    "noepi": ("diffusion_unet1d.cu",
              "          if (r < g.rows) {\n#pragma unroll\n"
              "            for (int e = 0; e < 2; ++e) {",
              "          if (r < g.rows && acc[mt][0] == 12345.f) {\n"
              "#pragma unroll\n            for (int e = 0; e < 2; ++e) {"),
    "nomma": ("diffusion_unet1d.cu", "        uint4 bq[kChunk];\n",
              "        kt += n; continue;\n        uint4 bq[kChunk];\n"),
    "ldonly": ("diffusion_unet1d.cu",
               "                ldp::mma_bf16(p0, a[j][0], bq[j].x, bq[j].y);\n"
               "                ldp::mma_bf16(p1, a[j][1], bq[j].z, bq[j].w);\n",
               "                p0[0] += __uint_as_float(a[j][0][0] ^ a[j][0][1]"
               " ^ a[j][0][2] ^ a[j][0][3] ^ bq[j].x ^ bq[j].y);\n"
               "                p1[0] += __uint_as_float(a[j][1][0] ^ a[j][1][1]"
               " ^ a[j][1][2] ^ a[j][1][3] ^ bq[j].z ^ bq[j].w);\n"),
    "noldm": ("diffusion_unet1d.cu",
              "                ldp::ldmatrix_x4(a[j][0], ad + (on ? 64u * j : 0u));\n"
              "                ldp::ldmatrix_x4(a[j][1], "
              "ad + (on ? 64u * j + 32u : 0u));\n",
              "                for (int e = 0; e < 4; ++e) "
              "a[j][0][e] = a[j][1][e] = ad + j + e;\n"),
    "noelem": ("diffusion_unet1d.cu",
               "  const int Cg = C / G, n = Tl * Cg;\n",
               "  __syncthreads(); return;\n  const int Cg = C / G, n = Tl * Cg;\n"),
    "nostream": ("stream.cuh", "    if (left > 0) {", "    if (false) {"),
    "rows8a": ("diffusion_unet1d.cu", "  if (mt <= 2)\n", "  if (mt < 0)\n"),
    "rows8b": ("diffusion_unet1d.cu", "  if (mt <= 4)\n", "  if (mt < 0)\n"),
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def run_variant(variant: str) -> None:
    import torch
    from latent_diffusion_planning_tpu_torch.models.nets.unet1d import (
        ConditionalUnet1D)
    from latent_diffusion_planning_tpu_torch.ops import diffusion as dlib
    from latent_diffusion_planning_tpu_torch.ops.kernels import _build

    dst = REPO / "build" / f"probe_csrc_{variant}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC, dst)
    for part in variant.split("+"):
        if part == "full":
            continue
        name, old, new = PATCHES[part]
        text = (dst / name).read_text()
        if old not in text:
            raise SystemExit(f"{part}: the source no longer has its anchor")
        (dst / name).write_text(text.replace(old, new))
    _build.CSRC = dst
    _build.BUILD_DIR = REPO / "build" / f"probe_out_{variant}"
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


def main() -> int:
    if len(sys.argv) > 1:
        run_variant(sys.argv[1])
        return 0
    for v in VARIANTS:
        rc = subprocess.run([sys.executable, __file__, v]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
