#!/usr/bin/env python
"""``mma.sync`` against ``wgmma`` on one GEMM of kernel B's fp16 grid mode.

    python3 tools/probe_item_gemm_torch.py     # on a machine with the card

Builds ``tools/probe_item_gemm.cu`` (into git-ignored ``build/``) and runs
its two kernels on the default LDP planner's deepest conv2 as the grid mode
splits it (128 items of 64 rows x 128 columns, K = 5 taps x 1024, one item
a block, the weights read through L2 by the 16 row tiles of each column
group): each checked against the fp32 product of the same fp16 inputs,
then timed in alternating turns (mma, wgmma, wgmma, mma; 50 launches a
turn). Prints one JSON line a kernel with its time, its rate against the
fp16 tensor cores' 989 TFLOP/s and its bound (the larger of the products
at that peak and the bytes that must move: X, W and the output once), and
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "tools" / "probe_item_gemm.cu"
PEAK_FP16 = 989e12
HBM = 3.35e12
TILES, ROWS, HALO, CIN, TAPS, N = 16, 64, 4, 1024, 5, 1024


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def build() -> ctypes.CDLL:
    out = REPO / "build" / "probe_item_gemm"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cmd = [nvcc, "-O3", "-gencode", "arch=compute_90a,code=sm_90a",
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(out / "lib.so"), str(SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    print(res.stderr[-3000:], flush=True)
    if res.returncode:
        raise SystemExit("nvcc failed")
    return ctypes.CDLL(str(out / "lib.so"))


def main() -> int:
    import torch
    lib = build()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    X = (0.5 * torch.randn(TILES, ROWS + HALO, CIN, generator=g)).half()
    W = (0.02 * torch.randn(N, TAPS * CIN, generator=g)).half()
    X, W = X.to(dev), W.to(dev)
    ref = sum(X[:, t:t + ROWS].float() @ W[:, t * CIN:(t + 1) * CIN].float().T
              for t in range(TAPS)).reshape(TILES * ROWS, N)
    out = torch.empty(TILES * ROWS, N, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    fns = {name: getattr(lib, f"probe_item_gemm_{name}")
           for name in ("mma", "wgmma")}

    def run(name):
        err = fns[name](ctypes.c_void_p(X.data_ptr()),
                        ctypes.c_void_p(W.data_ptr()),
                        ctypes.c_void_p(out.data_ptr()), stream)
        if err:
            raise SystemExit(f"{name}: launch error {err}")

    checks = {}
    for name in fns:
        out.fill_(float("nan"))
        run(name)
        torch.cuda.synchronize()
        e = (out - ref).abs()
        checks[name] = dict(max_abs_err=float(e.max()),
                            mean_abs_err=float(e.mean()),
                            max_abs_ref=float(ref.abs().max()),
                            ok=bool(torch.isfinite(out).all())
                            and float(e.max()) <= 1e-3 * float(
                                ref.abs().max()))
    turns = {name: [] for name in fns}
    for name in ("mma", "wgmma", "wgmma", "mma"):
        for _ in range(3):
            run(name)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(50):
            run(name)
        b.record()
        torch.cuda.synchronize()
        turns[name].append(a.elapsed_time(b) / 50)
    flops = 2.0 * TILES * ROWS * N * TAPS * CIN
    nbytes = X.numel() * 2 + W.numel() * 2 + out.numel() * 4
    bound = max(flops / PEAK_FP16, nbytes / HBM) * 1e3
    for name in fns:
        ms = min(turns[name])
        print(json.dumps(dict(
            kernel=name, ms=ms, turns_ms=turns[name], bound_ms=bound,
            bound_by="operations" if flops / PEAK_FP16 > nbytes / HBM
            else "bytes", tflops=flops / ms / 1e9,
            share_of_fp16_peak=flops / ms / 1e-3 / PEAK_FP16,
            **checks[name], card=card())), flush=True)
    return 0 if all(c["ok"] for c in checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
