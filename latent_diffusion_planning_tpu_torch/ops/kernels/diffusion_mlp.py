"""Fused reverse-diffusion sampler for the MLP IDM: CUDA kernel + plain twin.

Replaces the TPU kernel ``latent_diffusion_planning_tpu/ops/pallas/
diffusion_mlp.py`` (``fused_mlp_diffusion_sample`` → ``_sampler_kernel``).
The kernel (``csrc/diffusion_mlp.cu``) runs the whole DDPM/DDIM reverse
process of ``MLPDiffusion`` in one launch, in fp32. It is bound by fp32 FMAs
on the CUDA cores (about 3.2 MFLOP per row and step at the bench widths);
its design keeps a 64-row tile's activations in shared memory for all steps
and reads the weights (6.6 MB) from L2, each read feeding 64 rows (see the
source's note).

The caller supplies the initial sample, every step's noise (None for DDIM)
and the (T, 5) coefficient table from ``ops.diffusion``, so kernel and twin
consume identical draws.
"""

from __future__ import annotations

import torch

from ...models.nets.mlp import MLPDiffusion
from .. import diffusion as dlib
from . import _build

ROWS_CHOICES = (64, 32)
SMEM_LIMIT = 232448     # bytes of shared memory one block may use on H100


def check_supported(net: MLPDiffusion) -> None:
    """Raise ValueError, with the reason, for a net the kernel cannot run."""
    if not net.learnable_time or net.time.kernel.shape[1] != 1:
        raise ValueError("kernel needs learnable scalar Fourier time features")
    if net.cond_activation != "swish":
        raise ValueError("kernel hardcodes cond_activation='swish', net has "
                         f"{net.cond_activation!r}")
    if len(net.cond.dense) != 2:
        raise ValueError("kernel needs a two-layer cond MLP")
    if not net.use_layer_norm:
        raise ValueError("kernel requires use_layer_norm=True")
    H = net.trunk.dense0.out_features
    if H % 32 or not 32 <= H <= 256:
        raise ValueError(f"kernel needs hidden_dim a multiple of 32 in "
                         f"[32, 256], net has {H}")


def pack_params(net: MLPDiffusion) -> torch.Tensor:
    """The net's weights in the kernel's order, Dense kernels as (in, out)."""
    check_supported(net)
    io = lambda lin: [lin.weight.t(), lin.bias]
    parts = [net.time.kernel[:, 0], *io(net.cond.dense[0]),
             *io(net.cond.dense[1]), *io(net.trunk.dense0)]
    for blk in net.trunk.blocks:
        parts += [blk.norm.weight, blk.norm.bias, *io(blk.dense0),
                  *io(blk.dense1)]
    parts += io(net.trunk.dense1)
    return torch.cat([p.detach().float().reshape(-1) for p in parts])


def _smem_bytes(rows: int, kxs: int, half: int, C0: int, C1: int, H: int,
                A: int) -> int:
    floats = rows * kxs + 3 * rows * H + 2 * half + C0 + C1 + H + rows * A
    return 4 * floats


def mlp_diffusion_sample_plain(net: MLPDiffusion, s: torch.Tensor,
                               x_init: torch.Tensor, timesteps: torch.Tensor,
                               coefs: torch.Tensor, noise: torch.Tensor | None,
                               clip_range: float = 1.0) -> torch.Tensor:
    """The kernel's plain twin: the same update, one net call per step."""
    with torch.no_grad():
        return dlib.sample_with_coefs(lambda a, t: net(s, a, t), x_init.float(),
                                      timesteps, coefs, noise, clip_range)


def fused_mlp_diffusion_sample(net: MLPDiffusion, s: torch.Tensor,
                               x_init: torch.Tensor, timesteps: torch.Tensor,
                               coefs: torch.Tensor,
                               noise: torch.Tensor | None = None, *,
                               clip_range: float = 1.0,
                               packed: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Run the full reverse process for (N, S) conditions → (N, A) fp32.

    timesteps (T,) descending; coefs (T, 5); noise (T, N, A) or None (DDIM).
    CPU tensors run the plain twin; CUDA tensors launch the kernel.
    ``packed`` is ``pack_params(net)`` on the device, to reuse across calls.
    """
    if s.device.type == "cpu":
        return mlp_diffusion_sample_plain(net, s, x_init, timesteps, coefs,
                                          noise, clip_range)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    check_supported(net)
    N, S = s.shape
    A = x_init.shape[1]
    T = int(timesteps.shape[0])
    half = net.time.kernel.shape[0]
    C0 = net.cond.dense[0].out_features
    C1 = net.cond.dense[1].out_features
    H = net.trunk.dense0.out_features
    if net.trunk.dense0.in_features != A + S + C1:
        raise ValueError("condition width does not match the net")
    if noise is not None and tuple(noise.shape) != (T, N, A):
        raise ValueError(f"noise must be {(T, N, A)}, got {tuple(noise.shape)}")
    kxs = -(-(A + S) // 4) * 4
    rows = next((r for r in ROWS_CHOICES
                 if _smem_bytes(r, kxs, half, C0, C1, H, A) <= SMEM_LIMIT),
                None)
    if rows is None:
        raise ValueError("net too wide for the kernel's shared memory")
    smem = _smem_bytes(rows, kxs, half, C0, C1, H, A)
    dev = s.device
    if packed is None:
        packed = pack_params(net).to(dev)
    s = s.float().contiguous()
    x_init = x_init.float().contiguous()
    ts = timesteps.to(dev, torch.int32).contiguous()
    coefs = coefs.to(dev, torch.float32).contiguous()
    if noise is not None:
        noise = noise.float().contiguous()
    out = torch.empty((N, A), device=dev, dtype=torch.float32)
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.function("ldp_mlp_sampler",
                         [P, P, P, P, P, P, P] + [I] * 9 + [F, I, I, I, P])
    err = fn(s.data_ptr(), x_init.data_ptr(), ts.data_ptr(), coefs.data_ptr(),
             _build.ptr(noise), packed.data_ptr(), out.data_ptr(),
             N, S, A, T, half, C0, C1, H, len(net.trunk.blocks),
             float(clip_range), rows, kxs, smem, _build.stream_ptr(s))
    _build.check("ldp_mlp_sampler", err)
    fused_mlp_diffusion_sample.launches += 1
    return out


fused_mlp_diffusion_sample.launches = 0
