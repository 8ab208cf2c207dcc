"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

Each module binds one kernel from ``csrc/`` and keeps beside it: a launch
counter on the wrapper (``<wrapper>.launches``), a plain twin that the wrapper
runs only for CPU tensors, and a note naming the TPU kernel it replaces.
"""

from . import diffusion_mlp, diffusion_unet1d, raycast

WRAPPERS = {
    "diffusion_mlp": diffusion_mlp.fused_mlp_diffusion_sample,
    "diffusion_unet1d": diffusion_unet1d.fused_unet1d_ddim_sample,
    "raycast": raycast.render_batch_cuda,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    diffusion_unet1d.fused_unet1d_ddim_sample.grid_launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
