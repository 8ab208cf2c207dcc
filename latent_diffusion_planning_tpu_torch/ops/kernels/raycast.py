"""Batched analytic ray-cast renderer: CUDA kernel + plain twin.

Replaces the TPU kernel ``latent_diffusion_planning_tpu/ops/pallas/
raycast.py`` (``render_pallas`` / ``render_batch_pallas`` →
``_render_kernel``). The kernel (``csrc/raycast.cu``) takes the batch of
scenes natively: one thread per pixel, the grid covering (pixel, env), each
env's packed scene in shared memory. It is bound by the image write
(N×H×W×3 fp32); the ray directions are computed once per camera here and
read from L2.

Prims ``[0, n_convex)`` are convex polytopes whose half-spaces come from
``scene.planes``; the rest dispatch box/sphere on ``kind``. The twin is
``ops.render.render_batch``.
"""

from __future__ import annotations

import torch

from .. import render as R
from . import _build


def pack_scene(scene: R.Scene) -> torch.Tensor:
    """Scene → (N, P, 22): pos(3) rot(9) size(3) color(3) kind(1) pad(3)."""
    N, P = scene.pos.shape[:2]
    return torch.cat([scene.pos, scene.rot.reshape(N, P, 9), scene.size,
                      scene.color, scene.kind.float()[..., None],
                      scene.pos.new_zeros(N, P, 3)], -1).float().contiguous()


def render_batch_cuda(scene: R.Scene, cam: R.Camera, height: int = 64,
                      width: int = 64, n_convex: int = 0,
                      rays: torch.Tensor | None = None) -> torch.Tensor:
    """Render every env's scene → (N, H, W, 3) float32 in [0, 255].

    CPU tensors run the plain twin; CUDA tensors launch the kernel.
    ``rays`` is ``R.camera_rays(cam, height, width)`` on the device, to reuse
    across calls.
    """
    if scene.pos.device.type == "cpu":
        return R.render_batch(scene, cam, height, width)
    if scene.pos.device.type != "cuda":
        raise ValueError(f"unsupported device {scene.pos.device}")
    dev = scene.pos.device
    N, P = scene.pos.shape[:2]
    if n_convex and scene.planes is None:
        raise ValueError("n_convex > 0 needs scene.planes")
    if not 0 <= n_convex <= P:
        raise ValueError(f"n_convex must be in [0, {P}]")
    if rays is None:
        rays = R.camera_rays(cam, height, width, dev)
    rays = rays.reshape(-1, 3).float().contiguous()
    packed = pack_scene(scene)
    planes = None
    K = 0
    if n_convex:
        planes = scene.planes.float().contiguous()
        K = planes.shape[2]
    plane = torch.cat([scene.plane_z.reshape(N, 1),
                       scene.plane_color.expand(N, 3)], -1).float().contiguous()
    light = R.light_rig(dev).contiguous()
    out = torch.empty((N, height, width, 3), device=dev, dtype=torch.float32)
    P_, I, F = _build.P, _build.I, _build.F
    fn = _build.function("ldp_raycast",
                         [P_, P_, P_, P_, P_, F, F, F, F, P_] + [I] * 5 + [P_])
    ox, oy, oz = cam.pos
    err = fn(packed.data_ptr(), _build.ptr(planes), plane.data_ptr(),
             rays.data_ptr(), light.data_ptr(), ox, oy, oz, R.AMBIENT,
             out.data_ptr(), N, height * width, P, K, n_convex,
             _build.stream_ptr(packed))
    _build.check("ldp_raycast", err)
    render_batch_cuda.launches += 1
    return out


render_batch_cuda.launches = 0
