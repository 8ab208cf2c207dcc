"""Batched analytic ray-cast renderer: CUDA kernel + plain twin.

Replaces the TPU kernel ``latent_diffusion_planning_tpu/ops/pallas/
raycast.py`` (``render_pallas`` / ``render_batch_pallas`` →
``_render_kernel``). The kernel (``csrc/raycast.cu``) reads the ``Scene``'s
own tensors in place, each with its env stride (0 for a field broadcast over
envs), so a render is one launch with no packing pass before it. A thread
renders four consecutive pixels, keeps their rays in registers and walks
over ``envs_per_block`` envs; what is constant per (env, prim) is computed
once per block into shared memory (see the note at the top of the source).
By bytes it is bound by the image write (N×H×W×3 fp32); in fact by
instruction issue.

Prims ``[0, n_convex)`` are convex polytopes whose half-spaces come from
``scene.planes``; the rest dispatch box/sphere on ``kind``. The camera is
one ``R.Camera`` for every env (the rays are its world directions) or an
``R.CameraBatch``, one camera per env: then the rays are one camera-frame
table (``R.camera_frame_rays``) that the kernel rotates by each env's basis,
and the origins (N, 3) and bases (N, 3, 3) go in with their env strides.
The twin is ``ops.render.render_batch``.
"""

from __future__ import annotations

import torch

from .. import render as R
from . import _build

MAX_SMEM_BYTES = 200 * 1024
REC_FLOATS = 28     # csrc/raycast.cu kRec: floats per (env, prim) record
ENV_REC_FLOATS = 4  # kEnvRec: floats per env with the launch's camera
ENV_REC_CAM_FLOATS = 20   # kEnvRecCam: floats per env with its own camera
MAX_ENVS_PER_BLOCK = 4


def _field(t: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, int]:
    """A scene field as the kernel reads it: (tensor, env stride in
    elements). Dense within an env; the env axis may be broadcast (stride
    0). Anything else is copied dense."""
    if t.dtype != dtype:
        t = t.to(dtype)
    if not t.is_contiguous():       # else: is it dense within an env?
        dense = 1
        for size, stride in zip(reversed(t.shape[1:]),
                                reversed(t.stride()[1:])):
            if size != 1 and stride != dense:
                t = t.contiguous()
                break
            dense *= size
    return t, (t.stride(0) if t.shape[0] > 1 else 0)


def default_envs_per_block(N: int, HW: int) -> int:
    """Envs one block walks over: at most 4, fewer where that would leave
    under about a thousand blocks (some 2.5 for each of the card's 396
    block slots, so that the SMs stay balanced). Measured at 1024 envs of
    64×64: 2 to 4 are best, 1 repeats the prologue and the ray loads, 8 and
    more leave SMs idle at the end."""
    pixel_chunks = -(-HW // 1024)
    return max(1, min(MAX_ENVS_PER_BLOCK, N * pixel_chunks // 1024))


def smem_bytes(P: int, K: int, n_convex: int, envs_per_block: int,
               cam_per_env: bool = False) -> int:
    """Shared memory of one block (``ldp_raycast_smem_bytes``)."""
    env_rec = ENV_REC_CAM_FLOATS if cam_per_env else ENV_REC_FLOATS
    return 4 * (envs_per_block * (P * REC_FLOATS + n_convex * K * 4
                                  + env_rec) + 12)


def default_rays(cam, height: int, width: int, device) -> torch.Tensor:
    """The ray table the kernel reads for ``cam``: world directions of a
    shared camera, camera-frame ones for a ``CameraBatch``."""
    if isinstance(cam, R.CameraBatch):
        return R.camera_frame_rays(cam.fov_deg, height, width, device)
    return R.camera_rays(cam, height, width, device)


def launch_args(scene: R.Scene, cam: R.Camera | R.CameraBatch, height: int,
                width: int, n_convex: int = 0,
                rays: torch.Tensor | None = None,
                envs_per_block: int | None = None):
    """Check a scene and marshal it for ``ldp_raycast`` → (arguments but
    for the stream, output tensor, tensors the pointers refer to).
    ``envs_per_block`` is how many envs one block renders with the same rays
    (``default_envs_per_block``; less where the half-spaces would not fit
    in shared memory). ``rays`` is ``default_rays(cam, ...)``, to reuse."""
    dev = scene.pos.device
    N, P = scene.pos.shape[:2]
    if n_convex and scene.planes is None:
        raise ValueError("n_convex > 0 needs scene.planes")
    if not 0 <= n_convex <= P:
        raise ValueError(f"n_convex must be in [0, {P}]")
    per_env = isinstance(cam, R.CameraBatch)
    if per_env and tuple(cam.pos.shape) != (N, 3):
        raise ValueError(f"a camera per env needs pos ({N}, 3), got "
                         f"{tuple(cam.pos.shape)}")
    if rays is None:
        rays = default_rays(cam, height, width, dev)
    if rays.numel() != height * width * 3 or rays.shape[-1] != 3:
        raise ValueError(f"rays are {tuple(rays.shape)}, expected "
                         f"({height * width}, 3)")
    f32 = torch.float32
    if rays.dtype != f32 or not rays.is_contiguous():
        rays = rays.float().contiguous()
    fields = [_field(t, f32) for t in (
        scene.pos, scene.rot, scene.size, scene.color)]
    fields.append(_field(scene.kind, torch.int32))
    K = scene.planes.shape[2] if n_convex else 0
    fields.append(_field(scene.planes, f32) if n_convex else (None, 0))
    fields.append(_field(scene.plane_z.reshape(N), f32))
    fields.append(_field(scene.plane_color.expand(N, 3), f32))
    if per_env:
        fields.append(_field(cam.pos, f32))
        fields.append(_field(cam.basis.reshape(N, 9), f32))
        ox = oy = oz = 0.0
    else:
        fields += [(None, 0), (None, 0)]
        ox, oy, oz = cam.pos
    E = max(1, min(envs_per_block or default_envs_per_block(
        N, height * width), N))
    need = lambda e: smem_bytes(P, K, n_convex, e, per_env)
    while E > 1 and need(E) > MAX_SMEM_BYTES:
        E -= 1
    if need(E) > MAX_SMEM_BYTES:
        raise ValueError(
            f"one env's scene ({P} prims, {n_convex} x {K} half-spaces) "
            f"needs {need(E)} bytes of shared memory; "
            f"the kernel has {MAX_SMEM_BYTES}")
    light = R.light_rig(dev)
    out = torch.empty((N, height, width, 3), device=dev, dtype=f32)
    args = [x for t, stride in fields for x in (_build.ptr(t), stride)]
    args += [rays.data_ptr(), light.data_ptr(), ox, oy, oz, R.AMBIENT,
             out.data_ptr(), N, height * width, P, K, n_convex, E]
    return args, out, (fields, rays, light)


ARGTYPES = ([_build.P, _build.LL] * 10 + [_build.P] * 2 + [_build.F] * 4
            + [_build.P] + [_build.I] * 6 + [_build.P])


def render_batch_cuda(scene: R.Scene, cam: R.Camera | R.CameraBatch,
                      height: int = 64, width: int = 64, n_convex: int = 0,
                      rays: torch.Tensor | None = None) -> torch.Tensor:
    """Render every env's scene → (N, H, W, 3) float32 in [0, 255].

    CPU tensors run the plain twin; CUDA tensors launch the kernel.
    ``rays`` is ``default_rays(cam, height, width)`` on the device, to reuse
    across calls.
    """
    if scene.pos.device.type == "cpu":
        return R.render_batch(scene, cam, height, width)
    if scene.pos.device.type != "cuda":
        raise ValueError(f"unsupported device {scene.pos.device}")
    args, out, _keep = launch_args(scene, cam, height, width, n_convex, rays)
    err = _build.function("ldp_raycast", ARGTYPES)(
        *args, _build.stream_ptr(out))
    _build.check("ldp_raycast", err)
    render_batch_cuda.launches += 1
    return out


render_batch_cuda.launches = 0
