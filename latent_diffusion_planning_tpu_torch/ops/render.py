"""Analytic renderer: batched camera frames from primitive scenes.

Counterpart of ``latent_diffusion_planning_tpu/ops/render.py``: oriented box,
sphere and convex (k-DOP) primitives over an implicit checkered ground
plane, nearest hit, Lambert shading from a fixed 3-light rig plus ambient,
sky gradient for misses. Images are HWC float32 in [0, 255].

Unlike the JAX ``Scene`` (one scene, batched by ``vmap``), a ``Scene`` here
carries the env axis: every field leads with N. A ``Camera`` is one camera
for every env; a ``CameraBatch`` is one camera per env (a camera that rides
a robot's gripper: under ``vmap`` the JAX package batches the camera with
the scene). ``render_batch`` is the plain version; ``ops/kernels/raycast.py``
holds the CUDA kernel.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

BIG = 1e9

LIGHT_DIRS = ((0.4, 0.2, -0.9), (-0.5, -0.3, -0.8), (0.1, 0.6, -0.8))
LIGHT_COLORS = (0.55, 0.35, 0.25)
AMBIENT = 0.35
PLANE_COLOR = (0.45, 0.45, 0.5)


@dataclass
class Scene:
    """A batch of primitive soups: (N, P, ...) per field.

    kind: 0 box (half-extents in size), 1 sphere (radius size[..., 0]),
    2 convex polytope (body-frame half-spaces n·x ≤ d in ``planes``,
    (N, P, K, 4); padding rows (0, 0, 0, 1) constrain nothing).
    """

    pos: torch.Tensor          # (N, P, 3)
    rot: torch.Tensor          # (N, P, 3, 3) world-from-body
    size: torch.Tensor         # (N, P, 3)
    color: torch.Tensor        # (N, P, 3)
    kind: torch.Tensor         # (N, P) int
    plane_z: torch.Tensor      # (N,)
    plane_color: torch.Tensor  # (N, 3)
    planes: torch.Tensor | None = None


@dataclass(frozen=True)
class Camera:
    pos: tuple
    lookat: tuple
    up: tuple
    fov_deg: float


@dataclass
class CameraBatch:
    """One camera per env: origin ``pos`` (N, 3) and ``basis`` (N, 3, 3)
    whose columns are the camera's right, down and forward axes in the
    world (``camera_basis``), so a camera-frame direction c maps to the
    world direction ``basis @ c``."""

    pos: torch.Tensor
    basis: torch.Tensor
    fov_deg: float


def look_at(pos, lookat, up=(0.0, 0.0, 1.0)) -> Camera:
    return Camera(tuple(float(v) for v in pos), tuple(float(v) for v in lookat),
                  tuple(float(v) for v in up), 45.0)


def camera_basis(pos: torch.Tensor, lookat: torch.Tensor,
                 up: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) columns right, down, forward of cameras at ``pos`` looking
    at ``lookat`` with ``up`` (each (N, 3)): the JAX package's
    ``_camera_rays`` frame batched, its fallback for a view along ``up``
    included (the world axis least aligned with the view)."""
    fwd = lookat - pos
    fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
    right = torch.linalg.cross(fwd, up)
    axis = torch.argmin(fwd.abs(), -1)
    alt = torch.linalg.cross(
        fwd, torch.nn.functional.one_hot(axis, 3).to(fwd.dtype))
    right = torch.where(torch.linalg.norm(right, dim=-1, keepdim=True) > 1e-6,
                        right, alt)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    return torch.stack([right, down, fwd], -1)


def camera_batch(pos: torch.Tensor, lookat: torch.Tensor, up: torch.Tensor,
                 fov_deg: float) -> CameraBatch:
    return CameraBatch(pos, camera_basis(pos, lookat, up), fov_deg)


def _image_plane(fov_deg: float, height: int, width: int, device):
    half_h = math.tan(math.radians(fov_deg) / 2.0)
    half_w = half_h * (width / height)
    ys = torch.linspace(-half_h, half_h, height, device=device)
    xs = torch.linspace(-half_w, half_w, width, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


def camera_frame_rays(fov_deg: float, height: int, width: int,
                      device=None) -> torch.Tensor:
    """Unit ray directions (H, W, 3) in the camera frame (x right, y down,
    z forward): what kernel C rotates by each env's ``basis``."""
    yy, xx = _image_plane(fov_deg, height, width, device)
    dirs = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def camera_batch_rays(cam: CameraBatch, height: int,
                      width: int) -> torch.Tensor:
    """World ray directions (N, H, W, 3) of every env's camera, summed and
    normalized in the JAX package's order (fwd + x right + y down)."""
    yy, xx = _image_plane(cam.fov_deg, height, width, cam.pos.device)
    b = cam.basis[:, None, None]                          # (N, 1, 1, 3, 3)
    dirs = (b[..., 2] + xx[..., None] * b[..., 0]
            + yy[..., None] * b[..., 1])
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def camera_rays(cam: Camera, height: int, width: int,
                device=None) -> torch.Tensor:
    """Unit ray directions (H, W, 3) of one camera, float32."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)[None]
    return camera_batch_rays(camera_batch(t(cam.pos), t(cam.lookat),
                                          t(cam.up), cam.fov_deg),
                             height, width)[0]


def euler_z(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about +z, (..., 3, 3)."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def link_frame(p0: torch.Tensor, p1: torch.Tensor, width):
    """Box spanning p0→p1 (each (..., 3)): (center, rot (..., 3, 3) with x
    along the segment, half-size). ``width`` is a float or a tensor that
    broadcasts against (..., 1). The port's copy of the JAX package's
    ``envs/aloha_base._link_frame``, with the batch written out."""
    d = p1 - p0
    length = torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9
    x = d / length
    zero, one = torch.zeros_like(x[..., 0]), torch.ones_like(x[..., 0])
    ref = torch.where(x[..., 2:3].abs() < 0.9,
                      torch.stack([zero, zero, one], -1),
                      torch.stack([one, zero, zero], -1))
    y = torch.linalg.cross(ref, x)
    y = y / (torch.linalg.norm(y, dim=-1, keepdim=True) + 1e-9)
    z = torch.linalg.cross(x, y)
    wide = torch.zeros_like(length) + width
    half = torch.cat([length / 2.0, wide, wide], -1)
    return (p0 + p1) / 2.0, torch.stack([x, y, z], -1), half


@functools.cache
def light_rig(device=None) -> torch.Tensor:
    """(3, 4): normalized light direction and color per light. Made once per
    device: a tensor built from Python lists on the card is a copy from
    pageable memory that waits for the stream."""
    d = torch.tensor(LIGHT_DIRS, dtype=torch.float32, device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    c = torch.tensor(LIGHT_COLORS, dtype=torch.float32, device=device)
    return torch.cat([d, c[:, None]], -1)


def _ray_box(o, d, half):
    """Body-frame slab test. o: (N, P, 1, 3), d: (N, P, HW, 3)."""
    safe = torch.where(d.abs() < 1e-9,
                       torch.where(d >= 0, 1e-9, -1e-9).to(d.dtype), d)
    inv = 1.0 / safe
    t1 = (-half - o) * inv
    t2 = (half - o) * inv
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    t_near = tmin.max(-1).values
    t_far = tmax.min(-1).values
    hit = (t_near <= t_far) & (t_far > 1e-4)
    t_hit = torch.where(t_near > 1e-4, t_near, t_far)
    t_hit = torch.where(hit, t_hit, torch.full_like(t_hit, BIG))
    axis = tmin.argmax(-1)
    n_body = -torch.sign(d) * torch.nn.functional.one_hot(axis, 3).to(d.dtype)
    return t_hit, n_body


def _ray_convex(o, d, planes):
    """Generalized slab test over half-spaces. planes: (N, P, K, 4)."""
    n = planes[..., :3]                                   # (N, P, K, 3)
    off = planes[..., 3]                                  # (N, P, K)
    ndotd = torch.einsum("npxc,npkc->npxk", d, n)         # (N, P, HW, K)
    ndoto = torch.einsum("npxc,npkc->npxk", o, n)         # (N, P, 1, K)
    para = ndotd.abs() < 1e-9
    t_k = (off[:, :, None] - ndoto) / torch.where(para, 1e-9, ndotd)
    entering = ndotd < 0
    t_ent = torch.where(entering & ~para, t_k, -BIG)
    t_near = t_ent.max(-1).values
    t_far = torch.where(~entering & ~para, t_k, BIG).min(-1).values
    outside_para = (para & (ndoto > off[:, :, None])).any(-1)
    hit = (t_near <= t_far) & (t_far > 1e-4) & ~outside_para
    t_hit = torch.where(t_near > 1e-4, t_near, t_far)
    t_hit = torch.where(hit, t_hit, torch.full_like(t_hit, BIG))
    k_best = t_ent.argmax(-1)                             # (N, P, HW)
    n_body = torch.gather(n, 2, k_best[..., None].expand(*k_best.shape, 3))
    return t_hit, n_body


def _ray_sphere(origin, d, pos, radius):
    oc = origin - pos                                     # (N, P, 1, 3)
    b = (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radius ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t_hit = torch.where(t0 > 1e-4, t0, t1)
    t_hit = torch.where((disc > 0) & (t_hit > 1e-4), t_hit,
                        torch.full_like(t_hit, BIG))
    p = origin + d * t_hit[..., None]
    return t_hit, (p - pos) / torch.clamp(radius, min=1e-9)[..., None]


def render_batch(scene: Scene, cam: Camera | CameraBatch, height: int = 64,
                 width: int = 64) -> torch.Tensor:
    """Plain renderer: (N, H, W, 3) float32 in [0, 255]. ``cam`` is one
    camera for every env or a ``CameraBatch``."""
    dev = scene.pos.device
    if isinstance(cam, CameraBatch):
        dirs = camera_batch_rays(cam, height, width).reshape(
            cam.pos.shape[0], 1, -1, 3)                   # (N, 1, HW, 3)
        origin = cam.pos.float()[:, None, None, :]        # (N, 1, 1, 3)
    else:
        dirs = camera_rays(cam, height, width, dev).reshape(1, 1, -1, 3)
        origin = torch.tensor(cam.pos, dtype=torch.float32,
                              device=dev).reshape(1, 1, 1, 3)
    rot = scene.rot                                       # (N, P, 3, 3)
    # body frame: o' = Rᵀ(o - c), d' = Rᵀ d (row-vector form: v @ R)
    o_b = ((origin[:, :, 0] - scene.pos)[:, :, None, :] @ rot)  # (N, P, 1, 3)
    d_b = dirs @ rot                                      # (N, P, HW, 3)
    t_box, n_box = _ray_box(o_b, d_b, scene.size[:, :, None, :])
    t_sph, n_sph = _ray_sphere(origin, dirs, scene.pos[:, :, None, :],
                               scene.size[..., 0][:, :, None])
    kind = scene.kind[:, :, None]
    t = torch.where(kind == 0, t_box, t_sph)
    n_body_or_world_box = n_box @ rot.transpose(-1, -2)
    n = torch.where(kind[..., None] == 0, n_body_or_world_box, n_sph)
    if scene.planes is not None:
        t_cvx, n_cvx = _ray_convex(o_b, d_b, scene.planes)
        n_cvx = n_cvx @ rot.transpose(-1, -2)
        t = torch.where(kind == 2, t_cvx, t)
        n = torch.where(kind[..., None] == 2, n_cvx, n)

    dz = dirs[:, 0, :, 2]                                       # (1|N, HW)
    safe_dz = torch.where(dz.abs() < 1e-9, torch.full_like(dz, -1e-9), dz)
    o_env = origin[:, 0]                                        # (1|N, 1, 3)
    t_plane = (scene.plane_z[:, None] - o_env[..., 2]) / safe_dz  # (N, HW)
    t_plane = torch.where(t_plane > 1e-4, t_plane, torch.full_like(t_plane, BIG))
    p_hit = o_env + dirs[:, 0] * t_plane[..., None]
    checker = torch.remainder(torch.floor(p_hit[..., 0] / 0.2)
                              + torch.floor(p_hit[..., 1] / 0.2), 2.0)
    plane_rgb = scene.plane_color[:, None, :] * (0.85 + 0.15 * checker)[..., None]

    ts_all = torch.cat([t, t_plane[:, None]], 1)               # (N, P+1, HW)
    plane_n = torch.zeros_like(n[:, :1])
    plane_n[..., 2] = 1.0
    ns_all = torch.cat([n, plane_n], 1)                         # (N, P+1, HW, 3)
    t_best, best = ts_all.min(1)                                # (N, HW)
    hit = t_best < BIG * 0.5
    idx = best[:, None, :, None].expand(-1, 1, -1, 3)
    n_best = torch.gather(ns_all, 1, idx)[:, 0]                 # (N, HW, 3)
    cols = torch.cat([scene.color[:, :, None, :].expand(-1, -1, dirs.shape[2], -1),
                      plane_rgb[:, None]], 1)
    c_best = torch.gather(cols, 1, idx)[:, 0]

    rig = light_rig(dev)
    diffuse = (torch.clamp(n_best @ -rig[:, :3].t(), min=0.0) * rig[:, 3]).sum(-1)
    shade = AMBIENT + diffuse[..., None]
    sky = torch.tensor([0.7, 0.8, 0.9], device=dev) * (
        0.6 + 0.4 * torch.clamp(dz, 0, 1))[..., None]
    rgb = torch.where(hit[..., None], c_best * shade, sky)
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).reshape(-1, height, width, 3)
