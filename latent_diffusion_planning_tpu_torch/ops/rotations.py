"""Quaternion / rotation math, batched over any leading axes.

Counterpart of ``latent_diffusion_planning_tpu/ops/rotations.py`` (the part
the ported envs need). Quaternions are (w, x, y, z) unless suffixed
``_xyzw``.

A Hamilton product and a rotation matrix are bilinear in the quaternions'
components, so both are written as one outer product contracted with a
constant table (three launches, not thirty component-wise ones): on the card
the envs' cost is the number of launches, not the arithmetic. The tables
live on each device once (``_tables``); nothing here builds a tensor from a
Python list per call.
"""

from __future__ import annotations

import functools

import torch

EPS = 1e-9

# (a ⊗ b)_k = Σ sign · a_i b_j, terms in the order the JAX package adds them
_MUL_TERMS = {
    0: ((0, 0, 1), (1, 1, -1), (2, 2, -1), (3, 3, -1)),
    1: ((0, 1, 1), (1, 0, 1), (2, 3, 1), (3, 2, -1)),
    2: ((0, 2, 1), (1, 3, -1), (2, 0, 1), (3, 1, 1)),
    3: ((0, 3, 1), (1, 2, 1), (2, 1, -1), (3, 0, 1)),
}
# R[r, c] = [r == c] + Σ coef · q_i q_j for a unit quaternion
_ROT_TERMS = {
    (0, 0): ((2, 2, -2), (3, 3, -2)), (0, 1): ((1, 2, 2), (0, 3, -2)),
    (0, 2): ((1, 3, 2), (0, 2, 2)), (1, 0): ((1, 2, 2), (0, 3, 2)),
    (1, 1): ((1, 1, -2), (3, 3, -2)), (1, 2): ((2, 3, 2), (0, 1, -2)),
    (2, 0): ((1, 3, 2), (0, 2, -2)), (2, 1): ((2, 3, 2), (0, 1, 2)),
    (2, 2): ((1, 1, -2), (2, 2, -2)),
}


@functools.cache
def _tables(device: torch.device) -> dict:
    mul = torch.zeros(16, 4)
    for k, terms in _MUL_TERMS.items():
        for i, j, sign in terms:
            mul[4 * i + j, k] = sign
    rot = torch.zeros(16, 9)
    for (r, c), terms in _ROT_TERMS.items():
        for i, j, coef in terms:
            rot[4 * i + j, 3 * r + c] = coef
    return dict(mul=mul.to(device), rot=rot.to(device),
                eye=torch.eye(3).reshape(9).to(device),
                identity=torch.tensor([1.0, 0.0, 0.0, 0.0]).to(device))


def _contract(outer: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) outer product × (16, M) table → (..., M)."""
    flat = outer.reshape(*outer.shape[:-2], 16, 1)
    return (flat * table).sum(-2)


def quat_identity(device) -> torch.Tensor:
    """(1, 0, 0, 0) on ``device`` (the caller names it), made once."""
    return _tables(torch.device(device))["identity"]


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (wxyz); the leading axes broadcast."""
    return _contract(a[..., :, None] * b[..., None, :],
                     _tables(a.device)["mul"])


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: (q ⊗ (0, v) ⊗ q*)."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], -1)
    return quat_mul(quat_mul(q, qv), quat_conj(q))[..., 1:]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) wxyz → (…, 3, 3) rotation matrix."""
    q = quat_normalize(q)
    t = _tables(q.device)
    r = _contract(q[..., :, None] * q[..., None, :], t["rot"]) + t["eye"]
    return r.reshape(*q.shape[:-1], 3, 3)


def rotate(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R v for rot (..., 3, 3) and v (..., 3)."""
    return (rot * v[..., None, :]).sum(-1)


def rotate_t(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rᵀ v for rot (..., 3, 3) and v (..., 3)."""
    return (rot * v[..., :, None]).sum(-2)


def axis_angle_to_quat(axis_angle: torch.Tensor) -> torch.Tensor:
    """Exponential coordinates (…, 3) → quaternion (…, 4) wxyz."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    axis = axis_angle / torch.clamp(angle, min=EPS)
    half = angle / 2.0
    return torch.cat([torch.cos(half), axis * torch.sin(half)], -1)


def quat_from_unit_axis(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternion from a known unit axis (…, 3) and an angle (…)."""
    half = angle[..., None] / 2.0
    return torch.cat([torch.cos(half), axis * torch.sin(half)], -1)


def quat_wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    """Internal (w, x, y, z) → robosuite/robomimic observable (x, y, z, w)."""
    return torch.cat([q[..., 1:], q[..., :1]], -1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """Integrate orientation by body-frame angular velocity over dt
    (exponential map, exact for constant omega)."""
    return quat_normalize(quat_mul(q, axis_angle_to_quat(omega * dt)))
