"""Serial-chain forward kinematics + position-servo joint dynamics, batched
over envs.

Counterpart of ``latent_diffusion_planning_tpu/envs/physics/kinematics.py``.
The JAX functions take one env's joint vector and are ``vmap``ped; here
``qpos`` is (N, J) and every result leads with N. The chain is unrolled only
where a joint depends on the one before it (the running product of joint
quaternions); the joint quaternions themselves, the rotation matrices of all
frames and the link translations are each one batched call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import rotations as rot


class JointChain(NamedTuple):
    """Revolute serial chain: link i applies translation ``offsets[i]`` and
    optional fixed rotation ``link_quats[i]`` (both in the parent frame),
    then joint i rotates about ``axes[i]``."""

    offsets: torch.Tensor      # (J, 3) parent→joint translation
    axes: torch.Tensor         # (J, 3) unit rotation axes
    base_pos: torch.Tensor     # (3,)
    base_quat: torch.Tensor    # (4,) wxyz
    tip_offset: torch.Tensor   # (3,) last-frame → end-effector
    link_quats: torch.Tensor | None = None  # (J, 4) fixed per-link rotations

    def to(self, device) -> "JointChain":
        return JointChain(*(None if t is None else t.to(device) for t in self))


def _frames(chain: JointChain, qpos: torch.Tensor):
    """(positions (N, J+1, 3), quats (N, J+1, 4), rotation matrices
    (N, J+1, 3, 3) of the frames *before* each joint and of the last)."""
    N, J = qpos.shape
    joint = rot.quat_from_unit_axis(chain.axes, qpos)            # (N, J, 4)
    if chain.link_quats is not None:
        joint = rot.quat_mul(chain.link_quats, joint)
    quat = chain.base_quat.expand(N, 4)
    quats = []
    for j in range(J):      # each frame needs the one before it
        quat = rot.quat_mul(quat, joint[:, j])
        quats.append(quat)
    # frame j's translation is rotated by the frame before it
    before = torch.stack([chain.base_quat.expand(N, 4)] + quats, 1)
    mats = rot.quat_to_matrix(before)                            # (N, J+1, 3, 3)
    steps = torch.cat([chain.offsets, chain.tip_offset[None]], 0)
    positions = chain.base_pos + torch.cumsum(rot.rotate(mats, steps), 1)
    return positions, torch.stack(quats + [quat], 1), mats


def fk(chain: JointChain, qpos: torch.Tensor):
    """Forward kinematics: qpos (N, J) → (positions (N, J+1, 3), quats
    (N, J+1, 4)) of every joint frame plus the end-effector frame (last)."""
    positions, quats, _ = _frames(chain, qpos)
    return positions, quats


def eef_pose(chain: JointChain, qpos: torch.Tensor):
    """(eef position (N, 3), eef quat (N, 4))."""
    ps, qs = fk(chain, qpos)
    return ps[:, -1], qs[:, -1]


def servo_step(qpos, target, max_delta: float, lo=None, hi=None):
    """Rate-limited position servo toward ``target`` (one control step)."""
    q = qpos + torch.clamp(target - qpos, -max_delta, max_delta)
    if lo is not None:
        q = torch.minimum(torch.maximum(q, lo), hi)
    return q


def _jacobian(chain: JointChain, positions, mats) -> torch.Tensor:
    # mats[:, j + 1] is frame j after its own rotation, which leaves the
    # joint's axis where it was
    axis_w = rot.rotate(mats[:, 1:], chain.axes)                 # (N, J, 3)
    arm = positions[:, -1:, :] - positions[:, :-1, :]
    return torch.linalg.cross(axis_w, arm).transpose(1, 2)      # (N, 3, J)


def geometric_jacobian(chain: JointChain, qpos: torch.Tensor) -> torch.Tensor:
    """Exact positional Jacobian (N, 3, J): column j is axis_j × (p_eef −
    p_j), the world-frame joint axis crossed with the moment arm."""
    positions, _, mats = _frames(chain, qpos)
    return _jacobian(chain, positions, mats)


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for A (N, 3, 3), b (N, 3), in closed form: the rows'
    cross products are the adjugate's columns, over the determinant. A few
    elementwise launches and no pivoting library call."""
    cof = torch.linalg.cross(torch.roll(A, -1, 1), torch.roll(A, -2, 1))
    det = (A[:, 0] * cof[:, 0]).sum(-1, keepdim=True)
    return (cof * b[:, :, None]).sum(1) / det


def dls_ik_step(chain: JointChain, qpos: torch.Tensor,
                target_pos: torch.Tensor, damping: float = 0.05,
                lo=None, hi=None) -> torch.Tensor:
    """One damped-least-squares IK step toward a Cartesian eef target:
    q' = q + Jᵀ (J Jᵀ + λ²I)⁻¹ (x* − x(q)), one FK pass."""
    positions, _, mats = _frames(chain, qpos)
    J = _jacobian(chain, positions, mats)                        # (N, 3, J)
    err = target_pos - positions[:, -1]
    eye = rot._tables(qpos.device)["eye"].reshape(3, 3)
    A = (J[:, :, None, :] * J[:, None, :, :]).sum(-1) + (damping ** 2) * eye
    dq = (J * solve3(A, err)[:, :, None]).sum(1)
    q = qpos + dq
    if lo is not None:
        q = torch.minimum(torch.maximum(q, lo), hi)
    return q
