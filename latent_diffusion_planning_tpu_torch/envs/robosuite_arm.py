"""Panda 7-DoF arm for the robosuite-side tasks, batched over envs.

Counterpart of ``latent_diffusion_planning_tpu/envs/robosuite_arm.py``: the
URDF-exact Panda chain under ``physics/kinematics.py``; OSC-style eef deltas
resolve through damped-least-squares IK steps and rate-limited joint servos.
"""

from __future__ import annotations

import functools
import math

import torch

from .physics import kinematics as K


def _quat_x(angle: float) -> tuple:
    h = angle / 2.0
    return (math.cos(h), math.sin(h), 0.0, 0.0)


def panda_chain(base_pos=(-0.56, 0.0, 0.8)) -> K.JointChain:
    """Franka Panda kinematics (URDF link offsets + fixed rpy rotations);
    the tip offset spans flange + hand to the grasp midpoint."""
    offsets = torch.tensor([
        [0.0, 0.0, 0.333],
        [0.0, 0.0, 0.0],
        [0.0, -0.316, 0.0],
        [0.0825, 0.0, 0.0],
        [-0.0825, 0.384, 0.0],
        [0.0, 0.0, 0.0],
        [0.088, 0.0, 0.0],
    ])
    link_quats = torch.tensor([
        (1.0, 0.0, 0.0, 0.0),
        _quat_x(-math.pi / 2),
        _quat_x(math.pi / 2),
        _quat_x(math.pi / 2),
        _quat_x(-math.pi / 2),
        _quat_x(math.pi / 2),
        _quat_x(math.pi / 2),
    ], dtype=torch.float32)
    return K.JointChain(
        offsets=offsets, axes=torch.tensor([0.0, 0.0, 1.0]).repeat(7, 1),
        base_pos=torch.tensor(base_pos, dtype=torch.float32),
        base_quat=torch.tensor([1.0, 0.0, 0.0, 0.0]),
        tip_offset=torch.tensor([0.0, 0.0, 0.21]),
        link_quats=link_quats)


PANDA_LO = torch.tensor([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973,
                         -0.0175, -2.8973])
PANDA_HI = torch.tensor([2.8973, 1.7628, 2.8973, -0.0698, 2.8973,
                         3.7525, 2.8973])
# robosuite's Panda init_qpos (elbow-up ready pose over the table)
PANDA_HOME = torch.tensor([0.0, 0.1963, 0.0, -2.6180, 0.0, 2.9416, 0.7854])

MAX_JOINT_DELTA = 0.15     # rad per control step (OSC output limiting)


@functools.cache
def panda_limits(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(PANDA_LO, PANDA_HI) on ``device``, moved there once."""
    return PANDA_LO.to(device), PANDA_HI.to(device)


def arm_track(chain: K.JointChain, qpos: torch.Tensor,
              eef_target: torch.Tensor, iters: int = 2,
              lo: torch.Tensor | None = None,
              hi: torch.Tensor | None = None) -> torch.Tensor:
    """OSC-flavored tracking: IK-solve the Cartesian target, rate-limit.
    ``lo``/``hi`` default to the Panda limits on ``qpos``'s device."""
    if lo is None:
        lo, hi = panda_limits(qpos.device)
    q = qpos
    for _ in range(iters):
        q = K.dls_ik_step(chain, q, eef_target, damping=0.1, lo=lo, hi=hi)
    dq = torch.clamp(q - qpos, -MAX_JOINT_DELTA, MAX_JOINT_DELTA)
    return torch.minimum(torch.maximum(qpos + dq, lo), hi)
