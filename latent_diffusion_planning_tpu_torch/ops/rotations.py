"""Quaternion helpers the ported envs need.

Counterpart of part of ``latent_diffusion_planning_tpu/ops/rotations.py``.
Quaternions are (w, x, y, z) unless suffixed ``_xyzw``.
"""

from __future__ import annotations

import torch


def quat_wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    """Internal (w, x, y, z) → robosuite/robomimic observable (x, y, z, w)."""
    return torch.cat([q[..., 1:], q[..., :1]], -1)
