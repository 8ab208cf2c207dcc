"""Batched environment protocol.

Counterpart of ``latent_diffusion_planning_tpu/envs/base.py``. Where the JAX
envs are pure per-env functions batched by ``vmap``, the port's envs take
the env batch as the leading axis of every state field:

    state, obs = env.reset(n, generator)
    state, obs, reward, success = env.step(state, actions)   # actions (N, A)

``reset_state`` and ``transition`` are ``reset`` and ``step`` without the
observation: the eval engine renders only at decision boundaries, as the
JAX engine's dead-code elimination does.
"""

from __future__ import annotations

from typing import Any, Protocol

import torch


class VectorEnv(Protocol):
    #: observation keys produced by obs(); images are HWC float32 [0, 255]
    obs_keys: tuple[str, ...]
    action_dim: int
    episode_len: int
    max_reward: float

    def reset(self, n: int, generator: torch.Generator):
        """→ (state, obs) for n envs, drawn from ``generator``, on the
        generator's device."""
        ...

    def reset_state(self, n: int, generator: torch.Generator):
        """``reset`` without computing the observation → state."""
        ...

    def reset_to(self, state) -> tuple[Any, dict]:
        """Deterministic state-injection reset → (state, obs)."""
        ...

    def step(self, state, action: torch.Tensor):
        """(state, (N, A)) → (state, obs, reward (N,), success (N,))."""
        ...

    def transition(self, state, action: torch.Tensor):
        """``step`` without computing the observation →
        (state, reward, success)."""
        ...

    def obs(self, state) -> dict:
        ...
