"""Batched closed-loop eval and scripted demo collection over N envs on one
device.

Counterpart of ``latent_diffusion_planning_tpu/rollout/engine.py``'s
``run_batched_eval`` and ``run_scripted_collection``. The JAX engine fuses
an episode into one ``lax.scan``; here the steps are a Python loop of eager
device work. Eval episode semantics are the same:

- an ``obs_horizon`` window of observations, materialized lazily from the
  last ``obs_horizon`` env states at decision boundaries only (renders
  inside an action chunk are never computed),
- per decision the policy returns an action chunk; the env consumes
  ``action_horizon`` of it, optionally ACT-style blended with the previous
  plan's unexecuted tail (``plan_blend``),
- episodes end at first success, at a non-finite reward, or at
  ``episode_len``; finished envs are masked (their state frozen), reward is
  the episode's max per-step reward, ``horizon`` its steps to termination.

Not ported yet: env meshes, video capture, the ``optimal`` obs flag
(``add_optimal``), ``run_batched_eval_multi`` and ``run_data_collection``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch

from .. import resolve_device

PolicyFn = Callable[[Any, Mapping[str, torch.Tensor], torch.Generator],
                    torch.Tensor]
"""(agent, obs_window {k: (N, obs_horizon, ...)}, generator)
-> (N, >= action_horizon, A)."""


def agent_sample_policy(agent, obs_window, generator) -> torch.Tensor:
    """Default adapter: the agent's fastest full-inference path."""
    return agent.sample_fast({"obs": dict(obs_window)}, generator=generator)


def policy_view(window: dict, policy_obs_keys) -> dict:
    """What the policy sees: the listed keys (all when None)."""
    return ({k: window[k] for k in policy_obs_keys if k in window}
            if policy_obs_keys else dict(window))


@torch.no_grad()
def run_batched_eval(env, agent, n_episodes: int, seed: int = 0, *,
                     obs_horizon: int = 1, action_horizon: int = 4,
                     episode_len: int | None = None,
                     policy_obs_keys: tuple[str, ...] | None = None,
                     plan_blend: float = 0.0,
                     policy: PolicyFn = agent_sample_policy,
                     init_states=None,
                     device: torch.device | str | None = None) -> dict:
    """Run ``n_episodes`` parallel episodes → host-side metrics.

    ``seed`` seeds one ``torch.Generator`` on the device that draws the
    resets (unless ``init_states`` gives them) and then the policy's noise.
    ``device`` None means the card.
    """
    if not 0.0 <= plan_blend < 1.0:
        raise ValueError(f"plan_blend must be in [0, 1), got {plan_blend}")
    dev = resolve_device(device)
    episode_len = episode_len or env.episode_len
    n_decisions = math.ceil(episode_len / action_horizon)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if init_states is None:
        states = env.reset_state(n_episodes, gen)
    else:
        states = init_states.map(lambda x: x.to(dev))
    history = [states] * obs_horizon

    done = torch.zeros(n_episodes, dtype=torch.bool, device=dev)
    success = torch.zeros_like(done)
    reward = torch.zeros(n_episodes, device=dev)
    reward_sum = torch.zeros_like(reward)
    steps = torch.zeros(n_episodes, dtype=torch.int32, device=dev)
    prev_plan = None

    for _ in range(n_decisions):
        obs_h = [env.obs(s) for s in history]
        window = {k: torch.stack([o[k] for o in obs_h], 1) for k in obs_h[0]}
        actions = policy(agent, policy_view(window, policy_obs_keys), gen)
        if plan_blend > 0.0:
            if prev_plan is not None:
                overlap = actions.shape[1] - action_horizon
                prev_tail = torch.cat([prev_plan[:, action_horizon:],
                                       actions[:, overlap:]], 1)
                actions = (1.0 - plan_blend) * actions + plan_blend * prev_tail
            prev_plan = actions
        for a_t in actions[:, :action_horizon].unbind(1):
            new_states, r, s = env.transition(states, a_t)
            states = new_states.map(
                lambda new, old: torch.where(
                    done.reshape((-1,) + (1,) * (new.ndim - 1)), old, new),
                states)
            history = history[1:] + [states]
            finite = torch.isfinite(r)
            r_live = torch.where(done | ~finite, torch.zeros_like(r), r)
            reward = torch.maximum(reward, r_live)
            reward_sum = reward_sum + r_live
            steps = steps + (~done).int()
            success = success | (~done & s & finite)
            done = done | s | ~finite | (steps >= episode_len)

    per_episode = {"success": success.cpu().numpy(),
                   "reward": reward.cpu().numpy(),
                   "reward_sum": reward_sum.cpu().numpy(),
                   "horizon": steps.cpu().numpy()}
    horizon = per_episode["horizon"]
    metrics = {
        "success": float(per_episode["success"].mean()),
        "reward": float(per_episode["reward"].mean()),
        "horizon": float(horizon.mean()),
        "avg_reward": float((per_episode["reward_sum"]
                             / horizon.clip(min=1)).mean()),
        "n_episodes": n_episodes,
    }
    return {"metrics": metrics, "per_episode": per_episode}


def _scripted_step(env, states, noise: float, clean_labels: bool,
                   draw: torch.Tensor | None):
    """One scripted-expert step: the clean action plus ``noise`` times the
    (held) standard-normal ``draw`` is executed; the clean action is the
    recorded label under ``clean_labels``, the executed one otherwise."""
    clean = env.scripted_action(states)
    executed = clean + noise * draw if noise > 0.0 else clean
    new_states, reward, success = env.transition(states, executed)
    return new_states, dict(obs=env.obs(new_states),
                            action=clean if clean_labels else executed,
                            reward=reward, success=success)


@torch.no_grad()
def run_scripted_collection(env, n_episodes: int, seed: int = 0, *,
                            episode_len: int | None = None,
                            noise: float = 0.0, noise_hold: int = 1,
                            clean_labels: bool = False, init_states=None,
                            noise_draws: torch.Tensor | None = None,
                            device: torch.device | str | None = None) -> dict:
    """Roll out the env's scripted expert (``env.scripted_action``) for
    ``episode_len`` steps in ``n_episodes`` envs → ``first_obs`` {k: (N,
    ...)}, ``obs`` {k: (N, T, ...)}, ``actions`` (N, T, A), ``rewards`` and
    ``success`` (N, T), on the device.

    ``noise``/``noise_hold``: DART-style injection. The executed action is
    expert + N(0, noise²), the draw held for ``noise_hold`` consecutive
    steps; ``clean_labels`` records the expert's noise-free action instead
    of the executed one. ``seed`` seeds a generator on the device that draws
    the resets (unless ``init_states`` gives them) and the noise (unless
    ``noise_draws``, (T, N, A) standard normals already held, gives it).
    """
    dev = resolve_device(device)
    episode_len = episode_len or env.episode_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if init_states is None:
        states = env.reset_state(n_episodes, gen)
    else:
        states = init_states.map(lambda x: x.to(dev))
    first_obs = env.obs(states)
    if noise > 0.0 and noise_draws is None:
        n_blocks = -(-episode_len // noise_hold)
        noise_draws = torch.randn(
            n_blocks, n_episodes, env.action_dim, generator=gen,
            device=dev).repeat_interleave(noise_hold, 0)[:episode_len]
    frames = []
    for t in range(episode_len):
        draw = noise_draws[t].to(dev) if noise > 0.0 else None
        states, frame = _scripted_step(env, states, float(noise),
                                       clean_labels, draw)
        frames.append(frame)
    stack = lambda xs: torch.stack(xs, 1)
    return dict(first_obs=first_obs,
                obs={k: stack([f["obs"][k] for f in frames])
                     for k in frames[0]["obs"]},
                actions=stack([f["action"] for f in frames]),
                rewards=stack([f["reward"] for f in frames]),
                success=stack([f["success"] for f in frames]))
