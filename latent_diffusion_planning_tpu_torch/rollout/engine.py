"""Batched closed-loop eval, policy data collection and scripted demo
collection over N envs on one device.

Counterpart of ``latent_diffusion_planning_tpu/rollout/engine.py``'s
``run_batched_eval``, ``run_data_collection`` and
``run_scripted_collection``. The JAX engine fuses an episode into one
``lax.scan``; here the steps are a Python loop of eager device work. Eval
episode semantics are the same:

- an ``obs_horizon`` window of observations, materialized lazily from the
  last ``obs_horizon`` env states at decision boundaries only (renders
  inside an action chunk are never computed),
- per decision the policy returns an action chunk; the env consumes
  ``action_horizon`` of it, optionally ACT-style blended with the previous
  plan's unexecuted tail (``plan_blend``),
- episodes end at first success, at a non-finite reward, or at
  ``episode_len``; finished envs are masked (their state frozen), reward is
  the episode's max per-step reward, ``horizon`` its steps to termination.

Every entry point resets episode i from (``seed``, ``episode_seeds[i]``)
alone (default ``episode_seeds`` = 0..N-1), as the JAX engine's per-episode
``fold_in`` does: the spawn's uniforms come from a counter-based integer
hash computed on the device (``reset_uniforms``), so an episode's spawn is
the same in a run of any size and can be replayed alone. The policy's draws
and the action noise come from a ``torch.Generator`` seeded with ``seed``.
Threefry cannot be matched, so the spawns are not the JAX package's.

Not ported yet: env meshes, video capture and ``run_batched_eval_multi``.
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
    """Default adapter: the agent's fastest full-inference path
    (``sample_fast`` where it has one, else ``sample_action``)."""
    sample = getattr(agent, "sample_fast", None) or agent.sample_action
    return sample({"obs": dict(obs_window)}, generator=generator)


def policy_view(window: dict, policy_obs_keys, add_optimal: bool = False,
                obs_horizon: int = 1) -> dict:
    """What the policy sees: the listed keys (all when None) and, with
    ``add_optimal``, the ``optimal`` flag as ones (N, obs_horizon, 1), which
    no env produces (an agent trained on mixed data reads it)."""
    view = ({k: window[k] for k in policy_obs_keys if k in window}
            if policy_obs_keys else dict(window))
    if add_optimal:
        leaf = next(iter(window.values()))
        view["optimal"] = torch.ones(leaf.shape[0], obs_horizon, 1,
                                     device=leaf.device)
    return view


# -- per-episode resets -----------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x·c mod 2³² for x in [0, 2³²) (an int64 tensor or an int), in 16-bit
    halves of ``c`` so no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer finalizer (lowbias32): every output bit depends on
    every input bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def reset_uniforms(seed: int, episode_seeds: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(N, n) float32 uniforms in [0, 1) for the resets of episodes
    ``episode_seeds`` (N,): a hash of (``seed``, episode seed, draw index)
    on the seeds' device, so row i depends on ``seed`` and
    ``episode_seeds[i]`` alone, on any device."""
    key = _mix32(_mix32(seed & _M32) ^ ((seed >> 32) & _M32))
    h = _mix32((episode_seeds.long() & _M32) ^ key)
    draw = torch.arange(1, n + 1, device=episode_seeds.device) * 0x9E3779B9
    h = _mix32((h[:, None] + draw[None, :]) & _M32)
    return (h >> 8).float() * (1.0 / (1 << 24))


def _initial_states(env, n_episodes: int, seed: int, episode_seeds,
                    init_states, gen: torch.Generator):
    """``init_states`` on the device, or the resets of ``episode_seeds``
    (default 0..N-1) under ``seed``."""
    dev = gen.device
    if init_states is not None:
        return init_states.map(lambda x: x.to(dev))
    if episode_seeds is None:
        episode_seeds = torch.arange(n_episodes, device=dev)
    episode_seeds = torch.as_tensor(episode_seeds, device=dev)
    if tuple(episode_seeds.shape) != (n_episodes,):
        raise ValueError(f"episode_seeds shape {tuple(episode_seeds.shape)} "
                         f"!= ({n_episodes},)")
    u = reset_uniforms(seed, episode_seeds, env.reset_uniforms)
    return env.reset_state(n_episodes, gen, **env.reset_draws(u))


@torch.no_grad()
def run_batched_eval(env, agent, n_episodes: int, seed: int = 0, *,
                     obs_horizon: int = 1, action_horizon: int = 4,
                     episode_len: int | None = None,
                     policy_obs_keys: tuple[str, ...] | None = None,
                     add_optimal: bool = False,
                     episode_seeds=None,
                     plan_blend: float = 0.0,
                     policy: PolicyFn = agent_sample_policy,
                     init_states=None,
                     device: torch.device | str | None = None) -> dict:
    """Run ``n_episodes`` parallel episodes → host-side metrics.

    Episode i resets from (``seed``, ``episode_seeds[i]``) unless
    ``init_states`` gives the states; ``seed`` also seeds the generator on
    the device that the policy draws from. ``add_optimal`` hands the policy
    the ``optimal`` flag (``policy_view``). ``device`` None means the card.
    """
    if not 0.0 <= plan_blend < 1.0:
        raise ValueError(f"plan_blend must be in [0, 1), got {plan_blend}")
    dev = resolve_device(device)
    episode_len = episode_len or env.episode_len
    n_decisions = math.ceil(episode_len / action_horizon)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    states = _initial_states(env, n_episodes, seed, episode_seeds,
                             init_states, gen)
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
        actions = policy(agent, policy_view(window, policy_obs_keys,
                                            add_optimal, obs_horizon), gen)
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


@torch.no_grad()
def run_data_collection(env, agent, n_episodes: int, seed: int = 0, *,
                        obs_horizon: int = 1, action_horizon: int = 4,
                        episode_len: int | None = None,
                        action_noise: float = 0.0,
                        policy_obs_keys: tuple[str, ...] | None = None,
                        add_optimal: bool = False, episode_seeds=None,
                        policy: PolicyFn = agent_sample_policy,
                        init_states=None,
                        noise_draws: torch.Tensor | None = None,
                        device: torch.device | str | None = None) -> dict:
    """Roll out a policy with Gaussian action noise and return its full
    trajectories for a dataset, in ``run_scripted_collection``'s layout
    (``first_obs``, ``obs``, ``actions``, ``rewards``, ``success``, on the
    device; ``data/writer.weld_collection`` welds them).

    Episodes run all ``ceil(episode_len / action_horizon)`` decisions, with
    no early stop and no masking, so the trajectories are rectangular. Per
    decision: one policy call on the window of the last ``obs_horizon``
    observations (the first repeated before the start), then
    ``action_horizon`` env steps with the chunk plus ``action_noise`` times
    standard normals; the noised actions are executed and recorded, and
    every step's observation is computed (it is recorded). Resets as in
    ``run_batched_eval``; ``noise_draws`` (n_decisions, N, action_horizon,
    A) hands the normals in, else they are drawn after each policy call
    from the generator the policy draws from.
    """
    dev = resolve_device(device)
    episode_len = episode_len or env.episode_len
    n_decisions = math.ceil(episode_len / action_horizon)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    states = _initial_states(env, n_episodes, seed, episode_seeds,
                             init_states, gen)
    first_obs = env.obs(states)
    history = [first_obs] * obs_horizon
    frames = []
    for d in range(n_decisions):
        window = {k: torch.stack([o[k] for o in history], 1)
                  for k in first_obs}
        actions = policy(agent, policy_view(window, policy_obs_keys,
                                            add_optimal, obs_horizon),
                         gen)[:, :action_horizon]
        if action_noise > 0.0:
            draw = (noise_draws[d].to(dev) if noise_draws is not None
                    else torch.randn(actions.shape, generator=gen,
                                     device=dev))
            actions = actions + action_noise * draw
        for a_t in actions.unbind(1):
            states, reward, success = env.transition(states, a_t)
            obs = env.obs(states)
            history = history[1:] + [obs]
            frames.append(dict(obs=obs, action=a_t, reward=reward,
                               success=success))
    return _stack_frames(first_obs, frames)


def _stack_frames(first_obs: dict, frames: list[dict]) -> dict:
    """Per-step frames → the (N, T, ...) collection layout."""
    stack = lambda xs: torch.stack(xs, 1)
    return dict(first_obs=first_obs,
                obs={k: stack([f["obs"][k] for f in frames])
                     for k in frames[0]["obs"]},
                actions=stack([f["action"] for f in frames]),
                rewards=stack([f["reward"] for f in frames]),
                success=stack([f["success"] for f in frames]))


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
                            episode_seeds=None,
                            noise_draws: torch.Tensor | None = None,
                            device: torch.device | str | None = None) -> dict:
    """Roll out the env's scripted expert (``env.scripted_action``) for
    ``episode_len`` steps in ``n_episodes`` envs → ``first_obs`` {k: (N,
    ...)}, ``obs`` {k: (N, T, ...)}, ``actions`` (N, T, A), ``rewards`` and
    ``success`` (N, T), on the device.

    ``noise``/``noise_hold``: DART-style injection. The executed action is
    expert + N(0, noise²), the draw held for ``noise_hold`` consecutive
    steps; ``clean_labels`` records the expert's noise-free action instead
    of the executed one. Resets as in ``run_batched_eval`` (unless
    ``init_states`` gives them); ``seed`` seeds a generator on the device
    that draws the noise (unless ``noise_draws``, (T, N, A) standard
    normals already held, gives it).
    """
    dev = resolve_device(device)
    episode_len = episode_len or env.episode_len
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    states = _initial_states(env, n_episodes, seed, episode_seeds,
                             init_states, gen)
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
    return _stack_frames(first_obs, frames)
