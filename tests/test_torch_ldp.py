"""The port's LDP agent and eval engine vs the JAX package's.

``sample_fast`` is held against JAX ``LDPAgent.sample_fast`` with
``fused_sampler=False`` (the XLA scans) on the same observation windows and
the same draws (the JAX agent's initial samples, handed to the port through
``draws=``). Both sides are fp32 on the CPU; the outputs are actions after
10 + 10 DDIM steps whose x0-clip and IDM feed small summation-order
differences forward, so the bar is atol 1e-3 on actions in [-1, 1].
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from latent_diffusion_planning_tpu.envs import lift as jlift
from latent_diffusion_planning_tpu.models.agents import LDPAgent as JaxLDPAgent
from latent_diffusion_planning_tpu.rollout import engine as jengine
from latent_diffusion_planning_tpu.train.checkpoint import (
    Checkpointer, apply_params_snapshot)
from latent_diffusion_planning_tpu.utils.config import _configify, instantiate
from latent_diffusion_planning_tpu_torch import bridge, configs
from latent_diffusion_planning_tpu_torch.envs import lift
from latent_diffusion_planning_tpu_torch.models.agents.ldp import LDPAgent
from latent_diffusion_planning_tpu_torch.rollout import engine

ACTION_ATOL = 1e-3
CKPT = Path(__file__).resolve().parent.parent / "assets" / "bench"


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _windows(B=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "robot0_eef_pos": (rng.normal(size=(B, 1, 3)) * 0.1
                           + [0, 0, 1.0]).astype(np.float32),
        "robot0_eef_quat": np.tile(np.asarray([0, 0, 0, 1.0], np.float32),
                                   (B, 1, 1)),
        "robot0_gripper_qpos": np.tile(np.asarray([0.04, -0.04], np.float32),
                                       (B, 1, 1)),
        "agentview_image": rng.uniform(0, 255, (B, 1, 64, 64, 3)).astype(
            np.float32),
    }


def _jax_draws(rng, B, T, obs_dim, A):
    """The initial samples JAX sample_fast draws with fused_sampler=False:
    sample_ddim takes normal(split(key)[1]) of the plan and IDM keys."""
    rng, plan_rng = jax.random.split(rng)
    x_plan = jax.random.normal(jax.random.split(plan_rng)[1], (B, T, obs_dim))
    _, idm_rng = jax.random.split(rng)
    x_idm = jax.random.normal(jax.random.split(idm_rng)[1], (B * T, A))
    return {"planner": np.array(x_plan), "idm": np.array(x_idm)}


def _small_config():
    cfg = configs.bench_agent_config()
    cfg.update(planner={"down_dims": [8, 16], "kernel_size": 5, "n_groups": 4,
                        "diffusion_step_embed_dim": 32},
               idm_net={"n_blocks": 2, "hidden_dim": 32, "time_dim": 16,
                        "cond_hidden_dims": [32, 32]},
               vae={"block_out_channels": [8, 16, 16, 16], "norm_groups": 4,
                    "patch_size": 4, "latent_channels": 4},
               planner_n_diffusion_steps=12, idm_n_diffusion_steps=12,
               planner_inference_steps=4, idm_inference_steps=4)
    return cfg


def _jax_small_agent(cfg):
    B, H = 2, 9
    batch = {"obs": {k: jnp.zeros((B, H, *configs.SHAPE_META["all_shapes"][k]))
                     for k in cfg["lowdim_obs"] + cfg["rgb_obs"]},
             "actions": jnp.zeros((B, H, 7))}
    pkg = "latent_diffusion_planning_tpu.models.nets."
    return JaxLDPAgent.create(
        jax.random.PRNGKey(0), batch, configs.SHAPE_META,
        planner={"_target_": pkg + "unet1d.ConditionalUnet1D", **cfg["planner"]},
        idm_net={"_target_": pkg + "mlp.MLPDiffusion", **cfg["idm_net"]},
        vae=cfg["vae"], vae_feature_dim=16, lowdim_obs=cfg["lowdim_obs"],
        rgb_obs=cfg["rgb_obs"], obs_normalization=cfg["obs_normalization"],
        obs_horizon=1, pred_horizon=8, action_horizon=4,
        planner_n_diffusion_steps=12, idm_n_diffusion_steps=12,
        planner_inference_steps=4, idm_inference_steps=4, warmup_steps=2,
        decay_steps=10, fused_sampler=False)


def _compare_sample_fast(jagent, agent, B=4, seed=0):
    window = _windows(B, seed)
    key = jax.random.PRNGKey(5 + seed)
    ref = np.asarray(jagent.sample_fast({"obs": window}, key))
    draws = _jax_draws(key, B, 8, agent.config.obs_dim, 7)
    got = agent.sample_fast({"obs": {k: torch.from_numpy(v)
                                     for k, v in window.items()}},
                            draws=draws).numpy()
    assert got.shape == ref.shape == (B, 8, 7)
    np.testing.assert_allclose(got, ref, atol=ACTION_ATOL, rtol=0)


def test_sample_fast_matches_jax_small():
    cfg = _small_config()
    jagent = _jax_small_agent(cfg)
    snap = {"planner_params": _np(jagent.planner_state.params),
            "idm_params": _np(jagent.idm_state.params),
            "vae_params": _np(jagent.vae_params)}
    agent = bridge.ldp_agent_from_flax(snap, cfg, configs.SHAPE_META,
                                       device="cpu")
    _compare_sample_fast(jagent, agent)


def test_sample_fast_matches_jax_on_bench_checkpoint():
    """The committed bench checkpoint, restored by the JAX package's
    Checkpointer and converted by bridge.py, at the bench's DDIM-10."""
    cfg_j = _configify(yaml.safe_load((CKPT / "config.yaml").read_text()))
    meta = cfg_j.data.meta
    shape_meta = {k: (dict(v) if hasattr(v, "items") else v)
                  for k, v in meta.shape_meta.items()}
    shape_meta["all_shapes"] = {k: list(v) for k, v in
                                meta.shape_meta.all_shapes.items()}
    batch = {"obs": {k: jnp.zeros((2, 9, *shape_meta["all_shapes"][k]))
                     for k in list(meta.lowdim_obs) + list(meta.rgb_obs)},
             "actions": jnp.zeros((2, 9, 7))}
    agent_cfg = dict(cfg_j.agent)
    agent_cfg.pop("vae_pretrain_path", None)
    agent_cfg.update(planner_inference_steps=10, idm_inference_steps=10,
                     fused_sampler=False)
    jagent = instantiate(agent_cfg, jax.random.PRNGKey(0), batch, shape_meta)
    snap = Checkpointer(CKPT).restore_raw(CKPT / "agent.ckpt")
    jagent = apply_params_snapshot(jagent, snap)
    agent = bridge.ldp_agent_from_flax(_np(snap), configs.bench_agent_config(),
                                       configs.SHAPE_META, device="cpu")
    _compare_sample_fast(jagent, agent)


# ---------------------------------------------------------------------------
# the eval engine, with a deterministic observation policy on both sides
# ---------------------------------------------------------------------------

def _policy_core(xp, rel, grip, chunk):
    """Servo to the cube, close when on it, then lift (xp: jnp or torch).
    Only a chunk's first step moves; every step holds the gripper command."""
    on_cube = xp.sqrt((rel * rel).sum(-1)) < 0.02
    closed = grip < 0.03
    target = xp.where(closed[:, None], xp.zeros_like(rel) + 0.1, rel)
    step = xp.clip(target / 0.05, -1.0, 1.0)
    close = xp.where(on_cube | closed, 1.0, -1.0)
    first = xp.where(xp.arange(chunk) == 0, 1.0, 0.0)[None, :, None]
    moves = xp.concatenate([step[:, None, :] * first,
                            xp.zeros_like(step[:, None, :] * first)], -1)
    grips = xp.zeros_like(moves[..., :1]) + close[:, None, None]
    return xp.concatenate([moves, grips], -1)


def _jax_policy(agent, window, rng):
    obj = window["object"][:, -1]
    return _policy_core(jnp, obj[:, 7:10],
                        window["robot0_gripper_qpos"][:, -1, 0], 8)


class _TorchNS:
    sqrt, where, clip, zeros_like = (torch.sqrt, torch.where, torch.clamp,
                                     torch.zeros_like)
    concatenate = staticmethod(torch.cat)
    arange = staticmethod(lambda n: torch.arange(n, dtype=torch.float32))


def _torch_policy(agent, window, gen):
    obj = window["object"][:, -1]
    return _policy_core(_TorchNS, obj[:, 7:10],
                        window["robot0_gripper_qpos"][:, -1, 0], 8)


@pytest.mark.parametrize("plan_blend", [0.0, 0.5])
def test_run_batched_eval_matches_jax(plan_blend):
    n, T = 8, 60
    rng = jax.random.PRNGKey(3)
    jenv = jlift.LiftEnv(render_images=False)
    ref = jengine.run_batched_eval(jenv, None, n, rng, action_horizon=4,
                                   episode_len=T, plan_blend=plan_blend,
                                   policy=_jax_policy)
    # the JAX engine's resets: fold each episode seed into split(rng)[0]
    reset_rng = jax.random.split(rng)[0]
    keys = jax.vmap(lambda s: jax.random.fold_in(reset_rng, s))(
        jnp.arange(n, dtype=jnp.int32))
    states, _ = jax.vmap(jenv.reset)(keys)
    init = lift.LiftState(**{k: torch.from_numpy(np.array(getattr(states, k)))
                             for k in ("eef_pos", "gripper", "cube_pos",
                                       "cube_yaw", "grasped", "t")})
    got = engine.run_batched_eval(lift.LiftEnv(render_images=False), None, n,
                                  action_horizon=4, episode_len=T,
                                  plan_blend=plan_blend, policy=_torch_policy,
                                  init_states=init, device="cpu")
    for k in ("success", "horizon"):
        np.testing.assert_array_equal(got["per_episode"][k],
                                      np.asarray(ref["per_episode"][k]))
    for k in ("reward", "reward_sum"):
        np.testing.assert_allclose(got["per_episode"][k],
                                   np.asarray(ref["per_episode"][k]),
                                   atol=1e-5)
    assert got["per_episode"]["success"].any()


@pytest.mark.parametrize("change,reason", [
    (dict(planner_inference_steps=None), "DDIM only"),
    (dict(pred_horizon=7), "not divisible"),
    (dict(idm_net={"n_blocks": 2, "hidden_dim": 32, "time_dim": 16,
                   "cond_hidden_dims": [32, 32], "cond_activation": "mish"}),
     "swish"),
    (dict(idm_net={"n_blocks": 2, "hidden_dim": 48, "time_dim": 16,
                   "cond_hidden_dims": [32, 32]}), "64, 128, 192 or 256"),
    (dict(fused_dtype="float32"), "bf16"),
])
def test_kernel_refusals(change, reason):
    """What the JAX agent hands to its XLA scan, the port refuses on the
    card with the reason; the same check runs here on a CPU agent."""
    cfg = _small_config()
    cfg.update(change)
    agent = LDPAgent.create(cfg, configs.SHAPE_META, device="cpu")
    with pytest.raises(ValueError, match=reason):
        agent._check_kernels()


def test_non_epsilon_prediction_refused():
    cfg = _small_config()
    cfg["idm_prediction_type"] = "sample"
    with pytest.raises(ValueError, match="ε prediction"):
        LDPAgent.create(cfg, configs.SHAPE_META, device="cpu")


def _torch_phys_state(states):
    """A batch of JAX ``LiftPhysState``s as the port's."""
    from latent_diffusion_planning_tpu_torch.envs import lift_physics as lp
    from latent_diffusion_planning_tpu_torch.envs import physics as ph
    t = lambda a: torch.from_numpy(np.array(a))
    return lp.LiftPhysState(
        bodies=ph.RigidBody(**{f: t(getattr(states.bodies, f))
                               for f in ("pos", "quat", "linvel", "angvel")}),
        **{f: t(getattr(states, f)) for f in ("qpos", "eef_target", "gripper",
                                              "cube_yaw0", "t")})


def test_run_batched_eval_on_lift_physics_replays_golden():
    """The eval engine drives ``LiftPhysicsEnv`` (``reset_state`` →
    ``obs`` → ``transition`` with masking) through the recorded action
    sequence of ``tests/fixtures/replay_golden.npz``, 4 actions a decision:
    the episode's max and summed reward equal the recording's at the JAX
    replay test's reward tolerance (1e-3 a step)."""
    from latent_diffusion_planning_tpu_torch.envs import lift_physics as lp
    golden = np.load(Path(__file__).parent / "fixtures" / "replay_golden.npz")
    actions = torch.from_numpy(golden["lift_actions"])             # (40, 7)
    env = lp.LiftPhysicsEnv(render_images=False, episode_len=40)
    xy_rng, yaw_rng = jax.random.split(jax.random.PRNGKey(5))
    xy = jax.random.uniform(xy_rng, (2,), minval=-0.1, maxval=0.1)
    yaw = jax.random.uniform(yaw_rng, (), minval=-jnp.pi / 6,
                             maxval=jnp.pi / 6)
    init = env.reset_state(
        2, torch.Generator().manual_seed(0),
        cube_xy=torch.from_numpy(np.array(xy)).expand(2, 2),
        cube_yaw=torch.from_numpy(np.array(yaw)).expand(2))
    calls = []

    def replay(agent, window, gen):
        assert set(window) == {"object", "robot0_eef_pos"}
        d = len(calls)
        calls.append(window["object"].shape)
        return actions[4 * d:4 * d + 4][None].expand(2, 4, 7)

    got = engine.run_batched_eval(
        env, None, 2, action_horizon=4, episode_len=40, policy=replay,
        policy_obs_keys=("object", "robot0_eef_pos"), init_states=init,
        device="cpu")
    rewards = golden["lift_rewards"]
    done = np.flatnonzero(rewards >= 1.0)
    steps = int(done[0]) + 1 if len(done) else 40
    assert len(calls) == 10 and calls[0] == (2, 1, 10)
    np.testing.assert_array_equal(got["per_episode"]["horizon"], steps)
    np.testing.assert_allclose(got["per_episode"]["reward"],
                               rewards[:steps].max(), atol=1e-3)
    np.testing.assert_allclose(got["per_episode"]["reward_sum"],
                               rewards[:steps].sum(), atol=1e-3 * steps)


@pytest.mark.slow       # 100 s of XLA compile for the JAX engine's scan
def test_run_batched_eval_on_lift_physics_matches_jax():
    """The eval engine on ``LiftPhysicsEnv``, 2 envs × 8 steps (2 decisions,
    80 physics substeps), against the JAX engine from the same initial
    states (the JAX engine's own resets, handed in) under the deterministic
    observation policy of the kinematic test. Success and horizon are equal;
    rewards are held at the JAX package's replay tolerance for this env
    (1e-3 a step, ``tests/test_replay_regression.py``): the closed loop
    feeds fp32 differences of the IK solve and the contacts back through the
    policy, and after 8 steps the two differ by 3e-5 in one env. The next
    test puts a learned policy and the renderers into the loop."""
    from latent_diffusion_planning_tpu.envs import lift_physics as jlp
    from latent_diffusion_planning_tpu_torch.envs import lift_physics as lp
    n, T = 2, 8
    rng = jax.random.PRNGKey(7)
    jenv = jlp.LiftPhysicsEnv(render_images=False)
    ref = jengine.run_batched_eval(jenv, None, n, rng, action_horizon=4,
                                   episode_len=T, policy=_jax_policy)
    reset_rng = jax.random.split(rng)[0]
    keys = jax.vmap(lambda s: jax.random.fold_in(reset_rng, s))(
        jnp.arange(n, dtype=jnp.int32))
    states, _ = jax.vmap(jenv.reset)(keys)
    got = engine.run_batched_eval(
        lp.LiftPhysicsEnv(render_images=False), None, n, action_horizon=4,
        episode_len=T, policy=_torch_policy,
        init_states=_torch_phys_state(states), device="cpu")
    for k in ("success", "horizon"):
        np.testing.assert_array_equal(got["per_episode"][k],
                                      np.asarray(ref["per_episode"][k]))
    np.testing.assert_allclose(got["per_episode"]["reward"],
                               np.asarray(ref["per_episode"]["reward"]),
                               atol=1e-3)
    np.testing.assert_allclose(got["per_episode"]["reward_sum"],
                               np.asarray(ref["per_episode"]["reward_sum"]),
                               atol=1e-3 * T)
    assert (got["per_episode"]["reward_sum"] > 0).all()


@pytest.mark.slow       # minutes of XLA compile: agent + physics + renderer
def test_run_batched_eval_tiny_agent_on_lift_physics_matches_jax():
    """The whole slice at a small size: a tiny LDP agent (the same weights
    on both sides, through ``bridge.py``) drives ``LiftPhysicsEnv`` from its
    rendered frames, 2 envs × 8 steps, in the JAX engine and in the port's,
    from the JAX engine's resets and with the JAX agent's draws handed in
    decision by decision. The two renderers differ in a few silhouette
    pixels and the closed loop feeds every difference back, so rewards are
    held at the replay tolerance (1e-3 a step), success and horizon
    exactly."""
    from latent_diffusion_planning_tpu.envs import lift_physics as jlp
    from latent_diffusion_planning_tpu_torch.envs import lift_physics as lp
    cfg = _small_config()
    jagent = _jax_small_agent(cfg)
    snap = {"planner_params": _np(jagent.planner_state.params),
            "idm_params": _np(jagent.idm_state.params),
            "vae_params": _np(jagent.vae_params)}
    agent = bridge.ldp_agent_from_flax(snap, cfg, configs.SHAPE_META,
                                       device="cpu")
    n, T = 2, 8
    rng = jax.random.PRNGKey(9)
    jenv = jlp.LiftPhysicsEnv(image_size=64, render_images=True)
    ref = jengine.run_batched_eval(
        jenv, jagent, n, rng, action_horizon=4, episode_len=T,
        policy_obs_keys=configs.BENCH_POLICY_KEYS)
    reset_rng, policy_rng = jax.random.split(rng)
    keys = jax.vmap(lambda s: jax.random.fold_in(reset_rng, s))(
        jnp.arange(n, dtype=jnp.int32))
    states, _ = jax.vmap(jlp.LiftPhysicsEnv(render_images=False).reset)(keys)
    d_rngs = jax.random.split(jax.random.fold_in(policy_rng, 0), T // 4)
    draws = [_jax_draws(k, n, 8, agent.config.obs_dim, 7) for k in d_rngs]
    seen = []

    def policy(agent_, window, gen):
        seen.append(None)
        return agent_.sample_fast({"obs": dict(window)},
                                  draws=draws[len(seen) - 1])

    got = engine.run_batched_eval(
        lp.LiftPhysicsEnv(image_size=64), agent, n, action_horizon=4,
        episode_len=T, policy_obs_keys=configs.BENCH_POLICY_KEYS,
        policy=policy, init_states=_torch_phys_state(states), device="cpu")
    assert len(seen) == 2
    for k in ("success", "horizon"):
        np.testing.assert_array_equal(got["per_episode"][k],
                                      np.asarray(ref["per_episode"][k]))
    np.testing.assert_allclose(got["per_episode"]["reward"],
                               np.asarray(ref["per_episode"]["reward"]),
                               atol=1e-3)
    np.testing.assert_allclose(got["per_episode"]["reward_sum"],
                               np.asarray(ref["per_episode"]["reward_sum"]),
                               atol=1e-3 * T)
