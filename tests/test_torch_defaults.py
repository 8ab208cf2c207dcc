"""The JAX package's four default agent configurations in the port, DDPM
kept, against the JAX agents.

Each agent is built from ``conf/agent/<name>.json`` (``ldp_agent``,
``ldp_hier_agent``, ``dp_agent``, ``dp_repr_agent``) through
``utils/config.load_config("train_bc", ...)`` with ``train_bc``'s
defaults: ``n_diffusion_steps`` 100 and ``inference_steps`` null (the full
ancestral DDPM process), batch 256, obs_horizon 1, action_horizon 8,
pred_horizon 16 (LDP and LDP-hier plan the window after ``obs_horizon``,
so they take ``horizon=17``: at the yaml's 16 their 15 targets fail the
U-Net's stride in both packages). Only the widths are narrowed on the
command line (U-Nets [16,32,64] or [16,32], embedding 32, the MLP IDM 64
wide, a narrow VAE, a two-stage ResNet of 8 filters). The JAX agent comes
from the JAX package's own config loader over the same command line, its
weights drawn with numpy from ``jax.eval_shape``'s tree in place of Flax's
eager ``init``, and samples with its XLA scans (``fused_sampler=False``);
the port's agent is bridged from those weights and handed the same draws
(``draws=``): the initial sample from ``split(key)[1]`` and one normal per
step from ``split(split(key)[0], 100)``, for every reverse process the
JAX call runs. On the card the same configurations launch kernels B and A;
here their plain twins run.

Both sides are fp32 on the CPU with JAX's matmuls at "highest" precision.
Bars: a sample after DDPM-100 2e-4 (the JAX package's kernel-vs-scan bar,
``tests/test_pallas_sampler.py``); actions decoded from a sampled plan
1e-3, as ``tests/test_torch_ldp.py`` holds them (the IDM carries the
plan's differences forward); plan statistics 1e-4 relative.
"""

import functools
from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent_diffusion_planning_tpu.utils import config as jconfig
from latent_diffusion_planning_tpu_torch import bridge
from latent_diffusion_planning_tpu_torch.utils.config import load_config
from torch_thread import one_torch_thread  # noqa: F401

SAMPLE_ATOL = 2e-4
ACTION_ATOL = 1e-3
STEPS = 100

NARROW = {
    "common": ["model_vae.block_out_channels=[8,16,16,16]",
               "model_vae.norm_groups=4", "model_vae.patch_size=4",
               "agent.planner.down_dims=[16,32,64]",
               "agent.planner.diffusion_step_embed_dim=32"],
    "ldp_agent": ["agent.idm_net.hidden_dim=64", "agent.idm_net.time_dim=16",
                  "agent.idm_net.cond_hidden_dims=[32,32]"],
    "ldp_hier_agent": ["agent.idm_net.down_dims=[16,32]",
                       "agent.idm_net.diffusion_step_embed_dim=32"],
    "dp_agent": ["agent.encoder.stage_sizes=[1,1]",
                 "agent.encoder.n_filters=8"],
    "dp_repr_agent": [],
}
DATA = {"ldp_agent": "lift/latent_img", "ldp_hier_agent": "lift/latent_img",
        "dp_agent": "lift/img", "dp_repr_agent": "lift/latent_img"}
BRIDGE = {"ldp_agent": bridge.ldp_agent_from_flax,
          "ldp_hier_agent": bridge.ldp_hier_agent_from_flax,
          "dp_agent": bridge.dp_agent_from_flax,
          "dp_repr_agent": bridge.dp_vae_agent_from_flax}


@pytest.fixture(autouse=True)
def _precise_matmul():
    with jax.default_matmul_precision("highest"):
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def command_line(name: str) -> list[str]:
    """``train_bc agent=<name>`` as the JAX command line runs it, widths
    narrowed."""
    horizon = (["horizon=17", "pred_horizon=16"]
               if name.startswith("ldp") else [])
    return ([f"agent={name}", f"data={DATA[name]}", *horizon]
            + NARROW["common"] + NARROW[name])


def _seeded_params(shapes, seed):
    """Weights for a Flax tree of shapes, drawn with numpy: kernels at
    variance 1 / fan_in, norm scales about 1, biases about 0."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(size=leaf.shape) / np.sqrt(
                int(np.prod(leaf.shape[:-1])))
        elif name == "scale":
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        else:
            v = 0.2 * rng.normal(size=leaf.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_agent(cfg):
    orig = flax.linen.Module.init

    def init(module, rngs, *args, **kwargs):
        shapes = jax.eval_shape(
            lambda r, *a: orig(module, r, *a, **kwargs), rngs, *args)
        return {"params": _seeded_params(shapes["params"], 0)}
    with mock.patch.object(flax.linen.Module, "init", init):
        return jconfig.instantiate(cfg.agent, jax.random.PRNGKey(0), None,
                                   cfg.data.meta.shape_meta,
                                   fused_sampler=False)


def _snapshot(jagent):
    snap = {}
    for key, value in jagent.get_params().items():
        snap[key] = _np(value)
    if hasattr(jagent, "vae_params"):
        snap["vae_params"] = _np(jagent.vae_params)
    return snap


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(name, the port's config, the JAX agent, the port's agent)."""
    cfg = load_config("train_bc", command_line(name))
    jcfg = jconfig.load_config("train_bc", command_line(name))
    agent_cfg = {k: v for k, v in dict(cfg.agent).items()
                 if k != "vae_pretrain_path"}
    assert agent_cfg.get("inference_steps", agent_cfg.get(
        "planner_inference_steps")) is None
    jagent = _jax_agent(jcfg)
    agent = BRIDGE[name](_snapshot(jagent), agent_cfg,
                         cfg.data["meta"]["shape_meta"], device="cpu")
    return name, cfg, jagent, agent


def _ddpm_draws(key, shape):
    """The initial sample and the per-step noise ``jdlib.sample_ddpm``
    draws from ``key``."""
    rng, init_rng = jax.random.split(key)
    x0 = jax.random.normal(init_rng, shape, jnp.float32)
    noise = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
        jax.random.split(rng, STEPS))
    return np.array(x0), np.array(noise)


def _window(name, B, H, seed):
    """Observation windows: the latent form for the VAE agents (their VAE
    passes latents through), raw frames for DP."""
    rng = np.random.default_rng(seed)
    obs = {"robot0_eef_pos": (rng.normal(size=(B, H, 3)) * 0.1
                              + [0, 0, 1.0]).astype(np.float32),
           "robot0_eef_quat": rng.uniform(-1, 1, (B, H, 4)).astype(np.float32),
           "robot0_gripper_qpos": (rng.uniform(size=(B, H, 2))
                                   * [0.05, -0.05]).astype(np.float32)}
    if name == "dp_agent":
        obs["agentview_image"] = rng.integers(
            0, 256, (B, H, 64, 64, 3)).astype(np.float32)
    else:
        obs["latent_agentview_image"] = rng.uniform(
            -6, 6, (B, H, 16)).astype(np.float32)
    return obs


def _both(obs):
    return ({"obs": jax.tree_util.tree_map(jnp.asarray, obs)},
            {"obs": {k: torch.from_numpy(v) for k, v in obs.items()}})


@pytest.mark.parametrize("name", sorted(DATA))
def test_the_defaults_are_ddpm_100_and_pass_the_kernel_check(name):
    """What the card would refuse it refuses here too: nothing, for the
    defaults (the check runs on a CPU agent)."""
    _, cfg, _, agent = _pair(name)
    if name.startswith("ldp"):
        scheds = (agent.planner_sched, agent.idm_sched)
        steps = (agent.config.planner_inference_steps,
                 agent.config.idm_inference_steps)
    else:
        scheds, steps = (agent.sched,), (agent.config.inference_steps,)
    assert [s.num_steps for s in scheds] == [STEPS] * len(scheds)
    assert steps == (None,) * len(scheds)
    assert cfg.batch_size == 256 and cfg.action_horizon == 8
    assert agent.config.pred_horizon == 16
    agent._check_kernels()


@pytest.mark.parametrize("name", sorted(DATA))
def test_sample_action_matches_jax(name):
    """``sample_action`` against the JAX agent's: DP and DPVAE sample the
    action U-Net (B's route); LDP decodes consecutive observed latents with
    the MLP IDM (A's route); LDP-hier with the chunk U-Net (B's)."""
    _, _, jagent, agent = _pair(name)
    B, H = 3, (1 if name.startswith("dp") else 3)
    jobs, tobs = _both(_window(name, B, H, seed=1))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jagent.sample_action(jobs, key))
    A, pairs = 7, B * (H - 1)
    if name.startswith("dp"):
        x0, noise = _ddpm_draws(key, (B, 16, A))
        draws = {"x_init": x0, "step_noise": noise}
    else:
        chunk = ((agent.config.idm_horizon,) if name == "ldp_hier_agent"
                 else ())
        x0, noise = _ddpm_draws(key, (pairs, *chunk, A))
        draws = {"idm": x0, "idm_step_noise": noise}
    got = agent.sample_action(tobs, draws=draws).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=SAMPLE_ATOL, rtol=0)


def _jax_plan_draws(key, plan_shape, idm_shape):
    """JAX ``sample_fast``: the plan's key is ``split(key)[1]``, the IDM's
    ``split(split(key)[0])[1]``; each reverse process draws as
    ``sample_ddpm``."""
    rng, plan_rng = jax.random.split(key)
    _, idm_rng = jax.random.split(rng)
    xp, np_ = _ddpm_draws(plan_rng, plan_shape)
    xi, ni = _ddpm_draws(idm_rng, idm_shape)
    return {"planner": xp, "planner_step_noise": np_, "idm": xi,
            "idm_step_noise": ni}


@pytest.mark.parametrize("name", ["ldp_agent", "ldp_hier_agent"])
def test_sample_fast_matches_jax(name):
    """LDP and LDP-hier: the planner's DDPM-100 (B's route) and the IDM's
    (A's for LDP, B's for LDP-hier's chunk U-Net) in one decision."""
    _, _, jagent, agent = _pair(name)
    B, D, A = 3, agent.config.obs_dim, 7
    jobs, tobs = _both(_window(name, B, 1, seed=2))
    key = jax.random.PRNGKey(4)
    want = np.asarray(jagent.sample_fast(jobs, key))
    if name == "ldp_agent":
        draws = _jax_plan_draws(key, (B, 16, D), (B * 16, A))
    else:
        P, k = agent.plan_length, agent.config.idm_horizon
        draws = _jax_plan_draws(key, (B, P, D), (B * P, k, A))
    got = agent.sample_fast(tobs, draws=draws).numpy()
    assert got.shape == want.shape == (B, 16, A)
    np.testing.assert_allclose(got, want, atol=ACTION_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["ldp_agent", "ldp_hier_agent"])
def test_sample_plan_stats_at_the_window_length_matches_jax(name):
    """The planner at the window's 16 latents (LDP-hier's wide-mode length
    on the card) through ``sample_plan_stats``."""
    _, _, jagent, agent = _pair(name)
    B, D = 2, agent.config.obs_dim
    jobs, tobs = _both(_window(name, B, 17, seed=5))
    key = jax.random.PRNGKey(6)
    want = jagent.sample_plan_stats(jobs, key)
    x0, noise = _ddpm_draws(key, (B, 16, D))
    got = agent.sample_plan_stats(
        tobs, draws={"planner": x0, "planner_step_noise": noise})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=0, err_msg=k)
