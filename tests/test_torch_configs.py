"""configs.py's bench dicts agree with assets/bench/config.yaml.

The port carries the bench config as a dict because the machine with the
card has no YAML reader; this test is what keeps the two in step. The
inference steps are the bench's override (10), not the yaml's 25.
"""

from pathlib import Path

import pytest
import torch
import yaml

from latent_diffusion_planning_tpu_torch import configs, resolve_device

CFG = yaml.safe_load((Path(__file__).resolve().parent.parent / "assets" / "bench"
                      / "config.yaml").read_text())


def test_agent_config_matches_yaml():
    want = dict(CFG["agent"])
    for k in ("_target_", "vae_pretrain_path"):
        want.pop(k)
    for net in ("planner", "idm_net"):
        want[net] = {k: v for k, v in want[net].items()
                     if k not in ("_target_", "_defer_")}
    want.update(planner_inference_steps=10, idm_inference_steps=10,
                fused_dtype="bfloat16")
    got = configs.bench_agent_config()
    shared = {k for k in want if k not in (
        "lr", "end_lr", "idm_lr", "idm_end_lr", "warmup_steps", "decay_steps",
        "update_planner_every", "update_idm_every", "update_idm_after",
        "update_planner_until", "update_planner_after", "grad_clip",
        "alpha_planner", "alpha_idm", "data_name")}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert set(got) - set(want) == set()


def test_env_and_shape_meta_match_yaml():
    env = CFG["data"]["env_params"]["env"]
    for k, v in configs.BENCH_ENV.items():
        assert env[k] == v
    assert configs.SHAPE_META == CFG["data"]["meta"]["shape_meta"]
    assert configs.OBS_NORMALIZATION == CFG["data"]["meta"]["obs_normalization"]


def test_bench_env_is_the_physics_env_with_the_jax_settings():
    """``make_bench_env`` builds what ``bench.py`` instantiates from the
    yaml: ``LiftPhysicsEnv`` with the JAX class's own substeps, time step
    and contact parameters, at the bench's episode length."""
    from latent_diffusion_planning_tpu.envs.lift_physics import (
        LiftPhysicsEnv as JaxEnv)
    target = CFG["data"]["env_params"]["env"]["_target_"]
    assert target.endswith("lift_physics.LiftPhysicsEnv")
    jenv, env = JaxEnv(render_images=False), configs.make_bench_env()
    assert type(env).__name__ == "LiftPhysicsEnv"
    assert env.episode_len == configs.BENCH_EPISODE_LEN == 400
    assert env.n_substeps == jenv.n_substeps == configs.BENCH_PHYSICS["n_substeps"]
    assert tuple(env.params) == tuple(jenv.params)
    assert (env.params.dt, env.params.mu, env.params.kt) == (
        configs.BENCH_PHYSICS["dt"], configs.BENCH_PHYSICS["mu"],
        configs.BENCH_PHYSICS["kt"])
    assert env.image_size == 64 and env.render_images


def test_stats_to_tensors_names_its_device():
    """No default device to land on the CPU with."""
    from latent_diffusion_planning_tpu_torch.ops import normalize
    with pytest.raises(TypeError):
        normalize.stats_to_tensors({"a": [1.0]})
    out = normalize.stats_to_tensors({"a": {"min": [1.0], "k": 2}}, "cpu")
    assert out["a"]["min"].device.type == "cpu" and out["a"]["k"] == 2


def test_bench_policy_keys():
    meta = CFG["data"]["meta"]
    want = tuple(meta["lowdim_obs"]) + tuple(
        k[len("latent_"):] for k in meta["rgb_obs"])
    assert configs.BENCH_POLICY_KEYS == want


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_bench_train_config_matches_yaml():
    """The training run's top-level keys, the whole agent (the yaml's
    DDIM-25 eval steps, its optimizer keys) and the data block."""
    got = configs.bench_train_config()
    for k, v in configs.BENCH_TRAIN.items():
        assert got[k] == CFG[k] == v, k
    want = dict(CFG["agent"])
    want.pop("_target_")
    for net in ("planner", "idm_net"):
        want[net] = {k: v for k, v in want[net].items()
                     if k not in ("_target_", "_defer_")}
    agent = dict(got["agent"])
    assert agent.pop("vae_pretrain_path") is None
    assert agent.pop("fused_dtype") == "bfloat16"
    want.pop("vae_pretrain_path")
    assert agent == want
    data = dict(CFG["data"])
    assert data.pop("_target_").endswith("datasets.OfflineData")
    env = dict(data["env_params"]["env"])
    assert env.pop("_target_").endswith("lift_physics.LiftPhysicsEnv")
    data["env_params"] = {**data["env_params"],
                          "env": {"name": "LiftPhysicsEnv", **env}}
    assert got["data"] == data
    assert got is not configs.bench_train_config()
