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


def _plain(tree):
    """A resolved JAX Config as plain dicts and lists, without
    ``_target_``/``_defer_`` (an env's target becomes its ``name``)."""
    if hasattr(tree, "items"):
        out = {k: _plain(v) for k, v in tree.items()
               if k not in ("_target_", "_defer_")}
        if "_target_" in tree and str(tree["_target_"]).endswith("Env"):
            out["name"] = str(tree["_target_"]).rsplit(".", 1)[1]
        return out
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _assert_port_config(got: dict, want: dict, skip=()):
    """Every key the port carries equals the JAX config's; the top level
    may leave out keys the port does not read (run layout, workers)."""
    for k, v in got.items():
        if k in skip:
            continue
        assert k in want, k
        assert v == want[k], k


def test_lift_vae_train_config_matches_the_pipeline():
    """``tools/run_lift_pipeline.sh``'s VAE stage through the JAX config
    system: configs/train_vae.yaml, data lift/img, model stable_vae."""
    from latent_diffusion_planning_tpu.utils.config import load_config
    want = _plain(load_config("train_vae", [
        "data=lift/img", "model.vae.block_out_channels=[64,128,128,128]",
        "model.vae.patch_size=4", "model.vae.norm_groups=16",
        "batch_size=64", "n_grad_steps=4000", "warmup_steps=100", "lr=3e-4",
        "eval_every=2000", "save_every=2000"]))
    got = configs.lift_vae_train_config()
    _assert_port_config(got, want, skip=("model", "data"))
    _assert_port_config(got["model"], want["model"])
    assert set(want["model"]) == set(got["model"])
    _assert_port_config(got["data"], want["data"])
    assert got["model"]["vae"] == configs.BENCH_AGENT["vae"]


def test_lift_dp_vae_train_config_matches_the_baselines():
    """``tools/run_lift_baselines.sh``'s DPVAE stage through the JAX config
    system: configs/train_bc.yaml, agent dp_repr_agent, data
    lift/latent_img."""
    from latent_diffusion_planning_tpu.utils.config import load_config
    vae = "experiments/pipeline3/vae/ckpt/4000.ckpt"
    want = _plain(load_config("train_bc", [
        "agent=dp_repr_agent", "data=lift/latent_img",
        "model_vae.block_out_channels=[64,128,128,128]",
        "model_vae.patch_size=4", "model_vae.norm_groups=16",
        f"agent.vae_pretrain_path={vae}",
        "agent.planner.down_dims=[64,128,256]", "agent.n_diffusion_steps=50",
        "agent.inference_steps=25", "horizon=8", "pred_horizon=8",
        "n_grad_steps=30000", "eval_every=15000", "save_every=15000",
        "resume=true", "data.env_params.env.episode_len=80", "obs_horizon=1",
        "action_horizon=4", "batch_size=128", "warmup_steps=200", "lr=3e-4",
        "n_eval_episodes=256"]))
    got = configs.lift_dp_vae_train_config()
    _assert_port_config(got, want, skip=("agent", "data"))
    assert got["agent"] == want["agent"]
    _assert_port_config(got["data"], want["data"])
    other = configs.lift_dp_vae_train_config(vae_pretrain_path="x.ckpt")
    assert other["agent"]["vae_pretrain_path"] == "x.ckpt"
    assert configs.bench_train_config("v.ckpt")["agent"][
        "vae_pretrain_path"] == "v.ckpt"


def test_lift_dp_train_config_matches_the_baselines():
    """``tools/run_lift_baselines.sh``'s DP stage through the JAX config
    system: configs/train_bc.yaml, agent dp_agent, data lift/img, with
    ``dp_agent.yaml`` under the script's overrides (DDIM-25 sampling among
    them: the yaml's null would be DDPM)."""
    from latent_diffusion_planning_tpu.utils.config import load_config
    want = _plain(load_config("train_bc", [
        "agent=dp_agent", "data=lift/img",
        "agent.planner.down_dims=[64,128,256]", "agent.n_diffusion_steps=50",
        "agent.inference_steps=25", "horizon=8", "pred_horizon=8",
        "n_grad_steps=30000", "eval_every=15000", "save_every=15000",
        "resume=true", "data.env_params.env.episode_len=80", "obs_horizon=1",
        "action_horizon=4", "batch_size=128", "warmup_steps=200", "lr=3e-4",
        "n_eval_episodes=256"]))
    got = configs.lift_dp_train_config()
    _assert_port_config(got, want, skip=("agent", "data"))
    assert got["agent"] == want["agent"]
    assert got["data"] == want["data"]
    assert got["agent"]["encoder"]["stage_sizes"] == [2, 2, 2, 2]
    assert got is not configs.lift_dp_train_config()


def test_lift_ldp_hier_train_config_matches_the_baselines():
    """Stage 3 of ``tools/run_lift_baselines.sh`` through the JAX config
    system (configs/train_bc.yaml, agent ldp_hier_agent, data
    lift/latent_img, at the 15000 steps of its recorded run), and that
    recorded run's own config, ``assets/runs/baselines/ldp_hier/
    config.yaml``: both nets without downsampling, chunks of 4."""
    from latent_diffusion_planning_tpu.utils.config import load_config
    vae = "experiments/pipeline3/vae/ckpt/4000.ckpt"
    want = _plain(load_config("train_bc", [
        "agent=ldp_hier_agent", "data=lift/latent_img",
        "model_vae.block_out_channels=[64,128,128,128]",
        "model_vae.patch_size=4", "model_vae.norm_groups=16",
        f"agent.vae_pretrain_path={vae}",
        "agent.planner.down_dims=[64,128,256]",
        "agent.idm_net.down_dims=[64,128]",
        "agent.planner_n_diffusion_steps=50",
        "agent.idm_n_diffusion_steps=50", "agent.planner_inference_steps=25",
        "agent.idm_inference_steps=25", "horizon=9", "pred_horizon=8",
        "idm_horizon=4", "n_grad_steps=15000", "eval_every=7500",
        "save_every=7500", "resume=true",
        "data.env_params.env.episode_len=80", "obs_horizon=1",
        "action_horizon=4", "batch_size=128", "warmup_steps=200", "lr=3e-4",
        "n_eval_episodes=256"]))
    recorded = _plain(yaml.safe_load(
        (Path(__file__).resolve().parent.parent / "assets" / "runs"
         / "baselines" / "ldp_hier" / "config.yaml").read_text()))
    got = configs.lift_ldp_hier_train_config()
    for reference in (want, recorded):
        _assert_port_config(got, reference, skip=("agent", "data"))
        agent = dict(got["agent"])
        assert agent.pop("fused_dtype") == "bfloat16"
        assert agent == reference["agent"]
        assert got["data"] == reference["data"]
    for net in ("planner", "idm_net"):
        assert got["agent"][net]["downsample"] is False
    assert got["idm_horizon"] == got["agent"]["idm_horizon"] == 4
    other = configs.lift_ldp_hier_train_config(vae_pretrain_path="x.ckpt")
    assert other["agent"]["vae_pretrain_path"] == "x.ckpt"
    assert got is not configs.lift_ldp_hier_train_config()


STUDY_VAE = "experiments/pipeline3/vae/ckpt/4000.ckpt"
# tools/run_lift_mixed_study.sh's $VAE_ARGS and $COMMON
STUDY_COMMON = [
    "model_vae.block_out_channels=[64,128,128,128]", "model_vae.patch_size=4",
    "model_vae.norm_groups=16", f"agent.vae_pretrain_path={STUDY_VAE}",
    "agent.planner.down_dims=[64,128,256]",
    "agent.planner_n_diffusion_steps=50", "agent.idm_n_diffusion_steps=50",
    "agent.planner_inference_steps=25", "agent.idm_inference_steps=25",
    "data.env_params.env.episode_len=80", "horizon=9", "obs_horizon=1",
    "action_horizon=4", "pred_horizon=8", "batch_size=128",
    "n_grad_steps=30000", "warmup_steps=200", "lr=3e-4",
    "n_eval_episodes=512", "eval_every=30000", "save_every=30000",
    "experiment_folder=mixed_study"]
# each arm's config and data sections in the script, N_EXPERT=8
STUDY_ARMS = {
    "expert": ("train_bc", ["agent=ldp_agent", "data=lift/latent_img",
                            "data.train_n_episode_overfit=8"]),
    "mixed": ("train_mixed_bc", [
        "data=lift/latent_img", "data.train_n_episode_overfit=8",
        "mixed_data=lift/mixed_latent_img",
        "mixed_data.train_n_episode_overfit=[8,null]"]),
    "actionfree": ("train_mixed_bc", [
        "data=lift/mixed_latent_img", "data.train_n_episode_overfit=[8,null]",
        "mixed_data=lift/latent_img", "mixed_data.train_n_episode_overfit=8"]),
}


@pytest.mark.parametrize("arm", list(STUDY_ARMS))
def test_lift_mixed_study_config_matches_the_study(arm):
    """Each arm of ``tools/run_lift_mixed_study.sh`` through the JAX config
    system: the planner's stream ``data`` and the IDM's ``mixed_data`` (a
    ``MixedOfflineData`` section carries the port's ``"mixed": true``)."""
    from latent_diffusion_planning_tpu.utils.config import load_config
    name, overrides = STUDY_ARMS[arm]
    want = _plain(load_config(name, overrides + STUDY_COMMON))
    got = configs.lift_mixed_study_config(arm, 8, STUDY_VAE)
    _assert_port_config(got, want, skip=("agent", "data", "mixed_data"))
    agent = dict(got["agent"])
    assert agent.pop("fused_dtype") == "bfloat16"
    assert agent == want["agent"]
    sections = ("data", "mixed_data") if arm != "expert" else ("data",)
    assert ("mixed_data" in got) == ("mixed_data" in want) == (arm != "expert")
    for sec in sections:
        section = dict(got[sec])
        target = load_config(name, overrides + STUDY_COMMON)[sec]["_target_"]
        assert section.pop("mixed", False) == target.endswith(
            "MixedOfflineData"), sec
        assert section == want[sec], sec
    assert got is not configs.lift_mixed_study_config(arm)
    with pytest.raises(ValueError, match="arm"):
        configs.lift_mixed_study_config("other")


def test_lift_collect_data_config_matches_the_study():
    """Stage 1 of the study: configs/collect_data.yaml under the script's
    overrides (256 episodes of 80 steps, noise 0.1, unsuccessful episodes
    kept, seed 123)."""
    from latent_diffusion_planning_tpu.utils.config import load_config
    want = _plain(load_config("collect_data", [
        "run_dir=experiments/pipeline3/ldp", "ckpt_name=10000.ckpt",
        "n_episodes=256", "episode_len=80", "noise=0.1",
        "unsuccessful_only=true", "out_path=datasets/lift/suboptimal.hdf5",
        "seed=123"]))
    assert configs.lift_collect_data_config() == want
