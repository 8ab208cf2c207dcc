"""The Lift recipe's configurations as plain Python dicts.

Copied from ``assets/bench/config.yaml``. ``BENCH_AGENT`` is its ``agent:``
with the bench's fast-inference override: 10 strided DDIM steps for both
planner and IDM (``bench.py``'s ``BENCH_INFERENCE_STEPS`` default).
``bench_train_config()`` is the run that trained it: the top-level training
keys, the whole agent (DDIM-25 at eval, the optimizer keys) and the ``data``
block. ``lift_vae_train_config()`` is the VAE run of
``tools/run_lift_pipeline.sh``; ``lift_dp_train_config()``,
``lift_dp_vae_train_config()`` and ``lift_ldp_hier_train_config()`` are the
DP, DPVAE and LDP-hier runs of ``tools/run_lift_baselines.sh``;
``lift_mixed_study_config(arm)`` the three arms of
``tools/run_lift_mixed_study.sh`` and ``lift_collect_data_config()`` its
collection of the suboptimal corpus, each composed as the JAX package's
config system composes it. The machine with the card has no YAML reader, so
the port carries the dicts; ``tests/test_torch_configs.py`` holds them
against the yaml.
"""

from __future__ import annotations

import copy

OBS_NORMALIZATION = {
    "obs": {
        "robot0_eef_pos": {"min": [-0.25, -0.25, 0.8],
                           "max": [0.25, 0.25, 1.2]},
        "robot0_eef_quat": {"min": [-1.0, -1.0, -1.0, -1.0],
                            "max": [1.0, 1.0, 1.0, 1.0]},
        "robot0_gripper_qpos": {"min": [0.0, -0.05], "max": [0.05, 0.0]},
        "object": {"min": [-0.25, -0.25, 0.75, -1.0, -1.0, -1.0, -1.0,
                           -0.5, -0.5, -0.5],
                   "max": [0.25, 0.25, 1.25, 1.0, 1.0, 1.0, 1.0,
                           0.5, 0.5, 0.5]},
        "agentview_image": {"min": 0, "max": 255},
        "latent_agentview_image": {"min": -8.0, "max": 8.0},
        "optimal": {"min": 0, "max": 1},
    },
    "actions": {"clip_min": -1, "clip_max": 1},
}

SHAPE_META = {
    "ac_dim": 7,
    "all_shapes": {
        "robot0_eef_pos": [3],
        "robot0_eef_quat": [4],
        "robot0_gripper_qpos": [2],
        "object": [10],
        "agentview_image": [64, 64, 3],
        "latent_agentview_image": [16],
        "optimal": [1],
    },
    "use_images": True,
}

BENCH_AGENT = {
    "name": "ldp",
    "planner": {
        "diffusion_step_embed_dim": 256,
        "down_dims": [64, 128, 256],
        "kernel_size": 5,
        "n_groups": 8,
    },
    "idm_net": {
        "time_dim": 64,
        "cond_hidden_dims": [128, 128],
        "n_blocks": 3,
        "hidden_dim": 256,
        "use_layer_norm": True,
    },
    "vae": {
        "block_out_channels": [64, 128, 128, 128],
        "in_channels": 3,
        "out_channels": 3,
        "latent_channels": 4,
        "layers_per_block": 2,
        "norm_groups": 16,
        "use_mid_attention": True,
        "patch_size": 4,
    },
    "vae_feature_dim": 16,
    "use_planner": True,
    "use_idm": True,
    "lowdim_obs": ["robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos"],
    "rgb_obs": ["latent_agentview_image"],
    "obs_normalization": OBS_NORMALIZATION,
    "obs_horizon": 1,
    "pred_horizon": 8,
    "action_horizon": 4,
    "planner_n_diffusion_steps": 50,
    "idm_n_diffusion_steps": 50,
    "planner_prediction_type": "epsilon",
    "idm_prediction_type": "epsilon",
    # bench.py overrides the yaml's 25 with BENCH_INFERENCE_STEPS=10
    "planner_inference_steps": 10,
    "idm_inference_steps": 10,
    # LDPAgent.create's default: the fused planner computes in bf16
    "fused_dtype": "bfloat16",
}

BENCH_ENV = {
    "image_size": 64,
    "render_images": True,
    "episode_len": 80,
}

# The bench env is ``LiftPhysicsEnv``. The yaml gives only the three keys
# above; these are the JAX class's own settings (its constructor defaults
# and the contact parameters it fixes), and ``bench.py`` runs episodes of 400.
BENCH_PHYSICS = {
    "n_substeps": 10,
    "dt": 0.002,
    "mu": 1.5,
    "kt": 2000.0,
}
BENCH_EPISODE_LEN = 400

# what the policy sees (bench.py: lowdim keys + rgb keys without "latent_")
BENCH_POLICY_KEYS = ("robot0_eef_pos", "robot0_eef_quat",
                     "robot0_gripper_qpos", "agentview_image")


def bench_agent_config() -> dict:
    """A fresh deep copy of the bench agent config (callers may edit it)."""
    return copy.deepcopy(BENCH_AGENT)


def make_bench_env(episode_len: int = BENCH_EPISODE_LEN, **overrides):
    """The bench's env: ``LiftPhysicsEnv`` at 64×64, rendering through the
    ray-cast kernel, 10 substeps of 2 ms per control step."""
    from .envs.lift_physics import LiftPhysicsEnv
    kw = dict(BENCH_ENV, episode_len=episode_len,
              n_substeps=BENCH_PHYSICS["n_substeps"], dt=BENCH_PHYSICS["dt"])
    kw.update(overrides)
    env = LiftPhysicsEnv(**kw)
    if (env.params.mu, env.params.kt) != (BENCH_PHYSICS["mu"],
                                          BENCH_PHYSICS["kt"]):
        raise AssertionError("LiftPhysicsEnv's contact parameters left the "
                             "bench's")
    return env


# the training run of assets/bench (tools/run_lift_pipeline.sh): top-level
# keys the Workspace reads
BENCH_TRAIN = {
    "seed": 0,
    "batch_size": 128,
    "lr": 3e-4,
    "end_lr": 1e-6,
    "warmup_steps": 200,
    "n_grad_steps": 30000,
    "grad_clip": None,
    "horizon": 9,
    "obs_horizon": 1,
    "action_horizon": 4,
    "pred_horizon": 8,
    "log_every": 100,
    "save_every": 10000,
    "eval_every": 10000,
    "n_eval_episodes": 64,
    "save_full_state": True,
    "snapshot_path": None,
    "restore_keys": None,
}

# the agent keys the bench run trained with, beyond BENCH_AGENT's
BENCH_AGENT_TRAINING = {
    "data_name": "lift_latent_img64_data",
    "alpha_planner": 1.0,
    "alpha_idm": 1.0,
    "lr": 3e-4,
    "end_lr": 1e-6,
    "idm_lr": 3e-4,
    "idm_end_lr": 1e-6,
    "warmup_steps": 200,
    "decay_steps": 30000,
    "update_planner_every": 1,
    "update_idm_every": 1,
    "update_idm_after": 0,
    "update_planner_until": -1,
    "update_planner_after": 0,
    "grad_clip": None,
    # the yaml's eval steps (bench.py overrides them with 10)
    "planner_inference_steps": 25,
    "idm_inference_steps": 25,
}

BENCH_DATA = {
    "name": "lift_latent_img64_data",
    "batch_size": 128,
    "n_workers": 0,
    "obs_horizon": 1,
    "seq_length": 9,
    "format": "robomimic",
    "train_path": "datasets/lift/demos.hdf5",
    "eval_path": "datasets/lift/demos_eval.hdf5",
    "train_latent_path": "datasets/lift/demos_latent.hdf5",
    "eval_latent_path": "datasets/lift/demos_eval_latent.hdf5",
    "train_n_episode_overfit": None,
    "eval_n_episode_overfit": 10,
    "meta": {
        "lowdim_obs": ["robot0_eef_pos", "robot0_eef_quat",
                       "robot0_gripper_qpos"],
        "rgb_obs": ["latent_agentview_image"],
        "rgb_viz": "agentview_image",
        "shape_meta": SHAPE_META,
        "obs_normalization": OBS_NORMALIZATION,
    },
    "env_params": {
        "obs_horizon": 1,
        "rgb_viz": "agentview_image",
        # the yaml's target is LiftPhysicsEnv
        "env": {"name": "LiftPhysicsEnv", **BENCH_ENV},
    },
}


def bench_train_config(vae_pretrain_path: str | None = None) -> dict:
    """A fresh deep copy of the bench's training run: ``BENCH_TRAIN``, the
    agent (``BENCH_AGENT`` with ``BENCH_AGENT_TRAINING``) and ``data``.
    ``vae_pretrain_path`` names a snapshot of the VAE run
    (``lift_vae_train_config()``); unset, the VAE keeps its seeded
    weights."""
    agent = bench_agent_config()
    agent.update(copy.deepcopy(BENCH_AGENT_TRAINING),
                 vae_pretrain_path=vae_pretrain_path)
    return copy.deepcopy({**BENCH_TRAIN, "agent": agent, "data": BENCH_DATA})


# -- the VAE run: configs/train_vae.yaml with model/stable_vae and
# data/lift/img, under tools/run_lift_pipeline.sh's overrides

def _without_latents(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if not k.startswith("latent_")}


LIFT_IMG_DATA = {
    "name": "lift_img64_data",
    "batch_size": 64,
    "n_workers": 0,
    "obs_horizon": 1,
    "seq_length": 2,
    "format": "robomimic",
    "train_path": "datasets/lift/demos.hdf5",
    "eval_path": "datasets/lift/demos_eval.hdf5",
    "train_n_episode_overfit": None,
    "eval_n_episode_overfit": 10,
    "meta": {
        "lowdim_obs": ["robot0_eef_pos", "robot0_eef_quat",
                       "robot0_gripper_qpos"],
        "rgb_obs": ["agentview_image"],
        "rgb_viz": "agentview_image",
        "shape_meta": {**SHAPE_META,
                       "all_shapes": _without_latents(SHAPE_META["all_shapes"])},
        "obs_normalization": {
            **OBS_NORMALIZATION,
            "obs": _without_latents(OBS_NORMALIZATION["obs"])},
    },
    "env_params": {
        "obs_horizon": 1,
        "rgb_viz": "agentview_image",
        "env": {"name": "LiftPhysicsEnv", **BENCH_ENV, "episode_len": 400},
    },
}

LIFT_VAE_TRAIN = {
    "seed": 0,
    "batch_size": 64,
    "lr": 3e-4,
    "end_lr": 1e-6,
    "warmup_steps": 100,
    "n_grad_steps": 4000,
    "horizon": 2,
    "obs_horizon": 1,
    "action_horizon": 1,
    "pred_horizon": 1,
    "log_every": 100,
    "save_every": 2000,
    "eval_every": 2000,
    "n_eval_batches": 10,
    "n_eval_episodes": 0,
    "save_full_state": True,
    "snapshot_path": None,
}

LIFT_VAE_MODEL = {
    "name": "stable_vae",
    "vae": BENCH_AGENT["vae"],
    "use_kl": True,
    "beta": 1e-5,
    "image_size": 64,
    "rgb_obs": ["agentview_image"],
    "obs_normalization": LIFT_IMG_DATA["meta"]["obs_normalization"],
    "data_name": "lift_img64_data",
    "lr": 3e-4,
    "end_lr": 1e-6,
    "warmup_steps": 100,
    "decay_steps": 4000,
    "ema_decay": 0.99,
}


def lift_vae_train_config() -> dict:
    """A fresh deep copy of the Lift recipe's VAE run: ``LIFT_VAE_TRAIN``,
    ``model`` (the KLVAE at the bench widths, β 1e-5, EMA 0.99) and
    ``data`` (raw 64×64 frames, windows of 2)."""
    return copy.deepcopy({**LIFT_VAE_TRAIN, "model": LIFT_VAE_MODEL,
                          "data": LIFT_IMG_DATA})


# -- the DPVAE run: configs/train_bc.yaml with agent/dp_repr_agent and
# data/lift/latent_img, under tools/run_lift_baselines.sh's overrides

LIFT_DP_VAE_TRAIN = {
    "seed": 0,
    "batch_size": 128,
    "lr": 3e-4,
    "end_lr": 1e-6,
    "warmup_steps": 200,
    "n_grad_steps": 30000,
    "grad_clip": None,
    "horizon": 8,
    "obs_horizon": 1,
    "action_horizon": 4,
    "pred_horizon": 8,
    "log_every": 100,
    "save_every": 15000,
    "eval_every": 15000,
    "n_eval_episodes": 256,
    "save_full_state": True,
    "snapshot_path": None,
    "restore_keys": None,
    "resume": True,
}

LIFT_DP_VAE_AGENT = {
    "name": "dp_vae",
    "planner": BENCH_AGENT["planner"],
    "vae": BENCH_AGENT["vae"],
    "vae_pretrain_path": "experiments/pipeline3/vae/ckpt/4000.ckpt",
    "vae_feature_dim": 16,
    "lowdim_obs": BENCH_AGENT["lowdim_obs"],
    "rgb_obs": BENCH_AGENT["rgb_obs"],
    "obs_normalization": OBS_NORMALIZATION,
    "obs_horizon": 1,
    "pred_horizon": 8,
    "action_horizon": 4,
    "n_diffusion_steps": 50,
    "inference_steps": 25,
    "lr": 3e-4,
    "end_lr": 1e-6,
    "warmup_steps": 200,
    "decay_steps": 30000,
    "random_shift": 0,
    "use_ema": False,
    "ema_decay": 0.75,
}


def lift_dp_vae_train_config(vae_pretrain_path: str | None = None) -> dict:
    """A fresh deep copy of the Lift baselines' DPVAE run:
    ``LIFT_DP_VAE_TRAIN``, the agent (an action U-Net [64,128,256], DDPM-50
    training and DDIM-25 sampling, over the bench VAE's latents) and the
    bench's latent ``data`` with windows of 8. ``vae_pretrain_path``
    replaces the script's snapshot path when given."""
    agent = copy.deepcopy(LIFT_DP_VAE_AGENT)
    if vae_pretrain_path is not None:
        agent["vae_pretrain_path"] = vae_pretrain_path
    return copy.deepcopy({**LIFT_DP_VAE_TRAIN, "agent": agent,
                          "data": dict(BENCH_DATA, seq_length=8)})


# -- the DP run: configs/train_bc.yaml with agent/dp_agent and data/lift/img,
# under stage 1 of tools/run_lift_baselines.sh's overrides (its top-level
# keys are the DPVAE run's: the script gives both the same ones)

LIFT_DP_AGENT = {
    "name": "dp",
    "planner": BENCH_AGENT["planner"],
    # ResNet-18 with GroupNorm and a spatial-softmax head (1024 features)
    "encoder": {
        "stage_sizes": [2, 2, 2, 2],
        "block_cls": "ResNetBlock",
        "n_filters": 64,
        "norm": "group",
        "act": "relu",
        "pooling_method": "spatial_softmax",
        "softmax_temperature": 1.0,
        "n_spatial_blocks": 8,
    },
    "lowdim_obs": BENCH_AGENT["lowdim_obs"],
    "rgb_obs": ["agentview_image"],
    "obs_normalization": LIFT_IMG_DATA["meta"]["obs_normalization"],
    "obs_horizon": 1,
    "pred_horizon": 8,
    "action_horizon": 4,
    "n_diffusion_steps": 50,
    # dp_agent.yaml leaves null (DDPM), which kernel B refuses; the recipe
    # sets 25
    "inference_steps": 25,
    "lr": 3e-4,
    "end_lr": 1e-6,
    "warmup_steps": 200,
    "decay_steps": 30000,
    "shared_encoder": False,
    "planner_ema_decay": 0.75,
    "encoder_ema_decay": 0.75,
    "use_ema": False,
}


def lift_dp_train_config() -> dict:
    """A fresh deep copy of the Lift baselines' DP run: ``LIFT_DP_VAE_TRAIN``,
    the agent (ResNet-18 on the raw 64×64 frame, trained end to end with an
    action U-Net [64,128,256]; DDPM-50 training, DDIM-25 sampling) and the
    raw-frame ``data`` with windows of 8 at batch 128, its closed loop 80
    steps long."""
    data = copy.deepcopy(LIFT_IMG_DATA)
    data.update(seq_length=8, batch_size=LIFT_DP_VAE_TRAIN["batch_size"])
    data["env_params"]["env"]["episode_len"] = BENCH_ENV["episode_len"]
    return copy.deepcopy({**LIFT_DP_VAE_TRAIN, "agent": LIFT_DP_AGENT,
                          "data": data})


# -- the LDP-hier run: stage 3 of tools/run_lift_baselines.sh
# (configs/train_bc.yaml with agent/ldp_hier_agent and data/lift/latent_img;
# its recorded run, assets/runs/baselines/ldp_hier/config.yaml, took 15000
# steps): a strided planner and a chunk-decoding U-Net IDM, neither of which
# downsamples

LIFT_LDP_HIER_TRAIN = {
    **LIFT_DP_VAE_TRAIN,
    "n_grad_steps": 15000,
    "horizon": 9,
    "idm_horizon": 4,
    "save_every": 7500,
    "eval_every": 7500,
}

LIFT_LDP_HIER_AGENT = {
    "name": "ldp_hier",
    "planner": {**BENCH_AGENT["planner"], "downsample": False},
    "idm_net": {
        "diffusion_step_embed_dim": 256,
        "down_dims": [64, 128],
        "kernel_size": 3,
        "n_groups": 8,
        "downsample": False,
    },
    "idm_horizon": 4,
    "vae": BENCH_AGENT["vae"],
    "vae_pretrain_path": "experiments/pipeline3/vae/ckpt/4000.ckpt",
    "vae_feature_dim": 16,
    "use_planner": True,
    "use_idm": True,
    "lowdim_obs": BENCH_AGENT["lowdim_obs"],
    "rgb_obs": BENCH_AGENT["rgb_obs"],
    "obs_normalization": OBS_NORMALIZATION,
    "data_name": BENCH_DATA["name"],
    "obs_horizon": 1,
    "pred_horizon": 8,
    "action_horizon": 4,
    "planner_n_diffusion_steps": 50,
    "idm_n_diffusion_steps": 50,
    "planner_inference_steps": 25,
    "idm_inference_steps": 25,
    "alpha_planner": 1.0,
    "alpha_idm": 1.0,
    "lr": 3e-4,
    "end_lr": 1e-6,
    "idm_lr": 3e-4,
    "idm_end_lr": 1e-6,
    "warmup_steps": 200,
    "decay_steps": 15000,
    "update_planner_every": 1,
    "update_idm_every": 1,
    "update_idm_after": 0,
    "update_planner_until": -1,
    "update_planner_after": 0,
    "grad_clip": None,
    # LDPHierAgent.create's default: kernel B computes in bf16
    "fused_dtype": "bfloat16",
}


def lift_ldp_hier_train_config(vae_pretrain_path: str | None = None) -> dict:
    """A fresh deep copy of the Lift baselines' LDP-hier run:
    ``LIFT_LDP_HIER_TRAIN`` (15000 steps at batch 128, windows of 9), the
    agent (planner [64,128,256] k 5 over P = 8 // 4 = 2 strided latents,
    chunk IDM [64,128] k 3 over chunks of 4 actions, neither downsampling;
    DDPM-50 training, DDIM-25 sampling, over the bench VAE's latents) and
    the bench's latent ``data``. ``vae_pretrain_path`` replaces the
    script's snapshot path when given."""
    agent = copy.deepcopy(LIFT_LDP_HIER_AGENT)
    if vae_pretrain_path is not None:
        agent["vae_pretrain_path"] = vae_pretrain_path
    return copy.deepcopy({**LIFT_LDP_HIER_TRAIN, "agent": agent,
                          "data": BENCH_DATA})


# -- the mixed-data study: tools/run_lift_mixed_study.sh. The planner trains
# on ``data``, the IDM on ``mixed_data``: expert (train_bc.yaml: both are
# the expert demos), mixed (train_mixed_bc.yaml: the IDM's stream adds the
# suboptimal corpus with its actions) and actionfree (the planner's stream
# adds the suboptimal corpus, whose actions it never reads; the IDM's stays
# expert). A section with "mixed": true is a MixedOfflineData.

# data/lift/mixed_latent_img.yaml: expert demos first, then the suboptimal
# corpus that lift_collect_data_config() collects
LIFT_MIXED_DATA = {
    "mixed": True,
    "name": "lift_mixed_latent_img64_data",
    "batch_size": 128,
    "n_workers": 0,
    "obs_horizon": 1,
    "seq_length": 9,
    "format": "robomimic",
    "train_paths": ["datasets/lift/demos.hdf5",
                    "datasets/lift/suboptimal.hdf5"],
    "eval_paths": "datasets/lift/demos_eval.hdf5",
    "train_latent_paths": ["datasets/lift/demos_latent.hdf5",
                           "datasets/lift/suboptimal_latent.hdf5"],
    "eval_latent_paths": "datasets/lift/demos_eval_latent.hdf5",
    "train_n_episode_overfit": [None, None],
    "eval_n_episode_overfit": 10,
    "train_split": 0.5,
    "eval_split": 0.5,
    "meta": BENCH_DATA["meta"],
    "env_params": BENCH_DATA["env_params"],
}

MIXED_STUDY_ARMS = ("expert", "mixed", "actionfree")


def lift_mixed_study_config(arm: str, n_expert: int = 8,
                            vae_pretrain_path: str | None = None) -> dict:
    """A fresh deep copy of one arm of the mixed-data study (``arm`` in
    ``MIXED_STUDY_ARMS``): ``bench_train_config`` under the study's keys
    (30000 steps, an eval of 512 episodes at the end) with ``n_expert``
    expert demos. The section that only reads the expert demos keeps its
    yaml's 400-step eval episodes (the script overrides ``data``'s only)."""
    if arm not in MIXED_STUDY_ARMS:
        raise ValueError(f"arm {arm!r} is not one of {MIXED_STUDY_ARMS}")
    cfg = bench_train_config(vae_pretrain_path)
    cfg.update(n_grad_steps=30000, eval_every=30000, save_every=30000,
               n_eval_episodes=512)
    expert = copy.deepcopy(BENCH_DATA)
    expert["train_n_episode_overfit"] = n_expert
    mixed = copy.deepcopy(LIFT_MIXED_DATA)
    mixed["train_n_episode_overfit"] = [n_expert, None]
    if arm == "expert":
        cfg["data"] = expert
    elif arm == "mixed":
        cfg["data"] = expert
        mixed["env_params"]["env"]["episode_len"] = 400
        cfg["mixed_data"] = mixed
    else:
        cfg["data"] = mixed
        cfg["agent"]["data_name"] = mixed["name"]
        expert["env_params"]["env"]["episode_len"] = 400
        cfg["mixed_data"] = expert
    return cfg


# configs/collect_data.yaml under the study's overrides: the suboptimal
# corpus is an intermediate LDP checkpoint rolled out with action noise 0.1,
# its unsuccessful episodes kept
LIFT_COLLECT_DATA = {
    "run_dir": "experiments/pipeline3/ldp",
    "ckpt_name": "10000.ckpt",
    "n_episodes": 256,
    "episode_len": 80,
    "noise": 0.1,
    "successful_only": False,
    "unsuccessful_only": True,
    "max_demos": None,
    "out_path": "datasets/lift/suboptimal.hdf5",
    "seed": 123,
}


def lift_collect_data_config() -> dict:
    """A fresh copy of the study's collection of its suboptimal corpus."""
    return copy.deepcopy(LIFT_COLLECT_DATA)
