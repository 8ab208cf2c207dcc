"""The bench agent, env and training configuration as plain Python dicts.

Copied from ``assets/bench/config.yaml``. ``BENCH_AGENT`` is its ``agent:``
with the bench's fast-inference override: 10 strided DDIM steps for both
planner and IDM (``bench.py``'s ``BENCH_INFERENCE_STEPS`` default).
``bench_train_config()`` is the run that trained it: the top-level training
keys, the whole agent (DDIM-25 at eval, the optimizer keys) and the ``data``
block. The machine with the card has no YAML reader, so the port carries the
dicts; ``tests/test_torch_configs.py`` holds them against the yaml.
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


def bench_train_config() -> dict:
    """A fresh deep copy of the bench's training run: ``BENCH_TRAIN``, the
    agent (``BENCH_AGENT`` with ``BENCH_AGENT_TRAINING``) and ``data``. The
    VAE is not trained by the port yet: ``agent.vae_pretrain_path`` is unset
    and the VAE keeps its seeded weights unless a caller restores some."""
    agent = bench_agent_config()
    agent.update(copy.deepcopy(BENCH_AGENT_TRAINING), vae_pretrain_path=None)
    return copy.deepcopy({**BENCH_TRAIN, "agent": agent, "data": BENCH_DATA})
