"""The bench agent and env configuration as plain Python dicts.

Copied from ``assets/bench/config.yaml`` (``agent:`` and
``data.env_params``) with the bench's fast-inference override: 10 strided
DDIM steps for both planner and IDM (``bench.py``'s
``BENCH_INFERENCE_STEPS`` default). The machine with the card has no YAML
reader, so the port carries the dict; ``tests/test_torch_configs.py`` holds
it against the yaml.
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
