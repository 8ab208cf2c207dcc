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
