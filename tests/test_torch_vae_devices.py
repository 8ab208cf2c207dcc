"""``tools/compare_vae_devices_torch.py``'s machinery on the CPU at tiny
widths: the lockstep stream does not depend on the process (one arm run
twice is one trainer, bit for bit), the permuted-rows yardstick parts from
its reference by rounding alone, and a trainer with a deliberate fault (the
learning rate 1% high) leaves the rule's bar at two successive prints."""

import sys
from pathlib import Path

import numpy as np
import pytest

from latent_diffusion_planning_tpu_torch.data import writer
from torch_thread import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import compare_vae_devices_torch as cvd  # noqa: E402

TINY = ["model.vae.block_out_channels=[8,16]", "model.vae.norm_groups=4",
        "batch_size=16"]
STEPS, EVERY = 40, 10


def _demos(path, n, seed):
    rng = np.random.default_rng(seed)
    T = 12
    obs = {"agentview_image": rng.integers(0, 256, (n, T, 64, 64, 3),
                                           dtype=np.uint8),
           "robot0_eef_pos": rng.normal(size=(n, T, 3)),
           "robot0_eef_quat": rng.normal(size=(n, T, 4)),
           "robot0_gripper_qpos": rng.normal(size=(n, T, 2))}
    writer.write_trajectories(path, {
        "first_obs": {k: v[:, 0] for k, v in obs.items()}, "obs": obs,
        "actions": rng.normal(size=(n, T, 7)),
        "rewards": np.zeros((n, T)), "success": np.zeros((n, T))})
    return path


def _slow_lr(model):
    schedule = model.vae_state.schedule
    model.vae_state.schedule = lambda c: 1.01 * schedule(c)


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    root = tmp_path_factory.mktemp("lockstep")
    train = _demos(root / "demos.npz", 4, 0)
    eval_ = _demos(root / "demos_eval.npz", 10, 1)
    for name, permute, tweak in (("cpu", False, None), ("cpu_again", False,
                                                        None),
                                 ("cpu_perm", True, None),
                                 ("faulty", False, _slow_lr)):
        cvd.run_arm(root / name, "cpu", permute, train, eval_, STEPS,
                    every=EVERY, overrides=TINY, tweak=tweak)
    return root


def test_lockstep_of_one_trainer_is_bit_for_bit(arms):
    out = cvd.report(arms, arm="cpu_again")
    assert len(out["rows"]) == STEPS // EVERY + 1
    assert all(r["params"]["cpu_again_vs_cpu"] == 0 for r in out["rows"])
    assert all(r["readings"]["cpu_again"] == r["readings"]["cpu"]
               for r in out["rows"])
    assert out["verdict"] == "the same function"


def test_permuted_rows_part_by_rounding(arms):
    """The yardstick moves off its reference (another order of the batch's
    sums) and stays within 1e-4 of each tensor over the run."""
    out = cvd.report(arms, arm="cpu_again")
    far = [r["params"]["cpu_perm_vs_cpu"] for r in out["rows"][1:]]
    assert all(0 < d <= 1e-4 for d in far), far
    assert max(r["ema"]["cpu_perm_vs_cpu"] for r in out["rows"]) <= 1e-4


def test_deliberate_fault_leaves_the_bar(arms):
    out = cvd.report(arms, arm="faulty")
    ratios = [r["ratio"] for r in out["rows"][1:]]
    assert min(ratios) > cvd.K, ratios
    assert out["verdict"] == "another function"
