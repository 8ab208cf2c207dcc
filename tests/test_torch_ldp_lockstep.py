"""The LDP stage's trainer in both packages, stepped together on the CPU
(``tools/compare_ldp_trainers.py --lockstep`` at narrow widths): one init
(JAX's, carried over by ``bridge.py``), one stream of windows, JAX's
draws handed to the port; the weights and losses of the two stay within
float rounding of each other.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import compare_ldp_trainers as cmp  # noqa: E402
from torch_thread import one_torch_thread  # noqa: E402,F401

NARROW = ["agent.planner.down_dims=[16,32]", "agent.planner.n_groups=4",
          "agent.planner.diffusion_step_embed_dim=32",
          "agent.idm_net.hidden_dim=64", "agent.idm_net.n_blocks=2",
          "agent.idm_net.time_dim=16", "agent.idm_net.cond_hidden_dims=[32,32]",
          "model_vae.block_out_channels=[8,16,16,16]", "model_vae.norm_groups=4",
          "batch_size=16", "warmup_steps=5", "n_grad_steps=60", "lr=3e-5"]
STEPS = 30


@pytest.fixture(scope="module")
def rows():
    cfg = cmp.port_config(cmp.LDP_ARGS + NARROW)
    agent_cfg = dict(cfg["agent"])
    shape_meta = cfg["data"]["meta"]["shape_meta"]
    dims = shape_meta["all_shapes"]
    batches = cmp.synthetic_batches(
        cfg["batch_size"], cfg["horizon"],
        {k: dims[k][0] for k in agent_cfg["lowdim_obs"]},
        {k: dims[k][0] for k in agent_cfg["rgb_obs"]},
        shape_meta["ac_dim"])
    return cmp.lockstep(agent_cfg, shape_meta, batches, STEPS, every=10,
                        log=lambda _: None)


def test_lockstep_runs_the_recipe_stage(rows):
    """The stage is the Can recipe's (horizon 9, DDPM-50 both nets, the
    warm-up cosine over the run) at narrow widths: a row every 10 steps,
    and both packages' schedules give the same learning rate."""
    assert [r["step"] for r in rows] == [10, 20, 30]
    for r in rows:
        assert r["lr_diff"] <= 1e-9


@pytest.mark.parametrize("net", ["planner", "idm"])
def test_trainers_stay_together(rows, net):
    """Each net's weights after every 10 steps: within 1e-5 of JAX's
    element by element and 1e-4 relative by tensor norm; the losses the
    two report within 1e-4. At a tenth of the recipe's learning rate: at
    its full rate on random 16-window batches a relative nudge of 1e-7
    already moves the IDM by 3e-5 within three steps (a ReLU's input
    crossing zero), so there only the control's distance can bound the
    two (``tools/compare_ldp_trainers.py`` prints it beside them)."""
    for r in rows:
        assert r[f"{net}_max_abs"] <= 1e-5, (r["step"], r[f"{net}_max_abs"])
        assert r[f"{net}_max_rel"] <= 1e-4, (r["step"], r[f"{net}_max_rel"])
    for k in ("plan_loss", "idm_loss"):
        assert max(r[f"{k}_diff"] for r in rows) <= 1e-4
