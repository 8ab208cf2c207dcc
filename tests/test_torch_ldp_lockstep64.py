"""The LDP stage's trainer in both packages in float64, at the recipe's
learning rate (``tools/compare_ldp_trainers.py --lockstep --float64`` at
narrow widths, in a process of its own: the option retypes both packages
for the process it runs in). In float32 the IDM's ReLUs amplify rounding
at this rate, so only the nudged control bounds the two there; in float64
rounding starts near 1e-16, and a difference in the update would stand
far out of it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_ldp_lockstep import NARROW

TOOL = Path(__file__).resolve().parent.parent / "tools" / "compare_ldp_trainers.py"
STEPS = 20


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("lockstep64")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    recipe_lr = [a for a in NARROW if not a.startswith("lr=")]
    subprocess.run([sys.executable, str(TOOL), "--lockstep", str(STEPS),
                    "--every", "10", "--float64", "--out", str(out),
                    *recipe_lr], check=True, env=env, capture_output=True,
                   timeout=600)
    return json.loads((out / "lockstep64.json").read_text())


@pytest.mark.parametrize("net", ["planner", "idm"])
def test_float64_trainers_stay_together(rows, net):
    """Each net's weights after 10 and 20 steps at the recipe's lr (3e-4):
    within 1e-12 of JAX's relative by tensor norm, no further than the
    control (a relative 1e-14 nudge of the init) has moved, and the losses
    and learning rates the two report within 1e-12."""
    assert [r["step"] for r in rows] == [10, 20]
    for r in rows:
        assert r[f"{net}_max_rel"] <= 1e-12, (r["step"], r[f"{net}_max_rel"])
        assert r[f"{net}_max_rel"] <= r[f"control_{net}_max_rel"]
        for k in ("plan_loss_diff", "idm_loss_diff", "lr_diff"):
            assert r[k] <= 1e-12, (r["step"], k, r[k])
