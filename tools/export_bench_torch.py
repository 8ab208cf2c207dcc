#!/usr/bin/env python
"""Convert the committed bench checkpoint into the PyTorch port's format.

    python tools/export_bench_torch.py [--out build/bench_torch]

``assets/bench/agent.ckpt`` is an orbax checkpoint, which only a machine with
JAX and orbax can read. This tool runs on such a machine: it restores the
snapshot with the JAX package's ``Checkpointer.restore_raw``, builds the
port's agent from it through ``bridge.ldp_agent_from_flax`` and writes
``agent.get_params()`` with the port's ``Checkpointer.save_params`` as
``<out>/30000.ckpt`` (``torch.save`` of state dicts, 55.9 MB: the planner,
the IDM and the whole VAE, its encoder and its decoder). ``build/`` is
git-ignored, so the export is not committed; a machine without JAX reads it
with ``Checkpointer.restore_raw`` and ``apply_params_snapshot``
(``tools/eval_bench_torch.py``).
"""

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STEP = 30000        # the bench run's n_grad_steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "bench_torch")
    args = ap.parse_args()
    import jax
    import numpy as np
    from latent_diffusion_planning_tpu.train.checkpoint import (
        Checkpointer as JaxCheckpointer)
    from latent_diffusion_planning_tpu_torch import bridge, configs
    from latent_diffusion_planning_tpu_torch.train.checkpoint import Checkpointer

    ckpt = REPO / "assets" / "bench"
    snap = JaxCheckpointer(ckpt).restore_raw(ckpt / "agent.ckpt")
    snap = jax.tree_util.tree_map(np.asarray, snap)
    agent = bridge.ldp_agent_from_flax(snap, configs.bench_agent_config(),
                                       configs.SHAPE_META, device="cpu")
    path = Checkpointer(args.out).save_params(STEP, agent.get_params())
    n = sum(v.numel() for p in agent.get_params().values() for v in p.values())
    print(f"wrote {path} ({n} parameters, {path.stat().st_size / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
