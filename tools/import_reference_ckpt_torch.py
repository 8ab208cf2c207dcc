#!/usr/bin/env python
"""Read reference-named weights into a port checkpoint.

The port's counterpart of ``tools/import_reference_ckpt.py``:

    python tools/import_reference_ckpt_torch.py src=ref_agent.npz \
        dst=imported/agent.ckpt [run_dir=RUN]

``src`` is a flat ``.npz`` of reference-named trees, key ``<name>_params/
<Flax path>`` (what ``tools/export_reference_ckpt_torch.py`` writes; a
reference checkpoint converted to this form on a machine that reads its
own format). Each tree is renamed into the JAX package's Flax naming
(``train/transfer.py``) and loaded into a copy of the matching net of the
agent that ``run_dir``'s ``config.json`` builds (the bench agent without
``run_dir``) through ``bridge.load_*``:

- ``planner_params`` (``ConditionalUnet1D`` naming) and ``idm_params``;
- a diffusers ``FlaxAutoencoderKL`` tree (``vae_params`` or
  ``vae_ema_params``; the EMA tree wins, since the reference encodes its
  datasets with it) becomes ``vae_params``, for a ``KLVAE`` configured
  with ``downsample_pad: diffusers``;
- the planner's and IDM's EMA trees are skipped: the reference's restore
  copies the plain weights into the EMA.

``dst`` is a port snapshot (``{<name>_params: state_dict}``) that
``apply_params_snapshot`` applies.
"""

import copy
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from latent_diffusion_planning_tpu_torch import bridge  # noqa: E402
from latent_diffusion_planning_tpu_torch.drivers import run_agent  # noqa: E402
from latent_diffusion_planning_tpu_torch.train import transfer  # noqa: E402
from latent_diffusion_planning_tpu_torch.train.checkpoint import (  # noqa: E402
    Checkpointer)


def _is_diffusers_vae(tree) -> bool:
    return isinstance(tree, dict) and {"encoder", "decoder"} <= set(tree)


def convert(snapshot: dict, agent) -> dict:
    """Reference-named trees ``{<name>_params: tree}`` → the port's
    ``{<name>_params: state_dict}`` for ``agent``'s nets (the agent is
    left as it is)."""
    out, vaes = {}, {}
    for key, tree in snapshot.items():
        is_ema = "ema" in key
        if _is_diffusers_vae(tree):
            levels = len(agent.vae.encoder.levels)
            per_level = len(agent.vae.encoder.levels[0])
            vaes[is_ema] = transfer.map_diffusers_vae_params(
                tree, [None] * levels, per_level)
        elif is_ema:
            continue
        elif key == "planner_params":
            net = copy.deepcopy(agent.planner)
            bridge.load_unet1d(net, transfer.map_unet1d_params(
                tree, net.down_dims))
            out[key] = net.state_dict()
        elif key == "idm_params":
            net = copy.deepcopy(agent.idm)
            bridge.load_mlp_diffusion(net, transfer.map_mlp_diffusion_params(
                tree))
            out[key] = net.state_dict()
        else:
            raise KeyError(f"no port net takes reference tree {key!r}")
    if vaes:
        vae = copy.deepcopy(agent.vae)
        bridge.load_klvae(vae, vaes.get(True, vaes.get(False)))
        out["vae_params"] = vae.state_dict()
    return out


def main(argv=None) -> None:
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:]))
    src, dst = Path(args["src"]), Path(args.get("dst", "imported.ckpt"))
    with np.load(src) as f:
        snapshot = transfer._unflat({k: f[k] for k in f.files})
    converted = convert(snapshot, run_agent(args.get("run_dir"), "cpu"))
    path = Checkpointer(dst.parent).save_params(0, converted)
    path.replace(dst)
    print(f"[import] wrote {sorted(converted)} -> {dst}")


if __name__ == "__main__":
    main()
