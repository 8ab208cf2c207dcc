#!/usr/bin/env python
"""Write a port checkpoint's weights in the reference's parameter naming.

The port's counterpart of ``tools/export_reference_ckpt.py``:

    python tools/export_reference_ckpt_torch.py src=RUN/ckpt/30000.ckpt \
        dst=exported/ref_agent.npz [run_dir=RUN] [export_vae=true]

``src`` is a snapshot the port wrote (``Checkpointer.save_params``: a
``{<name>_params: state_dict}`` file). Its weights go onto the agent that
``run_dir``'s ``config.json`` builds (the bench agent,
``configs.bench_agent_config``, when ``run_dir`` is not given), leave the
port's modules in the JAX package's Flax naming (``bridge.export_*``) and
are renamed into the reference implementation's (``train/transfer.py``):

- ``planner_params`` → ``networks/diffusion_nets_v2.ConditionalUnet1D``;
- ``idm_params`` → ``networks/mlp_diffusion_nets.MLPDiffusion`` (the same
  naming);
- ``vae_params`` → ``diffusers.FlaxAutoencoderKL`` naming with
  ``export_vae=true``, for a VAE of the reference's shape (patch size 1);
  dropped otherwise, as reference agent snapshots carry no VAE.

The file is a flat ``.npz`` (no orbax or msgpack where the port runs): key
``<name>_params/<Flax path>``, float32 arrays, Flax layouts.
``tools/import_reference_ckpt_torch.py`` reads it back, bit for bit.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from latent_diffusion_planning_tpu_torch import bridge  # noqa: E402
from latent_diffusion_planning_tpu_torch.drivers import run_agent  # noqa: E402
from latent_diffusion_planning_tpu_torch.train import transfer  # noqa: E402
from latent_diffusion_planning_tpu_torch.train.checkpoint import (  # noqa: E402
    Checkpointer, apply_params_snapshot)


def vae_levels(vae) -> tuple[int, int]:
    """(levels, resnet blocks a level) of a ``KLVAE``'s encoder, what the
    diffusers map is sized by."""
    return len(vae.encoder.levels), len(vae.encoder.levels[0])


def export(agent, export_vae: bool = False) -> dict:
    """The agent's planner, IDM and (``export_vae``) VAE weights as
    reference-named trees ``{<name>_params: tree}``."""
    out = {"planner_params": transfer.export_unet1d_params(
               bridge.export_unet1d(agent.planner), agent.planner.down_dims),
           "idm_params": transfer.export_mlp_diffusion_params(
               bridge.export_mlp_diffusion(agent.idm))}
    if export_vae:
        levels, per_level = vae_levels(agent.vae)
        out["vae_params"] = transfer.export_diffusers_vae_params(
            bridge.export_klvae(agent.vae), [None] * levels, per_level)
    return out


def main(argv=None) -> None:
    args = dict(a.split("=", 1) for a in (argv or sys.argv[1:]))
    src, dst = Path(args["src"]), Path(args.get("dst", "exported_ckpt.npz"))
    agent = run_agent(args.get("run_dir"), "cpu")
    apply_params_snapshot(agent, Checkpointer(src.parent).restore_raw(src))
    flat = transfer._flat(export(
        agent, args.get("export_vae", "false").lower() == "true"))
    dst.parent.mkdir(parents=True, exist_ok=True)
    np.savez(dst, **flat)
    print(f"[export] wrote {len(flat)} arrays of "
          f"{sorted({k.split('/')[0] for k in flat})} -> {dst}")


if __name__ == "__main__":
    main()
