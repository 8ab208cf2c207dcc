"""β-VAE training from the command line.

Counterpart of ``tools/train_vae.py``: ``train/vae_loop.VAEWorkspace`` over
the config's ``model`` and ``data`` (default ``model/stable_vae`` on
``data/lift/img``), in ``<experiment_root>/<experiment_folder>/
<experiment_name>``; snapshots ``ckpt/<step>.ckpt`` hold ``{vae_params,
vae_ema_params}``, what ``process_latents`` and an agent's
``vae_pretrain_path`` read.
"""

from __future__ import annotations

from ..train.vae_loop import VAEWorkspace
from . import load, run_dir


def main(argv: list[str] | None = None) -> None:
    cfg = load("train_vae", argv)
    VAEWorkspace(cfg, run_dir(cfg, "vae"), device=cfg.get("device")).run()
