"""Single-dataset BC training from the command line.

Counterpart of ``tools/train_bc.py``: ``[--config train_bc] agent=ldp_agent
data=lift/latent_img key=value ...`` → the ``Workspace`` in
``<experiment_root>/<experiment_folder>/<experiment_name>``.
"""

from __future__ import annotations

from ..train.loop import Workspace
from . import load, run_dir


def main(argv: list[str] | None = None) -> None:
    cfg = load("train_bc", argv)
    Workspace(cfg, run_dir(cfg, "default"), device=cfg.get("device")).run()
