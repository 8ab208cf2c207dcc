"""Mixed-data BC training from the command line.

Counterpart of ``tools/train_mixed_bc.py``: the ``Workspace`` with a second
stream, ``mixed_data``, which the IDM trains on while the planner trains on
``data`` (``update_mixed``). The action-free arm is the same driver with
the streams swapped (``--config train_mixed_bc_actionfree``, or the
study's group overrides).
"""

from __future__ import annotations

from ..train.loop import Workspace
from ..utils.config import ConfigError
from . import load, run_dir


def main(argv: list[str] | None = None) -> None:
    cfg = load("train_mixed_bc", argv)
    if "mixed_data" not in cfg:
        raise ConfigError("train_mixed_bc needs a mixed_data group")
    Workspace(cfg, run_dir(cfg, "default"), device=cfg.get("device")).run()
