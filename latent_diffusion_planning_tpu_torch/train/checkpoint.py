"""Checkpoints as ``torch.save`` files of tensors and plain containers.

Counterpart of ``latent_diffusion_planning_tpu/train/checkpoint.py``
(orbax there). A directory holds ``<step>.state`` (the agent's full train
state: params, Adam moments, EMA, steps, the frozen VAE; restoring it
resumes bit for bit), ``<step>.ckpt`` (a ``{<name>_params: state_dict}``
snapshot, ``agent.get_params()``) and ``<step>.config.json``. Tensors are
saved from the CPU and loaded with ``weights_only=True``: no pickled
modules, and a file restores onto any device.

The JAX package's orbax checkpoints are not readable here; a snapshot of
them in this format is what ``tools/export_bench_torch.py`` writes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import torch


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


class Checkpointer:
    """Directory of ``<step>.state`` / ``<step>.ckpt`` files."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    # -- full state ---------------------------------------------------------
    def save_state(self, step: int, agent: Any,
                   config: Mapping | None = None) -> Path:
        """Save ``agent.state_dict()`` (resumable) as ``<step>.state``."""
        path = self.directory / f"{step}.state"
        torch.save(_to_cpu(agent.state_dict()), path)
        if config is not None:
            (self.directory / f"{step}.config.json").write_text(
                json.dumps(dict(config), default=str))
        return path

    def restore_state(self, path: str | Path, agent: Any) -> Any:
        """Load a full state into ``agent`` (same structure); returns it."""
        agent.load_state_dict(torch.load(path, map_location=agent.device,
                                         weights_only=True))
        return agent

    # -- params only --------------------------------------------------------
    def save_params(self, step: int, params: Mapping[str, Any],
                    extra: Mapping[str, Any] | None = None) -> Path:
        """Save a ``{<name>_params: state_dict}`` dict as ``<step>.ckpt``."""
        path = self.directory / f"{step}.ckpt"
        torch.save(_to_cpu({**params, **(extra or {})}), path)
        return path

    def restore_raw(self, path: str | Path,
                    map_location: torch.device | str = "cpu") -> dict:
        return torch.load(path, map_location=map_location, weights_only=True)

    def list_checkpoints(self) -> list[Path]:
        return sorted(self.directory.glob("*.ckpt"),
                      key=lambda p: int(p.name.split(".")[0]))

    def list_states(self) -> list[Path]:
        return sorted(self.directory.glob("*.state"),
                      key=lambda p: int(p.name.split(".")[0]))


def apply_params_snapshot(agent: Any, snapshot: Mapping[str, Any],
                          restore_keys: list[str] | None = None) -> Any:
    """Rebind a snapshot's ``<name>_params`` onto the agent: ``planner`` and
    ``idm`` onto their train states (weights and EMA copy; the optimizer
    state stays), ``vae`` onto the VAE. Keys containing ``ema`` are skipped;
    ``restore_keys`` filters which keys apply."""
    for key, value in snapshot.items():
        if "ema" in key or not key.endswith("_params"):
            continue
        if restore_keys is not None and key not in restore_keys:
            continue
        prefix = key[:-len("_params")]
        state = getattr(agent, f"{prefix}_state", None)
        if state is not None:
            state.set_params(value)
        elif prefix == "vae":
            agent.vae.load_state_dict(value)
    agent.weights_changed()
    return agent
