"""Command-line drivers: the counterparts of the JAX package's ``tools/``
entry points (``collect_demos``, ``train_vae``, ``process_latents``,
``train_bc``, ``collect_data``, ``train_mixed_bc``, ``eval_bc``).

Each module's ``main(argv)`` takes the same ``[--config NAME] key=value
...`` command line as its JAX counterpart, with the same defaults (the
port's JSON copy of the config tree, ``utils/config.py``), and runs on the
card unless the command line says ``device=cpu``. Datasets are ``.npz``
files (``data/writer.py``); each run writes its resolved ``config.json``,
which ``collect_data`` and ``eval_bc`` read back. ``tools/<name>_torch.py``
wraps each one.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from ..train.checkpoint import Checkpointer, apply_params_snapshot
from ..train.loop import agent_config, build_agent, make_data
from ..utils.config import Config, load_config, parse_cli


def load(default: str, argv: list[str] | None) -> Config:
    """The config a command line names (``default`` unless ``--config``
    says otherwise), with its overrides applied."""
    name, overrides = parse_cli(sys.argv[1:] if argv is None else list(argv))
    return load_config(name or default, overrides)


def run_dir(cfg: Config, folder: str) -> Path:
    """``<experiment_root>/<experiment_folder>/<experiment_name>``."""
    return (Path(cfg.get("experiment_root", "experiments"))
            / cfg.get("experiment_folder", folder)
            / cfg.get("experiment_name", "run"))


def run_data(run_cfg: Config, device: torch.device):
    """A finished run's data facade, and its agent config as the
    ``Workspace`` built it (``agent_config``; the VAE comes from the
    snapshots, which carry it)."""
    data = make_data(run_cfg.data, device)
    return data, agent_config(run_cfg.agent, data)[0]


def agent_from_snapshot(agent_cfg, data, path: str | Path,
                        device: torch.device, idm_snapshot=None):
    """A fresh agent with a checkpoint's params (and, when given, another
    snapshot's IDM params) applied."""
    ckpt = Checkpointer(Path(path).parent)
    agent = build_agent(agent_cfg, data.shape_meta, 0, device)
    apply_params_snapshot(agent, ckpt.restore_raw(path))
    if idm_snapshot is not None:
        apply_params_snapshot(agent, idm_snapshot, restore_keys=["idm_params"])
    return agent


def run_agent(run_dir: str | Path | None, device: torch.device | str):
    """A seeded agent as a finished run's ``config.json`` builds it (its
    agent section, the bounds recorded in it, its data's ``shape_meta``),
    with no dataset read; the bench agent (``configs.bench_agent_config``)
    when ``run_dir`` is None."""
    if run_dir is None:
        from .. import configs
        return build_agent(configs.bench_agent_config(), configs.SHAPE_META,
                           0, device)
    cfg = load_config(str(Path(run_dir) / "config.json"))
    agent_cfg = {k: v for k, v in dict(cfg.agent).items()
                 if k != "vae_pretrain_path"}
    return build_agent(agent_cfg, cfg.data["meta"]["shape_meta"], 0, device)


def policy_keys(meta) -> tuple[str, ...]:
    """What the policy sees in the env: the lowdim keys and the camera
    keys without ``latent_``, the ``optimal`` flag left out."""
    return tuple(list(meta["lowdim_obs"]) + [
        k[len("latent_"):] if k.startswith("latent_") else k
        for k in meta["rgb_obs"] if k != "optimal"])
