"""Collected episodes → a dataset file, or → welded demos in memory.

Counterpart of ``latent_diffusion_planning_tpu/data/writer.py``.
``write_trajectories`` writes the robomimic groups
(``data/demo_i/{obs/<k>, next_obs/<k>, actions, rewards, dones,
num_samples}``, ``data/env_args`` as a JSON string) as the flat keys of one
``.npz`` file, with the JAX writer's keep rules. It is the same data as the
JAX package's HDF5 in a container that numpy reads alone (the machine with
the card has no ``h5py``); ``ingest.load_npz`` reads it back. A latent
companion (``write_latents``) holds ``data/demo_i/latent/<key>`` and the
``data/min_z`` / ``data/max_z`` bounds, as ``tools/process_latents.py``
records them.

``weld_collection`` gives the ``WeldedDemos`` that a round trip through the
file would give, without the file. Per kept episode of T steps (T cut
``trim_success_margin`` steps after the first success when asked): the obs
streams are the first observation and the T observations after it (the
T+1-th is the file's spliced terminal frame), the actions the T recorded
ones and the last again. Image keys (ending in ``_image``) are stored as
the writer stores them: clipped to [0, 255] and truncated to uint8.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .ingest import WeldedDemos


def _keep(success: torch.Tensor, successful_only: bool,
          unsuccessful_only: bool, max_demos: int | None) -> torch.Tensor:
    """Indices of the episodes kept, in order."""
    if successful_only and unsuccessful_only:
        raise ValueError("successful_only and unsuccessful_only exclude "
                         "each other")
    ok = success.bool().any(1)
    keep = ok if successful_only else (~ok if unsuccessful_only
                                       else torch.ones_like(ok))
    idx = torch.nonzero(keep).flatten()
    return idx[:max_demos] if max_demos is not None else idx


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kept_streams(collection: Mapping[str, Any], obs_keys: Sequence[str],
                  successful_only: bool, unsuccessful_only: bool,
                  max_demos: int | None, trim_success_margin: int | None):
    """The format both writers share: the kept episodes (``idx``), each
    one's length T (``steps``, cut ``trim_success_margin`` steps after its
    first success when asked), and each obs stream of T + 1 frames, the
    first observation and the T after it ({k: (D, T_max + 1, ...)}), image
    keys clipped to [0, 255] and truncated to uint8."""
    success = torch.as_tensor(collection["success"]).bool()
    N, T = success.shape
    idx = _keep(success, successful_only, unsuccessful_only, max_demos)
    steps = torch.full((N,), T, dtype=torch.int64, device=success.device)
    if trim_success_margin is not None:
        first = success.int().argmax(1) + 1 + int(trim_success_margin)
        steps = torch.where(success.any(1), torch.clamp(first, max=T), steps)
    streams = {}
    for k in obs_keys:
        stream = torch.cat(
            [torch.as_tensor(collection["first_obs"][k])[idx][:, None],
             torch.as_tensor(collection["obs"][k])[idx]], 1)
        if k.endswith("_image") and not k.startswith("latent_"):
            stream = stream.clamp(0, 255).to(torch.uint8)
        streams[k] = stream
    return idx, steps[idx], streams


def write_trajectories(path: str | Path, collection: Mapping[str, Any], *,
                       env_meta: Mapping[str, Any] | None = None,
                       successful_only: bool = False,
                       unsuccessful_only: bool = False,
                       max_demos: int | None = None,
                       trim_success_margin: int | None = None) -> int:
    """Write a collection (``first_obs`` {k: (N, ...)}, ``obs`` {k: (N, T,
    ...)}, ``actions`` (N, T, A), ``rewards`` and ``success`` (N, T)) as an
    ``.npz`` dataset; returns the number of demos written. Obs keys ending
    in ``_image`` are stored uint8;
    ``trim_success_margin`` cuts a successful episode that many steps after
    its first success."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"{path}: the port writes datasets as .npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    idx, steps, streams = _kept_streams(
        collection, tuple(collection["obs"]), successful_only,
        unsuccessful_only, max_demos, trim_success_margin)
    streams = {k: _host(v) for k, v in streams.items()}
    idx = idx.cpu().numpy()
    actions = _host(collection["actions"])[idx].astype(np.float32)
    rewards = _host(collection["rewards"])[idx].astype(np.float32)
    dones = _host(collection["success"])[idx].astype(bool).astype(np.int64)
    out = {"data/env_args": np.array(json.dumps(dict(env_meta or {})))}
    for d, T in enumerate(steps.tolist()):
        g = f"data/demo_{d}/"
        out[g + "num_samples"] = np.array(T, np.int64)
        for k, stream in streams.items():
            out[f"{g}obs/{k}"] = stream[d, :T]
            out[f"{g}next_obs/{k}"] = stream[d, 1:T + 1]
        out[g + "actions"] = actions[d, :T]
        out[g + "rewards"] = rewards[d, :T]
        out[g + "dones"] = dones[d, :T]
    with open(path, "wb") as f:
        np.savez(f, **out)
    return len(steps)


def write_latents(path: str | Path, welded: WeldedDemos,
                  rgb_keys: Sequence[str], min_z: float, max_z: float,
                  demo_names: Sequence[str] | None = None) -> None:
    """Write the ``latent_<key>`` arrays of ``welded`` (every frame of every
    demo, the terminal one too) as an ``.npz`` latent companion, demo by
    demo under ``demo_names`` (the names of the dataset it was read from;
    default ``demo_0``, ``demo_1``, ...)."""
    path = Path(path)
    if path.suffix != ".npz":
        raise ValueError(f"{path}: the port writes datasets as .npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    out = {"data/min_z": np.array(json.dumps(float(min_z))),
           "data/max_z": np.array(json.dumps(float(max_z)))}
    for key in rgb_keys:
        z = _host(welded.arrays[f"latent_{key}"]).astype(np.float32)
        for d, (s, n) in enumerate(zip(welded.demo_starts.tolist(),
                                       welded.demo_lengths.tolist())):
            name = demo_names[d] if demo_names is not None else f"demo_{d}"
            out[f"data/{name}/latent/{key}"] = z[s:s + n]
    with open(path, "wb") as f:
        np.savez(f, **out)


def weld_collection(collection: Mapping[str, Any], *,
                    obs_keys: Sequence[str] | None = None,
                    env_meta: Mapping[str, Any] | None = None,
                    successful_only: bool = False,
                    unsuccessful_only: bool = False,
                    max_demos: int | None = None,
                    trim_success_margin: int | None = None,
                    name: str = "") -> WeldedDemos:
    """Weld a ``run_scripted_collection`` result (``first_obs`` {k: (N,
    ...)}, ``obs`` {k: (N, T, ...)}, ``actions`` (N, T, A), ``rewards`` and
    ``success`` (N, T)) into demos on the collection's device. ``obs_keys``
    (default: every key collected) may name ``optimal``, a constant flag of
    1 as ``load_robomimic`` makes it."""
    actions = collection["actions"]
    T = actions.shape[1]
    obs_keys = tuple(obs_keys or collection["obs"].keys())
    idx, steps, streams = _kept_streams(
        collection, [k for k in obs_keys if k != "optimal"], successful_only,
        unsuccessful_only, max_demos, trim_success_margin)
    dev = steps.device
    # frame j of a kept demo exists for j ≤ its T: one mask, row-major, so
    # the rows come demo by demo, each in time order
    frames = torch.arange(T + 1, device=dev)
    valid = frames[None, :] <= steps[:, None]            # (D, T+1)

    def weld(full: torch.Tensor) -> torch.Tensor:        # (D, T+1, ...)
        return full[valid]

    arrays = {}
    for k in obs_keys:
        arrays[k] = (torch.full((int(valid.sum()), 1), 1.0,
                                dtype=torch.float32, device=dev)
                     if k == "optimal" else weld(streams[k]))
    last = torch.clamp(frames[None, :], max=steps[:, None] - 1)  # (D, T+1)
    acts = torch.gather(actions[idx].float(), 1,
                        last[..., None].expand(-1, -1, actions.shape[-1]))
    arrays["actions"] = weld(acts)
    lengths = (steps + 1).cpu()
    return WeldedDemos(arrays=arrays,
                       demo_starts=torch.cumsum(lengths, 0) - lengths,
                       demo_lengths=lengths, obs_keys=obs_keys,
                       dataset_keys=("actions",),
                       env_meta=dict(env_meta) if env_meta is not None else {},
                       name=name)
