"""Welded demos: every demo's frames in flat arrays plus per-demo extents.

Counterpart of ``latent_diffusion_planning_tpu/data/ingest.py``
(``WeldedDemos``, ``load_robomimic``, ``concat_welded``). The arrays are
torch tensors, on the CPU when read from a file and wherever the collection
lay when welded in memory (``data/writer.py``); ``data/windows.py`` puts
them on the device once.

A robomimic dataset holds ``data/demo_i/{obs,next_obs,actions}``; per demo
the obs stream gains its final ``next_obs`` frame and the actions a
duplicated last action, so every state, the terminal one too, is
indexable. Latent companions hold ``data/demo_i/latent/<rgb_key>``, read as
obs key ``latent_<rgb_key>``. ``load_demos`` picks the reader by the
file's suffix: ``.npz`` (``load_npz``: the same groups as flat keys, the
container ``data/writer.write_trajectories`` writes, readable with numpy
alone) or ``.hdf5`` (``load_robomimic``: ``h5py`` is imported inside it,
and the machine with the card has none). An ALOHA-format HDF5
(``load_aloha``, ``format="aloha"``) holds ``data/demo_i/{obs,action}``
with no ``next_obs`` splice.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence

import torch


@dataclasses.dataclass
class WeldedDemos:
    """Flat arrays over all demos + per-demo extents."""

    arrays: dict[str, torch.Tensor]        # key -> (N_total, ...)
    demo_starts: torch.Tensor              # (D,) int64, start of each demo
    demo_lengths: torch.Tensor             # (D,) int64, length of each demo
    obs_keys: tuple[str, ...]
    dataset_keys: tuple[str, ...]          # non-obs keys (actions)
    env_meta: dict[str, Any] | None = None
    name: str = ""

    @property
    def n_demos(self) -> int:
        return len(self.demo_starts)

    @property
    def total_steps(self) -> int:
        return int(self.demo_lengths.sum())

    def demo_slice(self, i: int) -> dict[str, torch.Tensor]:
        s = int(self.demo_starts[i])
        e = s + int(self.demo_lengths[i])
        return {k: v[s:e] for k, v in self.arrays.items()}

    def select(self, obs_keys: Sequence[str]) -> "WeldedDemos":
        """The same demos with only ``obs_keys`` (and the dataset keys)."""
        obs_keys = tuple(obs_keys)
        missing = set(obs_keys) - set(self.arrays)
        if missing:
            raise KeyError(f"welded demos have no keys {sorted(missing)}")
        keep = obs_keys + self.dataset_keys
        return dataclasses.replace(
            self, arrays={k: self.arrays[k] for k in keep}, obs_keys=obs_keys)

    def first_demos(self, n_demos: int | None) -> "WeldedDemos":
        """The first ``n_demos`` demos (all when None), as a file read with
        ``n_demos`` would give them."""
        if n_demos is None:
            return self
        if n_demos > self.n_demos:
            raise ValueError(f"requested {n_demos} demos, have {self.n_demos}")
        end = int(self.demo_starts[n_demos - 1] + self.demo_lengths[n_demos - 1])
        return dataclasses.replace(
            self, arrays={k: v[:end] for k, v in self.arrays.items()},
            demo_starts=self.demo_starts[:n_demos],
            demo_lengths=self.demo_lengths[:n_demos])


def _select_demos(names: list[str], n_demos) -> list[str]:
    if n_demos is None:
        return names
    if isinstance(n_demos, (list, tuple)):
        missing = set(n_demos) - set(names)
        if missing:
            raise KeyError(f"demo names not in file: {sorted(missing)}")
        return list(n_demos)
    if n_demos > len(names):
        raise ValueError(f"requested {n_demos} demos, file has {len(names)}")
    return names[:n_demos]


def load_robomimic(path: str, obs_keys: Sequence[str],
                   n_demos: int | Sequence[str] | None = None,
                   latent_path: str | None = None,
                   optimal: float = 1.0, name: str = "") -> WeldedDemos:
    """Load and weld a robomimic-format HDF5 (with an optional latent
    companion) into CPU tensors."""
    import numpy as np

    h5py = _h5py(path)
    obs_keys = tuple(obs_keys)
    out: dict[str, list] = {k: [] for k in obs_keys}
    out["actions"] = []
    starts, lengths = [], []
    total = 0
    lat = h5py.File(latent_path, "r") if latent_path else None
    try:
        with h5py.File(path, "r") as f:
            names = sorted(f["data"].keys(), key=lambda n: int(n.split("_")[-1]))
            env_meta = (json.loads(f["data"].attrs["env_args"])
                        if "env_args" in f["data"].attrs else None)
            for demo in _select_demos(names, n_demos):
                g = f[f"data/{demo}"]
                T = int(g.attrs["num_samples"]) + 1   # + the terminal frame
                for key in obs_keys:
                    if key == "optimal":
                        arr = np.full((T, 1), optimal, dtype=np.float32)
                    elif key.startswith("latent_"):
                        if lat is None:
                            raise ValueError(f"obs key {key} needs latent_path")
                        arr = lat[f"data/{demo}/latent/{key[len('latent_'):]}"][:]
                        if len(arr) != T:
                            raise ValueError(
                                f"latent stream for {demo}/{key} has "
                                f"{len(arr)} frames, expected {T}")
                    else:
                        arr = np.concatenate([g[f"obs/{key}"][:],
                                              g[f"next_obs/{key}"][-1:]], 0)
                    out[key].append(arr)
                actions = g["actions"][:]
                out["actions"].append(np.concatenate([actions, actions[-1:]], 0))
                starts.append(total)
                lengths.append(T)
                total += T
    finally:
        if lat is not None:
            lat.close()
    return WeldedDemos(
        arrays={k: torch.from_numpy(np.concatenate(v, 0)) for k, v in out.items()},
        demo_starts=torch.tensor(starts, dtype=torch.int64),
        demo_lengths=torch.tensor(lengths, dtype=torch.int64),
        obs_keys=obs_keys, dataset_keys=("actions",), env_meta=env_meta,
        name=name)


def _h5py(path: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading {path} needs h5py, which is not "
                          f"installed; write the dataset as .npz "
                          f"(data/writer.write_trajectories)") from e
    return h5py


def load_aloha(path: str, obs_keys: Sequence[str],
               n_demos: int | Sequence[str] | None = None,
               latent_path: str | None = None,
               optimal: float = 1.0, name: str = "") -> WeldedDemos:
    """Load and weld an ALOHA-format HDF5 into CPU tensors: each demo's
    first ``num_samples`` steps (all of its actions when the attribute is
    missing) of ``obs/<key>`` and ``actions`` (or ``action``), with no
    terminal splice; latent companions are cut to the same steps."""
    import numpy as np

    h5py = _h5py(path)
    obs_keys = tuple(obs_keys)
    out: dict[str, list] = {k: [] for k in obs_keys}
    out["actions"] = []
    starts, lengths = [], []
    total = 0
    lat = h5py.File(latent_path, "r") if latent_path else None
    try:
        with h5py.File(path, "r") as f:
            names = sorted(f["data"].keys(), key=lambda n: int(n.split("_")[-1]))
            for demo in _select_demos(names, n_demos):
                g = f[f"data/{demo}"]
                actions = g["actions" if "actions" in g else "action"][:]
                T = int(g.attrs.get("num_samples", len(actions)))
                for key in obs_keys:
                    if key == "optimal":
                        arr = np.full((T, 1), optimal, dtype=np.float32)
                    elif key.startswith("latent_"):
                        if lat is None:
                            raise ValueError(f"obs key {key} needs latent_path")
                        arr = lat[f"data/{demo}/latent/{key[len('latent_'):]}"][:T]
                    else:
                        arr = g[f"obs/{key}"][:T]
                    out[key].append(arr)
                out["actions"].append(actions[:T])
                starts.append(total)
                lengths.append(T)
                total += T
    finally:
        if lat is not None:
            lat.close()
    return WeldedDemos(
        arrays={k: torch.from_numpy(np.concatenate(v, 0)) for k, v in out.items()},
        demo_starts=torch.tensor(starts, dtype=torch.int64),
        demo_lengths=torch.tensor(lengths, dtype=torch.int64),
        obs_keys=obs_keys, dataset_keys=("actions",), env_meta=None,
        name=name)


def npz_demo_names(files) -> list[str]:
    """The demo names of an ``.npz`` dataset's keys, in index order."""
    names = {k.split("/")[1] for k in files
             if k.startswith("data/demo_") and k.count("/") >= 2}
    return sorted(names, key=lambda n: int(n.split("_")[-1]))


def load_npz(path: str, obs_keys: Sequence[str],
             n_demos: int | Sequence[str] | None = None,
             latent_path: str | None = None, optimal: float = 1.0,
             name: str = "") -> WeldedDemos:
    """``load_robomimic`` for an ``.npz`` dataset (and an ``.npz`` latent
    companion): the same welded demos for the same data."""
    import numpy as np

    obs_keys = tuple(obs_keys)
    out: dict[str, list] = {k: [] for k in obs_keys}
    out["actions"] = []
    starts, lengths = [], []
    total = 0
    lat = np.load(latent_path) if latent_path else None
    try:
        with np.load(path) as f:
            env_meta = (json.loads(str(f["data/env_args"]))
                        if "data/env_args" in f.files else None)
            for demo in _select_demos(npz_demo_names(f.files), n_demos):
                g = f"data/{demo}/"
                T = int(f[g + "num_samples"]) + 1     # + the terminal frame
                for key in obs_keys:
                    if key == "optimal":
                        arr = np.full((T, 1), optimal, dtype=np.float32)
                    elif key.startswith("latent_"):
                        if lat is None:
                            raise ValueError(f"obs key {key} needs latent_path")
                        arr = lat[f"{g}latent/{key[len('latent_'):]}"]
                        if len(arr) != T:
                            raise ValueError(
                                f"latent stream for {demo}/{key} has "
                                f"{len(arr)} frames, expected {T}")
                    else:
                        arr = np.concatenate([f[f"{g}obs/{key}"],
                                              f[f"{g}next_obs/{key}"][-1:]], 0)
                    out[key].append(arr)
                actions = f[g + "actions"]
                out["actions"].append(np.concatenate([actions, actions[-1:]],
                                                     0))
                starts.append(total)
                lengths.append(T)
                total += T
    finally:
        if lat is not None:
            lat.close()
    return WeldedDemos(
        arrays={k: torch.from_numpy(np.concatenate(v, 0)) for k, v in out.items()},
        demo_starts=torch.tensor(starts, dtype=torch.int64),
        demo_lengths=torch.tensor(lengths, dtype=torch.int64),
        obs_keys=obs_keys, dataset_keys=("actions",), env_meta=env_meta,
        name=name)


def load_demos(path: str, obs_keys: Sequence[str],
               n_demos: int | Sequence[str] | None = None,
               latent_path: str | None = None, optimal: float = 1.0,
               name: str = "", format: str = "robomimic") -> WeldedDemos:
    """``load_npz`` for an ``.npz`` file, ``load_robomimic`` for an
    ``.hdf5`` one; ``load_aloha`` for ``format="aloha"`` (HDF5 only)."""
    suffix = str(path).rsplit(".", 1)[-1]
    if format not in ("robomimic", "aloha"):
        raise ValueError(f"unknown dataset format {format!r}")
    if format == "aloha":
        if suffix != "hdf5":
            raise ValueError(f"{path}: an aloha-format dataset is an .hdf5 "
                             "file")
        load = load_aloha
    elif suffix == "npz":
        load = load_npz
    elif suffix == "hdf5":
        load = load_robomimic
    else:
        raise ValueError(f"{path}: a dataset is an .npz or .hdf5 file")
    return load(path, obs_keys, n_demos=n_demos, latent_path=latent_path,
                optimal=optimal, name=name)


def concat_welded(parts: Sequence[WeldedDemos], name: str = "") -> WeldedDemos:
    """Concatenate several welded datasets (they must share keys)."""
    if not parts:
        raise ValueError("need at least one dataset")
    keys = parts[0].arrays.keys()
    if any(p.arrays.keys() != keys for p in parts[1:]):
        raise ValueError("welded datasets must share keys")
    offsets, total = [], 0
    for p in parts:
        offsets.append(total)
        total += p.total_steps
    return WeldedDemos(
        arrays={k: torch.cat([p.arrays[k] for p in parts], 0) for k in keys},
        demo_starts=torch.cat([p.demo_starts + o
                               for p, o in zip(parts, offsets)]),
        demo_lengths=torch.cat([p.demo_lengths for p in parts]),
        obs_keys=parts[0].obs_keys, dataset_keys=parts[0].dataset_keys,
        env_meta=parts[0].env_meta, name=name)
