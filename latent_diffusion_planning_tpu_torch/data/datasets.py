"""Dataset facades: one train and one eval split of welded demos, or a
weighted mixture of train sub-datasets.

Counterpart of ``latent_diffusion_planning_tpu/data/datasets.py``'s
``OfflineData`` (``welded``, ``device_dataset``, ``train_dataloader``,
``eval_dataloader``, ``env_meta``, ``sample_traj``, ``shape_meta``) and
``MixedOfflineData``. The splits come either from robomimic HDF5 files
(``train_path`` / ``eval_path`` with optional latent companions, through
``ingest.load_robomimic``), or already welded (``train`` / ``eval``, for
example from ``writer.weld_collection`` and ``latents.encode_latents``),
which is the route on a machine without ``h5py``. Either way each split
keeps the facade's obs keys (``meta``'s lowdim and rgb keys) and its first
``*_n_episode_overfit`` demos. Batches are drawn on the device by
``windows.DeviceDataset`` (``windows.MixedDeviceDataset`` for a mixture).
``stats_from_data`` replaces the config's bounds of the listed keys with
bounds measured on the train split (``measure_stats``); ``oversample``
weights the train sampler toward action events
(``windows.action_event_weights``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import ingest
from .windows import (DeviceDataset, MixedDeviceDataset,
                      action_event_weights, sample_traj)


def measure_stats(welded: ingest.WeldedDemos, keys: Sequence[str],
                  pad: float = 0.05, name: str = "") -> dict:
    """Min/max bounds measured on the data, widened by ``pad``·range and
    rounded to 5 decimals: per dim for most keys, one global scalar pair for
    ``latent_*`` keys (per-dim bounds would stretch the noise-dominated
    latent dims to the full [-1, 1])."""
    out = {}
    for key in keys:
        arr = welded.arrays[key].cpu().numpy().astype(np.float64)
        if key.startswith("latent_"):
            lo, hi = float(arr.min()), float(arr.max())
            span = max(hi - lo, 1e-4)
            out[key] = {"min": round(lo - pad * span, 5),
                        "max": round(hi + pad * span, 5)}
            print(f"[data:{name}] measured {key} global bounds "
                  f"min={out[key]['min']} max={out[key]['max']}")
            continue
        lo, hi = arr.min(axis=0), arr.max(axis=0)
        span = np.maximum(hi - lo, 1e-4)
        lo, hi = lo - pad * span, hi + pad * span
        out[key] = {"min": [round(float(v), 5) for v in lo],
                    "max": [round(float(v), 5) for v in hi]}
        print(f"[data:{name}] measured {key} bounds "
              f"min={out[key]['min']} max={out[key]['max']}")
    return out


def apply_measured_stats(meta: Mapping[str, Any], welded, keys, pad: float,
                         name: str = "") -> dict:
    """A deep copy of ``meta`` with the measured bounds in its
    ``obs_normalization`` (``actions`` at the top, obs keys under
    ``obs``)."""
    meta = copy.deepcopy(dict(meta))
    norm = meta.setdefault("obs_normalization", {})
    for key, mm in measure_stats(welded, keys, pad=pad, name=name).items():
        if key == "actions":
            norm["actions"] = mm
        else:
            norm.setdefault("obs", {})[key] = mm
    return meta


def event_weights(welded: ingest.WeldedDemos,
                  oversample: Mapping[str, Any]) -> torch.Tensor:
    """An ``oversample`` config block (``{channels: [...], boost: 3.0,
    halfwidth: 8}``) as per-step weights."""
    kw = dict(oversample)
    return action_event_weights(welded, channels=list(kw.pop("channels")),
                                **{k: float(v) if k == "boost" else int(v)
                                   for k, v in kw.items()})


def _load_split(obs_keys: Sequence[str], given: ingest.WeldedDemos | None,
                path: str | None, latent_path: str | None,
                n_demos: int | None, name: str,
                optimal: float = 1.0) -> ingest.WeldedDemos:
    """A split's first ``n_demos`` demos with ``obs_keys``: handed in welded
    (its ``optimal`` flag set to ``optimal`` when the keys name it) or read
    from ``path``."""
    if given is not None:
        if "optimal" in obs_keys:
            like = next(iter(given.arrays.values()))
            flag = torch.full((given.total_steps, 1), float(optimal),
                              dtype=torch.float32, device=like.device)
            given = dataclasses.replace(given, arrays=dict(given.arrays,
                                                           optimal=flag))
        return given.select(obs_keys).first_demos(n_demos)
    if path is None:
        raise ValueError(f"no data for {name}: give a path or welded demos")
    return ingest.load_robomimic(path, obs_keys, n_demos=n_demos,
                                 latent_path=latent_path, optimal=optimal,
                                 name=name)


class _Facade:
    """What both facades share: the config's keys and the loaders, each
    drawing on the device from a generator seeded with ``seed`` (train) or
    ``seed + 1`` (eval)."""

    def __init__(self, name: str, meta: Mapping[str, Any],
                 env_params: Mapping[str, Any] | None, batch_size: int,
                 obs_horizon: int, seq_length: int, format: str, seed: int,
                 device: torch.device | str | None,
                 oversample: Mapping[str, Any] | None):
        if format != "robomimic":
            raise ValueError(f"dataset format {format!r} is not ported")
        self.name = name
        self.meta = meta
        self.env_params = dict(env_params or {})
        self.batch_size = batch_size
        self.obs_horizon = obs_horizon
        self.seq_length = seq_length
        self.seed = seed
        self.oversample = oversample
        self.device = resolve_device(device)
        self._welded: dict[str, ingest.WeldedDemos] = {}
        self._device: dict[str, Any] = {}

    @property
    def shape_meta(self) -> Mapping[str, Any]:
        return self.meta["shape_meta"]

    @property
    def obs_keys(self) -> tuple[str, ...]:
        return tuple(self.meta["lowdim_obs"]) + tuple(self.meta["rgb_obs"])

    def _loader(self, split: str, seed: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self.device_dataset(split).iter_batches(self.batch_size, gen)

    def train_dataloader(self):
        return self._loader("train", self.seed)

    def eval_dataloader(self):
        return self._loader("eval", self.seed + 1)


class OfflineData(_Facade):
    def __init__(self, *, name: str, meta: Mapping[str, Any],
                 train_path: str | None = None, eval_path: str | None = None,
                 train: ingest.WeldedDemos | None = None,
                 eval: ingest.WeldedDemos | None = None,
                 env_params: Mapping[str, Any] | None = None,
                 batch_size: int = 256, obs_horizon: int = 1,
                 seq_length: int = 16,
                 train_n_episode_overfit: int | None = None,
                 eval_n_episode_overfit: int | None = None,
                 train_latent_path: str | None = None,
                 eval_latent_path: str | None = None,
                 format: str = "robomimic", seed: int = 0,
                 device: torch.device | str | None = None,
                 stats_from_data: Sequence[str] | None = None,
                 stats_pad: float = 0.05,
                 oversample: Mapping[str, Any] | None = None,
                 # a key of the data config; batches are drawn on the device
                 n_workers: int = 0):
        super().__init__(name, meta, env_params, batch_size, obs_horizon,
                         seq_length, format, seed, device, oversample)
        self._sources = dict(
            train=(train, train_path, train_latent_path,
                   train_n_episode_overfit),
            eval=(eval, eval_path, eval_latent_path, eval_n_episode_overfit))
        if stats_from_data:
            # the Workspace reads meta when it builds the agent, so the agent
            # normalizes with the measured bounds
            self.meta = apply_measured_stats(
                self.meta, self.welded("train"), list(stats_from_data),
                stats_pad, self.name)

    def welded(self, split: str) -> ingest.WeldedDemos:
        if split not in self._welded:
            self._welded[split] = _load_split(self.obs_keys,
                                              *self._sources[split],
                                              name=f"{self.name}/{split}")
        return self._welded[split]

    def device_dataset(self, split: str) -> DeviceDataset:
        if split not in self._device:
            weights = (event_weights(self.welded(split), self.oversample)
                       if self.oversample and split == "train" else None)
            self._device[split] = DeviceDataset.from_welded(
                self.welded(split), frame_stack=self.obs_horizon,
                seq_length=self.seq_length, device=self.device,
                sample_weights=weights)
        return self._device[split]

    @property
    def env_meta(self):
        return self.welded("train").env_meta

    def sample_traj(self, split: str, ep: int) -> dict:
        return sample_traj(self.welded(split), ep)


def _as_list(x, n: int) -> list:
    """Broadcast None to n slots; a list must have exactly n entries (its
    entries pair positionally with the sub-datasets), a scalar only pairs
    with a single one."""
    if x is None:
        return [None] * n
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"got {len(x)} entries for {n} sub-datasets: "
                             f"they pair positionally")
        return list(x)
    if n != 1:
        raise ValueError(f"a scalar cannot pair with {n} sub-datasets: give "
                         f"a list")
    return [x]


class MixedOfflineData(_Facade):
    """A weighted mixture of K train sub-datasets, expert first, and one
    eval split.

    ``train_paths`` (with ``train_latent_paths``) or ``train`` (welded
    parts) give the subs; ``train_split`` is a probability per sub or a
    scalar p meaning [p, 1 - p]; ``train_n_episode_overfit`` caps each sub
    (a list, or None). The ``optimal`` obs flag, when the meta asks for it,
    is 1 on the first sub and 0 on the others, and 1 on the eval split.
    ``stats_from_data`` and ``oversample`` act on the concatenation of the
    subs. The eval split is one path or one welded part; ``sample_traj``
    reads it only. ``env_meta`` is None, as in the JAX facade, so an eval
    env comes from ``env_params``.
    """

    env_meta = None

    def __init__(self, *, name: str, meta: Mapping[str, Any],
                 train_paths: Sequence[str] | None = None,
                 eval_paths: str | Sequence[str] | None = None,
                 train: Sequence[ingest.WeldedDemos] | None = None,
                 eval: ingest.WeldedDemos | None = None,
                 env_params: Mapping[str, Any] | None = None,
                 train_split: float | Sequence[float] = 0.5,
                 # a key of the data config; the eval split is not mixed
                 eval_split: float | Sequence[float] | None = None,
                 batch_size: int = 256, obs_horizon: int = 1,
                 seq_length: int = 16,
                 train_n_episode_overfit: Sequence[int | None] | None = None,
                 eval_n_episode_overfit: int | None = None,
                 train_latent_paths: Sequence[str] | None = None,
                 eval_latent_paths: str | Sequence[str] | None = None,
                 format: str = "robomimic", seed: int = 0,
                 device: torch.device | str | None = None,
                 stats_from_data: Sequence[str] | None = None,
                 stats_pad: float = 0.05,
                 oversample: Mapping[str, Any] | None = None,
                 n_workers: int = 0):
        super().__init__(name, meta, env_params, batch_size, obs_horizon,
                         seq_length, format, seed, device, oversample)
        given = list(train) if train is not None else None
        paths = list(train_paths) if train_paths is not None else None
        if given is None and paths is None:
            raise ValueError("no train sub-datasets: give train_paths or "
                             "welded parts")
        k = len(given if given is not None else paths)
        if isinstance(train_split, (list, tuple)):
            if abs(sum(train_split) - 1.0) > 1e-6:
                raise ValueError(f"train_split {train_split} does not sum "
                                 f"to 1")
            self.train_split = [float(p) for p in train_split]
        else:
            self.train_split = [float(train_split), 1.0 - float(train_split)]
        if len(self.train_split) != k:
            raise ValueError(f"train_split has {len(self.train_split)} "
                             f"entries for {k} sub-datasets")
        self._train = (given, paths, _as_list(train_latent_paths, k),
                       _as_list(train_n_episode_overfit, k))
        first = lambda x: x[0] if isinstance(x, (list, tuple)) else x
        self._eval_source = (eval, first(eval_paths),
                             first(eval_latent_paths), eval_n_episode_overfit)
        self.sub_sizes: list[int] = []
        if stats_from_data:
            self.meta = apply_measured_stats(
                self.meta, self.welded("train"), list(stats_from_data),
                stats_pad, self.name)

    def welded(self, split: str) -> ingest.WeldedDemos:
        """The eval split, or the train subs concatenated (expert first)."""
        if split not in self._welded:
            if split == "train":
                given, paths, latents, caps = self._train
                parts = [_load_split(
                    self.obs_keys, given[i] if given is not None else None,
                    paths[i] if given is None else None, latents[i], caps[i],
                    f"{self.name}/train{i}", optimal=1.0 if i == 0 else 0.0)
                    for i in range(len(caps))]
                self.sub_sizes = [p.total_steps for p in parts]
                self._welded[split] = ingest.concat_welded(
                    parts, name=f"{self.name}/train")
            elif split == "eval":
                given, path, latent_path, n_demos = self._eval_source
                if n_demos is not None:
                    print(f"[data:{self.name}] eval metrics capped to "
                          f"eval_n_episode_overfit={n_demos} demos")
                self._welded[split] = _load_split(
                    self.obs_keys, given, path, latent_path, n_demos,
                    f"{self.name}/eval")
            else:
                raise ValueError(f"no split {split!r}")
        return self._welded[split]

    def device_dataset(self, split: str):
        """The train mixture (``MixedDeviceDataset``) or the eval split's
        ``DeviceDataset``."""
        if split not in self._device:
            welded = self.welded(split)
            ds = DeviceDataset.from_welded(
                welded, frame_stack=self.obs_horizon,
                seq_length=self.seq_length, device=self.device)
            if split == "train":
                offsets = np.cumsum([0] + self.sub_sizes[:-1]).tolist()
                weights = (event_weights(welded, self.oversample)
                           if self.oversample else None)
                ds = MixedDeviceDataset.create(ds, offsets, self.sub_sizes,
                                               self.train_split,
                                               step_weights=weights)
            self._device[split] = ds
        return self._device[split]

    def sample_traj(self, split: str, ep: int) -> dict:
        if split != "eval":
            raise ValueError("sample_traj on mixed data reads the eval split")
        return sample_traj(self.welded("eval"), ep)
