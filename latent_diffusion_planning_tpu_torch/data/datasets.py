"""Dataset facade: one train and one eval split of welded demos.

Counterpart of ``latent_diffusion_planning_tpu/data/datasets.py``'s
``OfflineData`` (``welded``, ``device_dataset``, ``train_dataloader``,
``eval_dataloader``, ``env_meta``, ``sample_traj``, ``shape_meta``). The
splits come either from robomimic HDF5 files (``train_path`` /
``eval_path`` with optional latent companions, through
``ingest.load_robomimic``), or already welded (``train`` / ``eval``, for
example from ``writer.weld_collection`` and ``latents.encode_latents``),
which is the route on a machine without ``h5py``. Either way each split
keeps the facade's obs keys (``meta``'s lowdim and rgb keys) and its first
``*_n_episode_overfit`` demos. Batches are drawn on the device by
``windows.DeviceDataset``.

Not ported yet: ``stats_from_data``, ``oversample`` and ``MixedOfflineData``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from .. import resolve_device
from . import ingest
from .windows import DeviceDataset, sample_traj


class OfflineData:
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
                 # a key of the data config; batches are drawn on the device
                 n_workers: int = 0):
        if format != "robomimic":
            raise ValueError(f"dataset format {format!r} is not ported")
        self.name = name
        self.meta = meta
        self.env_params = dict(env_params or {})
        self.batch_size = batch_size
        self.obs_horizon = obs_horizon
        self.seq_length = seq_length
        self.seed = seed
        self.device = resolve_device(device)
        self._sources = dict(
            train=(train, train_path, train_latent_path,
                   train_n_episode_overfit),
            eval=(eval, eval_path, eval_latent_path, eval_n_episode_overfit))
        self._welded: dict[str, ingest.WeldedDemos] = {}
        self._device: dict[str, DeviceDataset] = {}

    @property
    def shape_meta(self) -> Mapping[str, Any]:
        return self.meta["shape_meta"]

    @property
    def obs_keys(self) -> tuple[str, ...]:
        return tuple(self.meta["lowdim_obs"]) + tuple(self.meta["rgb_obs"])

    def welded(self, split: str) -> ingest.WeldedDemos:
        if split not in self._welded:
            given, path, latent_path, n_demos = self._sources[split]
            if given is not None:
                w = given.select(self.obs_keys).first_demos(n_demos)
            elif path is not None:
                w = ingest.load_robomimic(path, self.obs_keys, n_demos=n_demos,
                                          latent_path=latent_path,
                                          name=f"{self.name}/{split}")
            else:
                raise ValueError(f"no {split} split: give {split}_path or "
                                 f"welded demos")
            self._welded[split] = w
        return self._welded[split]

    def device_dataset(self, split: str) -> DeviceDataset:
        if split not in self._device:
            self._device[split] = DeviceDataset.from_welded(
                self.welded(split), frame_stack=self.obs_horizon,
                seq_length=self.seq_length, device=self.device)
        return self._device[split]

    @property
    def env_meta(self):
        return self.welded("train").env_meta

    def _loader(self, split: str, seed: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return self.device_dataset(split).iter_batches(self.batch_size, gen)

    def train_dataloader(self):
        return self._loader("train", self.seed)

    def eval_dataloader(self):
        return self._loader("eval", self.seed + 1)

    def sample_traj(self, split: str, ep: int) -> dict:
        return sample_traj(self.welded(split), ep)
