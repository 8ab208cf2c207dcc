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
``windows.DeviceDataset``. ``stats_from_data`` replaces the config's bounds
of the listed keys with bounds measured on the train split
(``measure_stats``); ``oversample`` weights the train sampler toward action
events (``windows.action_event_weights``).

Not ported yet: ``MixedOfflineData``.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import ingest
from .windows import DeviceDataset, action_event_weights, sample_traj


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
                 stats_from_data: Sequence[str] | None = None,
                 stats_pad: float = 0.05,
                 oversample: Mapping[str, Any] | None = None,
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
        self.oversample = oversample
        self.device = resolve_device(device)
        self._sources = dict(
            train=(train, train_path, train_latent_path,
                   train_n_episode_overfit),
            eval=(eval, eval_path, eval_latent_path, eval_n_episode_overfit))
        self._welded: dict[str, ingest.WeldedDemos] = {}
        self._device: dict[str, DeviceDataset] = {}
        if stats_from_data:
            # the Workspace reads meta when it builds the agent, so the agent
            # normalizes with the measured bounds
            self.meta = apply_measured_stats(
                self.meta, self.welded("train"), list(stats_from_data),
                stats_pad, self.name)

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
