"""Synthetic robomimic-format datasets for tests and self-contained demos.

Counterpart of ``latent_diffusion_planning_tpu/data/synthetic.py``: the same
seeded numpy draws in the same order, so a file written here reads equal to
the JAX package's. ``write_robomimic_hdf5`` writes the reference's schema,
``data/demo_i/{obs/<key>, next_obs/<key>, actions}`` with ``num_samples``
attributes and a JSON ``env_args`` attribute on ``data``;
``write_latent_hdf5`` a latent companion (``data/demo_i/latent/<key>``, one
frame more than the demo's steps). ``h5py`` is imported inside them, as
``data/ingest.load_robomimic`` does: the machine with the card has none.
There, ``write_robomimic_npz`` writes the same demos as an ``.npz``
dataset (``data/writer.write_trajectories``), which ``ingest.load_npz``
reads to the same welded arrays.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch


def _demos(n_demos: int, demo_len: int,
           obs_shapes: Mapping[str, Sequence[int]], ac_dim: int, seed: int,
           image_keys: Sequence[str]) -> Iterator[tuple[dict, np.ndarray]]:
    """Each demo's obs streams ({k: (T + 1, ...)}) and actions (T, A):
    smooth bounded random walks, uniform uint8 image noise."""
    rng = np.random.default_rng(seed)
    for _ in range(n_demos):
        streams = {}
        for key, shape in obs_shapes.items():
            size = (demo_len + 1,) + tuple(shape)
            if key in image_keys:
                streams[key] = rng.integers(0, 256, size=size, dtype=np.uint8)
            else:
                steps = rng.normal(0, 0.05, size=size)
                streams[key] = np.tanh(np.cumsum(steps, axis=0)).astype(
                    np.float32)
        actions = np.clip(rng.normal(0, 0.3, size=(demo_len, ac_dim)), -1, 1)
        yield streams, actions.astype(np.float32)


def _env_args(env_name: str) -> dict:
    return {"env_name": env_name, "type": 1, "env_kwargs": {}}


def write_robomimic_hdf5(path: str | Path, *, n_demos: int = 3,
                         demo_len: int = 20,
                         obs_shapes: Mapping[str, Sequence[int]] | None = None,
                         ac_dim: int = 7, seed: int = 0,
                         env_name: str = "SyntheticLift",
                         image_keys: Sequence[str] = ()) -> Path:
    """Write a robomimic-format HDF5 of smooth random trajectories."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    obs_shapes = dict(obs_shapes or {"robot0_eef_pos": (3,)})
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        data.attrs["env_args"] = json.dumps(_env_args(env_name))
        for d, (streams, actions) in enumerate(_demos(
                n_demos, demo_len, obs_shapes, ac_dim, seed, image_keys)):
            g = data.create_group(f"demo_{d}")
            g.attrs["num_samples"] = demo_len
            obs_g = g.create_group("obs")
            next_g = g.create_group("next_obs")
            for key, stream in streams.items():
                obs_g.create_dataset(key, data=stream[:demo_len])
                next_g.create_dataset(key, data=stream[1:])
            g.create_dataset("actions", data=actions)
    return path


def write_robomimic_npz(path: str | Path, *, n_demos: int = 3,
                        demo_len: int = 20,
                        obs_shapes: Mapping[str, Sequence[int]] | None = None,
                        ac_dim: int = 7, seed: int = 0,
                        env_name: str = "SyntheticLift",
                        image_keys: Sequence[str] = ()) -> Path:
    """``write_robomimic_hdf5``'s demos as an ``.npz`` dataset."""
    from .writer import write_trajectories

    obs_shapes = dict(obs_shapes or {"robot0_eef_pos": (3,)})
    demos = list(_demos(n_demos, demo_len, obs_shapes, ac_dim, seed,
                        image_keys))
    stack = lambda key: torch.from_numpy(np.stack([s[key] for s, _ in demos]))
    streams = {k: stack(k) for k in obs_shapes}
    write_trajectories(path, {
        "first_obs": {k: v[:, 0] for k, v in streams.items()},
        "obs": {k: v[:, 1:] for k, v in streams.items()},
        "actions": torch.from_numpy(np.stack([a for _, a in demos])),
        "rewards": torch.zeros(n_demos, demo_len),
        "success": torch.zeros(n_demos, demo_len, dtype=torch.bool)},
        env_meta=_env_args(env_name))
    return Path(path)


def write_latent_hdf5(path: str | Path, source_path: str | Path,
                      rgb_keys: Sequence[str], latent_dim: int = 16,
                      seed: int = 0) -> Path:
    """Write a latent companion of ``source_path`` with random latents:
    ``data/demo_i/latent/<key>`` of demo_len + 1 frames (the obs and the
    spliced terminal frame). Real latents come from ``process_latents``."""
    import h5py

    path = Path(path)
    rng = np.random.default_rng(seed)
    with h5py.File(source_path, "r") as src, h5py.File(path, "w") as f:
        data = f.create_group("data")
        for demo in src["data"]:
            T = int(src[f"data/{demo}"].attrs["num_samples"])
            g = data.create_group(demo).create_group("latent")
            for key in rgb_keys:
                g.create_dataset(key, data=rng.normal(
                    0, 1, size=(T + 1, latent_dim)).astype(np.float32))
    return path


def synthetic_stats(obs_shapes: Mapping[str, Sequence[int]],
                    latent_keys: Sequence[str] = (),
                    image_keys: Sequence[str] = ()) -> dict:
    """Min/max normalization config matching the writers' outputs."""
    obs: dict = {}
    for key, shape in obs_shapes.items():
        if key in image_keys:
            obs[key] = {"min": 0, "max": 255}
        else:
            obs[key] = {"min": [-1.0] * int(np.prod(shape)),
                        "max": [1.0] * int(np.prod(shape))}
    for key in latent_keys:
        obs[key] = {"min": -5.0, "max": 5.0}
    obs["optimal"] = {"min": 0, "max": 1}
    return {"obs": obs, "actions": {"clip_min": -1, "clip_max": 1}}
