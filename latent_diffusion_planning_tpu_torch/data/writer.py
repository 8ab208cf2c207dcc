"""Collected episodes → welded demos, in memory.

Counterpart of ``latent_diffusion_planning_tpu/data/writer.py``'s
``write_trajectories``, read back by ``data/ingest.load_robomimic``: this
gives the ``WeldedDemos`` that round trip through an HDF5 file would give,
without the file (the machine with the card has no ``h5py``). Per kept
episode of T steps (T cut ``trim_success_margin`` steps after the first
success when asked): the obs streams are the first observation and the T
observations after it (the T+1-th is the file's spliced terminal frame),
the actions the T recorded ones and the last again. Image keys (ending in
``_image``) are stored as the writer stores them: clipped to [0, 255] and
truncated to uint8.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

from .ingest import WeldedDemos


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
    if successful_only and unsuccessful_only:
        raise ValueError("successful_only and unsuccessful_only exclude "
                         "each other")
    success = collection["success"].bool()
    actions = collection["actions"]
    N, T = success.shape
    dev = actions.device
    ok = success.any(1)
    keep = ok if successful_only else (~ok if unsuccessful_only
                                       else torch.ones_like(ok))
    idx = torch.nonzero(keep).flatten()
    if max_demos is not None:
        idx = idx[:max_demos]
    steps = torch.full((N,), T, dtype=torch.int64, device=dev)
    if trim_success_margin is not None:
        first = success.int().argmax(1) + 1 + int(trim_success_margin)
        steps = torch.where(ok, torch.clamp(first, max=T), steps)
    steps = steps[idx]                                   # (D,) demo's T
    # frame j of a kept demo exists for j ≤ its T: one mask, row-major, so
    # the rows come demo by demo, each in time order
    frames = torch.arange(T + 1, device=dev)
    valid = frames[None, :] <= steps[:, None]            # (D, T+1)

    def weld(full: torch.Tensor) -> torch.Tensor:        # (D, T+1, ...)
        return full[valid]

    obs_keys = tuple(obs_keys or collection["obs"].keys())
    arrays = {}
    for k in obs_keys:
        if k == "optimal":
            arrays[k] = torch.full((int(valid.sum()), 1), 1.0,
                                   dtype=torch.float32, device=dev)
            continue
        stream = torch.cat([collection["first_obs"][k][idx][:, None],
                            collection["obs"][k][idx]], 1)
        if k.endswith("_image") and not k.startswith("latent_"):
            stream = stream.clamp(0, 255).to(torch.uint8)
        arrays[k] = weld(stream)
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
