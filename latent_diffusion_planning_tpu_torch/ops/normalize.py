"""Min/max normalization of observation and action dicts.

Counterpart of ``latent_diffusion_planning_tpu/ops/normalize.py``: per-key
``{min, max}`` bounds map values to [-1, 1] and back, ``{clip_min,
clip_max}`` clips (actions), and bounds broadcast from the right.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

Stats = Mapping[str, Any]


def stats_to_tensors(stats: Stats, device: torch.device | str = "cpu") -> dict:
    """Nested config of bounds → float32 tensors; scalars stay Python numbers."""
    out: dict = {}
    for k, v in stats.items():
        if isinstance(v, Mapping):
            out[k] = stats_to_tensors(v, device)
        elif isinstance(v, (list, tuple, torch.Tensor)):
            out[k] = torch.as_tensor(v, dtype=torch.float32, device=device)
        else:
            out[k] = v
    return out


def normalize_to_unit(val: torch.Tensor, lo: Any, hi: Any) -> torch.Tensor:
    """Map [lo, hi] → [-1, 1]."""
    return (val - lo) / (hi - lo) * 2.0 - 1.0


def unnormalize_from_unit(val: torch.Tensor, lo: Any, hi: Any) -> torch.Tensor:
    """Map [-1, 1] → [lo, hi], clipped to the bounds."""
    out = (val + 1.0) * 0.5 * (hi - lo) + lo
    if isinstance(lo, torch.Tensor):
        return torch.minimum(torch.maximum(out, lo), hi)
    return torch.clamp(out, lo, hi)


def _apply_key(val: torch.Tensor, spec: Stats, forward: bool) -> torch.Tensor:
    if not torch.is_floating_point(val):
        val = val.float()
    if "mean" in spec:
        raise NotImplementedError("mean/std normalization not used by any config")
    if "min" in spec:
        fn = normalize_to_unit if forward else unnormalize_from_unit
        return fn(val, spec["min"], spec["max"])
    if "clip_min" in spec:
        return torch.clamp(val, spec["clip_min"], spec["clip_max"])
    raise NotImplementedError(f"unknown normalization spec keys: {list(spec)}")


def normalize_tree(batch: Mapping[str, torch.Tensor], stats: Stats) -> dict:
    missing = set(batch) - set(stats)
    if missing:
        raise KeyError(f"no normalization stats for keys {sorted(missing)}")
    return {k: _apply_key(v, stats[k], True) for k, v in batch.items()}


def unnormalize_tree(batch: Mapping[str, torch.Tensor], stats: Stats) -> dict:
    missing = set(batch) - set(stats)
    if missing:
        raise KeyError(f"no normalization stats for keys {sorted(missing)}")
    return {k: _apply_key(v, stats[k], False) for k, v in batch.items()}


def unnormalize_actions(actions: torch.Tensor, stats: Stats) -> torch.Tensor:
    return unnormalize_tree({"actions": actions}, stats)["actions"]
