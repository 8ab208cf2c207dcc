"""Rebuild an eval env from a dataset's recorded ``env_meta``.

Counterpart of ``latent_diffusion_planning_tpu/envs/from_meta.py``: a
dataset records the env it was collected in (``env_args``: ``env_name`` and
``env_kwargs``). Names the port's own drivers write are env class names
(``NATIVE_REGISTRY``) and construct with their kwargs verbatim; robosuite
task names (``ENV_REGISTRY``) map onto the contact-physics envs, with the
robosuite kwargs this stack understands (camera size, horizon) honoured and
the robosuite-internal ones (controller configs, renderer flags) dropped,
since their capability is built into the envs. The ALOHA task names (the
reference's ``SIM_TASK_CONFIGS`` variants, exact keys only) take the same
robosuite path.
"""

from __future__ import annotations

import importlib
from typing import Any, Mapping

_ENVS = "latent_diffusion_planning_tpu_torch.envs."

ENV_REGISTRY = {
    "Lift": _ENVS + "lift_physics:LiftPhysicsEnv",
    "PickPlaceCan": _ENVS + "pick_place_physics:CanPhysicsEnv",
    "NutAssemblySquare": _ENVS + "pick_place_physics:SquarePhysicsEnv",
    "sim_transfer_cube": _ENVS + "aloha_cube:AlohaTransferCubeEnv",
    "sim_transfer_cube_scripted": _ENVS + "aloha_cube:AlohaTransferCubeEnv",
    "sim_transfer_cube_human": _ENVS + "aloha_cube:AlohaTransferCubeEnv",
    "sim_insertion": _ENVS + "aloha_insertion:AlohaInsertionEnv",
    "sim_insertion_scripted": _ENVS + "aloha_insertion:AlohaInsertionEnv",
    "sim_insertion_human": _ENVS + "aloha_insertion:AlohaInsertionEnv",
}

NATIVE_REGISTRY = {
    "LiftEnv": _ENVS + "lift:LiftEnv",
    "LiftPhysicsEnv": _ENVS + "lift_physics:LiftPhysicsEnv",
    "CanEnv": _ENVS + "pick_place:CanEnv",
    "SquareEnv": _ENVS + "pick_place:SquareEnv",
    "CanPhysicsEnv": _ENVS + "pick_place_physics:CanPhysicsEnv",
    "SquarePhysicsEnv": _ENVS + "pick_place_physics:SquarePhysicsEnv",
    "AlohaTransferCubeEnv": _ENVS + "aloha_cube:AlohaTransferCubeEnv",
    "AlohaInsertionEnv": _ENVS + "aloha_insertion:AlohaInsertionEnv",
}

# robosuite-internal kwargs whose capability is built into the envs
_STRUCTURAL_KWARGS = {
    "controller_configs", "robots", "has_renderer", "has_offscreen_renderer",
    "render_gpu_device_id", "use_object_obs", "use_camera_obs", "camera_names",
    "reward_shaping", "ignore_done", "control_freq", "camera_depths",
    "render_camera", "hard_reset",
}


def _load(path: str):
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def make_env_from_meta(env_meta: Mapping[str, Any], **overrides) -> Any:
    """``{"env_name", "env_kwargs"}`` → the port's batched env;
    ``overrides`` join (and win over) the recorded kwargs."""
    name = env_meta.get("env_name", "")
    if name in NATIVE_REGISTRY:
        kwargs = {**env_meta.get("env_kwargs", {}), **overrides}
        return _load(NATIVE_REGISTRY[name])(**kwargs)
    if name not in ENV_REGISTRY:
        raise KeyError(f"no env registered for env_name {name!r} (known: "
                       f"{sorted(ENV_REGISTRY) + sorted(NATIVE_REGISTRY)})")
    meta_kwargs = dict(env_meta.get("env_kwargs", {}))
    kwargs: dict[str, Any] = {}
    if "camera_heights" in meta_kwargs:
        kwargs["image_size"] = int(meta_kwargs.pop("camera_heights"))
    if "horizon" in meta_kwargs:
        kwargs["episode_len"] = int(meta_kwargs.pop("horizon"))
    unknown = [k for k in meta_kwargs
               if k not in _STRUCTURAL_KWARGS and k != "camera_widths"]
    if unknown:
        print(f"[from_meta] ignoring unrecognized env_kwargs: {unknown}")
    return _load(ENV_REGISTRY[name])(**{**kwargs, **overrides})
