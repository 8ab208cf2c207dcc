"""Configuration system: composed JSON configs, interpolation, overrides,
``_target_`` instantiation.

Counterpart of ``latent_diffusion_planning_tpu/utils/config.py``. The tree
it reads is the package's ``conf/``: one JSON file per YAML file of the JAX
package's ``configs/`` that the Lift recipes compose, each the
``yaml.safe_load`` of its YAML (the machine with the card has no YAML
reader; ``tests/test_torch_config.py`` holds the two trees equal).

- A top-level config's ``defaults`` mapping composes config groups
  (``agent/``, ``data/``, ``model/``; ``mixed_data`` reads ``data/``).
- ``${a.b.c}`` interpolation and ``${eval:'<arithmetic>'}``.
- Command-line overrides: ``a.b=3``, group swaps ``agent=ldp_agent``,
  additions ``+a.b=3``; values are read as YAML flow scalars would be.
- ``instantiate`` builds a ``_target_`` node. Targets keep the JAX tree's
  strings and map through ``TARGETS`` to the port's callables; a target
  the port lacks raises ``ConfigError``. Agent and VAE factories take the
  node as one config mapping (the port's ``create(config, ...)``), the
  rest take its keys as keywords.
- A run's resolved config is plain JSON (``config.json`` in its run
  directory), loadable again by path.
"""

from __future__ import annotations

import ast
import copy
import functools
import importlib
import json
import re
from pathlib import Path
from typing import Any, Callable

CONFIG_ROOT = Path(__file__).resolve().parent.parent / "conf"

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


class ConfigError(Exception):
    pass


class Config(dict):
    """Dict with attribute access and dotted-path get/set."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, path: str, default: Any = ...) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            elif isinstance(node, (list, tuple)) and part.lstrip("-").isdigit():
                node = node[int(part)]
            else:
                if default is ...:
                    raise ConfigError(f"config has no key {path!r} "
                                      f"(missing {part!r})")
                return default
        return node

    def set_path(self, path: str, value: Any, allow_new: bool = True) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, dict):
                if part not in node:
                    if not allow_new:
                        raise ConfigError(f"unknown config key {path!r}")
                    node[part] = Config()
                node = node[part]
            elif isinstance(node, list) and part.lstrip("-").isdigit():
                node = node[int(part)]
            else:
                raise ConfigError(f"cannot descend into {part!r} of {path!r}")
        last = parts[-1]
        if isinstance(node, list) and last.lstrip("-").isdigit():
            node[int(last)] = value
        else:
            if not allow_new and not (isinstance(node, dict) and last in node):
                raise ConfigError(f"unknown config key {path!r}")
            node[last] = value

    def to_dict(self) -> dict:
        return _plainify(self)

    def copy(self) -> "Config":  # type: ignore[override]
        return _configify(copy.deepcopy(_plainify(self)))


def _configify(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _configify(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_configify(v) for v in obj]
    return obj


def _plainify(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _plainify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plainify(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# Override values: YAML 1.1 flow scalars, sequences and mappings (what
# ``yaml.safe_load`` gives the JAX package), without a YAML reader
# ---------------------------------------------------------------------------

_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
# PyYAML's implicit resolvers for int and float (sexagesimal left out)
_INT_RE = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+")
_FLOAT_RE = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")


class _ScalarError(Exception):
    pass


def _plain_scalar(text: str) -> Any:
    text = text.strip()
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.fullmatch(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT_RE.fullmatch(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return text


def _flow(text: str, i: int, stop: str) -> tuple[Any, int]:
    """One flow node of ``text`` from ``i`` up to one of ``stop``'s
    characters at its level → (value, index after it)."""
    while i < len(text) and text[i] == " ":
        i += 1
    if i < len(text) and text[i] in "[{":
        close = "]" if text[i] == "[" else "}"
        i += 1
        items: list = []
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i >= len(text):
                raise _ScalarError("unclosed flow collection")
            if text[i] == close:
                i += 1
                break
            if close == "]":
                value, i = _flow(text, i, ",]")
                items.append(value)
            else:
                key, i = _flow(text, i, ":,}")
                if i < len(text) and text[i] == ":":
                    value, i = _flow(text, i + 1, ",}")
                else:
                    value = None
                items.append((key, value))
            if i < len(text) and text[i] == ",":
                i += 1
        value = items if close == "]" else dict(items)
        while i < len(text) and text[i] == " ":
            i += 1
        return value, i
    if i < len(text) and text[i] in "'\"":
        quote, j = text[i], i + 1
        out = []
        while True:
            if j >= len(text):
                raise _ScalarError("unclosed quote")
            if text[j] == quote:
                if quote == "'" and text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                break
            if quote == '"' and text[j] == "\\":
                out.append(json.loads(f'"{text[j:j + 2]}"'))
                j += 2
                continue
            out.append(text[j])
            j += 1
        j += 1
        while j < len(text) and text[j] == " ":
            j += 1
        return "".join(out), j
    j = i
    while j < len(text) and not (text[j] in stop and (
            text[j] != ":" or j + 1 == len(text) or text[j + 1] in " ,]}")):
        j += 1
    return _plain_scalar(text[i:j]), j


def _parse_value(text: str) -> Any:
    """An override's value as the JAX package reads it: ``yaml.safe_load``
    semantics ('null' → None, 'true' → True, '[8,null]' → [8, None]), then
    a string that is an int or float becomes one ('1e-5', which YAML 1.1
    leaves a string)."""
    stripped = text.strip()
    if stripped[:1] in ("@", "`", "*", "&", "!", "%", "|", ">"):
        return text
    if stripped.startswith("#"):
        return None
    try:
        if stripped[:1] in "[{'\"":
            val, end = _flow(stripped, 0, "")
            if end != len(stripped):
                return text
        else:
            val = _plain_scalar(stripped.split(" #")[0])
    except (_ScalarError, ValueError):
        return text
    if isinstance(val, str):
        try:
            return int(val)
        except ValueError:
            pass
        try:
            return float(val)
        except ValueError:
            pass
    return val


# ---------------------------------------------------------------------------
# Loading + composition
# ---------------------------------------------------------------------------

def _read_json(path: Path) -> Config:
    raw = json.loads(path.read_text()) or {}
    if not isinstance(raw, dict):
        raise ConfigError(f"{path} must hold a mapping at top level")
    return _configify(raw)


# the ``mixed_data`` group selects from the same per-task data configs as
# ``data``
GROUP_DIR_ALIASES = {"mixed_data": "data"}


def _group_file(group: str, name: str, root: Path) -> Path:
    gdir = GROUP_DIR_ALIASES.get(group, group)
    p = root / gdir / f"{name}.json"
    if not p.exists():
        avail = (sorted(x.relative_to(root / gdir).with_suffix("").as_posix()
                        for x in (root / gdir).rglob("*.json"))
                 if (root / gdir).exists() else [])
        raise ConfigError(f"no config {gdir}/{name}.json under {root} "
                          f"(available: {avail})")
    return p


def load_config(name: str, overrides: list[str] | None = None,
                config_root: str | Path | None = None) -> Config:
    """Load ``<root>/<name>.json`` (or a config file by path, such as a
    run's ``config.json``), compose its defaults groups, apply overrides and
    resolve interpolations."""
    root = Path(config_root) if config_root is not None else CONFIG_ROOT
    overrides = list(overrides or [])
    if name.endswith((".yaml", ".yml")):
        raise ConfigError(f"{name}: the port reads JSON configs (its tree "
                          f"is {CONFIG_ROOT}; a run's is its config.json)")
    top_path = Path(name) if name.endswith(".json") else root / f"{name}.json"
    if not top_path.exists():
        raise ConfigError(f"no such config: {top_path}")
    cfg = _read_json(top_path)

    defaults: dict[str, str | None] = dict(cfg.pop("defaults", {}) or {})
    value_overrides: list[tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        key = key.lstrip("+")
        if key in defaults and "." not in key:
            defaults[key] = val
        else:
            value_overrides.append((key, _parse_value(val)))

    for group, chosen in defaults.items():
        if chosen is None:
            continue
        sub = _read_json(_group_file(group, str(chosen), root))
        sub.pop("defaults", None)
        existing = cfg.get(group)
        if isinstance(existing, dict):
            sub = _merge(sub, existing)   # inline keys win over the group's
        cfg[group] = sub
        cfg.setdefault("_groups_", Config())[group] = str(chosen)

    for key, val in value_overrides:
        cfg.set_path(key, _configify(val), allow_new=True)

    resolve(cfg)
    return cfg


def _merge(base: Config, override: dict) -> Config:
    out = Config(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def merge(base: dict, override: dict) -> Config:
    """Recursive merge; override wins."""
    return _merge(_configify(copy.deepcopy(_plainify(base))),
                  _configify(override))


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

_MAX_PASSES = 20


def resolve(cfg: Config) -> Config:
    """Resolve ``${...}`` interpolations in place (to a fixpoint)."""
    for _ in range(_MAX_PASSES):
        if not _resolve_node(cfg, cfg):
            return cfg
    raise ConfigError("interpolation did not converge (circular reference?)")


def _resolve_node(node: Any, top: Config) -> bool:
    changed = False
    if isinstance(node, (dict, list)):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in list(items):
            if isinstance(v, str) and _INTERP_RE.search(v):
                new = _resolve_str(v, top)
                if new is not v:
                    node[k] = new
                    changed = True
            else:
                changed |= _resolve_node(v, top)
    return changed


class _Unresolved(Exception):
    pass


def _resolve_str(text: str, top: Config) -> Any:
    m = _INTERP_RE.fullmatch(text.strip())
    if m:   # the whole string: keep the value's type
        return _resolve_expr(m.group(1), top, text)

    def sub(match: re.Match) -> str:
        val = _resolve_expr(match.group(1), top, text)
        if isinstance(val, str) and _INTERP_RE.search(val):
            raise _Unresolved()
        return str(val)
    try:
        return _INTERP_RE.sub(sub, text)
    except _Unresolved:
        return text


_EVAL_ALLOWED = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
                 ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
                 ast.Pow, ast.USub, ast.UAdd, ast.IfExp, ast.Compare, ast.Eq,
                 ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.BoolOp,
                 ast.And, ast.Or, ast.Not, ast.Call, ast.Name, ast.Load)
_EVAL_FNS: dict[str, Callable] = {"min": min, "max": max, "int": int,
                                  "float": float, "round": round, "abs": abs,
                                  "len": len}


def _safe_eval(expr: str) -> Any:
    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _EVAL_ALLOWED):
            raise ConfigError(f"disallowed construct {type(node).__name__} "
                              f"in eval:{expr!r}")
        if isinstance(node, ast.Name) and node.id not in _EVAL_FNS:
            raise ConfigError(f"unknown name {node.id!r} in eval:{expr!r}")
        if isinstance(node, ast.Call) and not (
                isinstance(node.func, ast.Name) and node.func.id in _EVAL_FNS):
            raise ConfigError(f"disallowed call in eval:{expr!r}")
    return eval(compile(tree, "<cfg-eval>", "eval"), {"__builtins__": {}},
                _EVAL_FNS)


def _resolve_expr(expr: str, top: Config, original: str) -> Any:
    expr = expr.strip()
    if expr.startswith("eval:"):
        body = expr[len("eval:"):].strip()
        if body[:1] in "'\"" and body[-1:] == body[:1]:
            body = body[1:-1]
        if _INTERP_RE.search(body):
            return original     # inner interpolations not resolved yet
        return _safe_eval(body)
    val = top.get_path(expr, default=...)
    if isinstance(val, str) and _INTERP_RE.search(val):
        return original         # target not resolved yet: next pass
    return copy.deepcopy(val)


# ---------------------------------------------------------------------------
# Instantiation
# ---------------------------------------------------------------------------

_JAX = "latent_diffusion_planning_tpu."
_PORT = "latent_diffusion_planning_tpu_torch."

# the JAX tree's targets → (the port's "module:attribute", whether it takes
# the node as one config mapping)
TARGETS: dict[str, tuple[str, bool]] = {
    _JAX + "envs.lift_physics.LiftPhysicsEnv":
        (_PORT + "envs.lift_physics:LiftPhysicsEnv", False),
    _JAX + "envs.lift.LiftEnv": (_PORT + "envs.lift:LiftEnv", False),
    _JAX + "envs.pick_place.CanEnv": (_PORT + "envs.pick_place:CanEnv", False),
    _JAX + "envs.pick_place.SquareEnv":
        (_PORT + "envs.pick_place:SquareEnv", False),
    _JAX + "envs.pick_place_physics.CanPhysicsEnv":
        (_PORT + "envs.pick_place_physics:CanPhysicsEnv", False),
    _JAX + "envs.pick_place_physics.SquarePhysicsEnv":
        (_PORT + "envs.pick_place_physics:SquarePhysicsEnv", False),
    _JAX + "envs.aloha_cube.AlohaTransferCubeEnv":
        (_PORT + "envs.aloha_cube:AlohaTransferCubeEnv", False),
    _JAX + "envs.aloha_insertion.AlohaInsertionEnv":
        (_PORT + "envs.aloha_insertion:AlohaInsertionEnv", False),
    _JAX + "data.datasets.OfflineData":
        (_PORT + "data.datasets:OfflineData", False),
    _JAX + "data.datasets.MixedOfflineData":
        (_PORT + "data.datasets:MixedOfflineData", False),
    _JAX + "models.agents.ldp.LDPAgent.create":
        (_PORT + "models.agents.ldp:LDPAgent.create", True),
    _JAX + "models.agents.ldp_hier.LDPHierAgent.create":
        (_PORT + "models.agents.ldp_hier:LDPHierAgent.create", True),
    _JAX + "models.agents.dp_vae.DPVAEAgent.create":
        (_PORT + "models.agents.dp_vae:DPVAEAgent.create", True),
    _JAX + "models.agents.dp.DPAgent.create":
        (_PORT + "models.agents.dp:DPAgent.create", True),
    _JAX + "models.vae.VAEModel.create":
        (_PORT + "models.vae:VAEModel.create", True),
}


def locate(target: str) -> tuple[Callable, bool]:
    """The port's callable for a JAX tree ``_target_`` string, and whether
    it takes the node as one config mapping."""
    if target not in TARGETS:
        raise ConfigError(f"target {target!r} is not ported")
    path, as_mapping = TARGETS[target]
    module, _, attrs = path.partition(":")
    obj: Any = importlib.import_module(module)
    for attr in attrs.split("."):
        obj = getattr(obj, attr)
    return obj, as_mapping


def instantiate(cfg: Any, /, *args: Any, **kwargs: Any) -> Any:
    """Instantiate a ``_target_``-bearing config node (recursively).

    ``_partial_: true`` returns ``functools.partial`` instead of calling.
    ``_defer_: true`` leaves the node as a config dict (``_target_`` kept,
    ``_defer_`` dropped) for the callee to build, unless keywords are
    given. A class takes the node's keys as keywords, extra keywords
    overriding them; a factory that takes one config mapping (the agents'
    and the VAE's ``create(config, ...)``) takes the node as that mapping
    and the extra arguments after it."""
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(instantiate(v) for v in cfg)
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return Config({k: instantiate(v) for k, v in cfg.items()})
    node = dict(cfg)
    if node.pop("_defer_", False) and not kwargs:
        return Config(node)
    target, as_mapping = locate(node.pop("_target_"))
    partial = bool(node.pop("_partial_", False))
    node.pop("_groups_", None)
    built = {k: instantiate(v) for k, v in node.items()}
    if as_mapping:
        call = functools.partial(target, Config(built), *args, **kwargs)
    else:
        call = functools.partial(target, *args, **{**built, **kwargs})
    return call if partial else call()


def parse_cli(argv: list[str]) -> tuple[str | None, list[str]]:
    """Split argv into (config name, overrides): ``--config NAME`` / ``-c
    NAME`` selects the top-level config, everything else is ``key=value``."""
    name = None
    overrides: list[str] = []
    it = iter(argv)
    for tok in it:
        if tok in ("--config", "-c"):
            name = next(it)
        elif "=" in tok:
            overrides.append(tok)
        else:
            raise ConfigError(f"unrecognized argument {tok!r}")
    return name, overrides
