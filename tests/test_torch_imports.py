"""The port, its command-line tools (``tools/*_torch.py``) and
chip_smoke.py import nothing of JAX or the JAX package, and nothing the
card's machine lacks (``h5py``, ``yaml``, ``PIL``, ``imageio``) at module
level; the config system reads its JSON tree with no YAML reader at all.

Checked on the source with ``ast`` (not by importing), so a forbidden import
anywhere in a module fails even on a path the tests do not run.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax",
             "latent_diffusion_planning_tpu")
# tools/export_bench_torch.py reads the JAX package's orbax checkpoint into
# the port's format, so it is the one tool that must import JAX
FILES = sorted((REPO / "latent_diffusion_planning_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted(
        p for p in (REPO / "tools").glob("*_torch.py")
        if p.name != "export_bench_torch.py")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


ABSENT_ON_THE_CARD = ("h5py", "yaml", "PIL", "imageio")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_level_imports_the_card_lacks(path):
    """``h5py``, ``yaml``, ``PIL`` and ``imageio`` may be imported inside a
    function (a loader the card's path never calls), not when the module is
    imported."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = ast.Module(body=[n for n in tree.body
                           if isinstance(n, (ast.Import, ast.ImportFrom,
                                             ast.If, ast.Try))],
                     type_ignores=[])
    bad = [m for m in _imported(top) if m.split(".")[0] in ABSENT_ON_THE_CARD]
    assert not bad, f"{path.name} imports {bad} at module level"


def test_port_and_smoke_exist():
    assert len(FILES) > 20
    assert (REPO / "chip_smoke.py").exists()
    port = REPO / "latent_diffusion_planning_tpu_torch"
    for module in ("models/nets/resnet.py", "models/agents/dp.py",
                   "models/agents/ldp_hier.py", "utils/precision.py"):
        assert port / module in FILES, module


def test_can_square_and_init_modules_are_covered():
    port = REPO / "latent_diffusion_planning_tpu_torch"
    for module in ("envs/pick_place.py", "envs/pick_place_physics.py",
                   "envs/from_meta.py", "models/nets/init.py"):
        assert port / module in FILES, module


def test_drivers_and_their_tools_are_covered():
    port = REPO / "latent_diffusion_planning_tpu_torch"
    for name in ("collect_demos", "train_vae", "process_latents", "train_bc",
                 "collect_data", "train_mixed_bc", "eval_bc"):
        assert port / "drivers" / f"{name}.py" in FILES, name
        assert REPO / "tools" / f"{name}_torch.py" in FILES, name


def test_config_tree_has_no_yaml_reader_behind_it():
    """``utils/config.py`` imports ``yaml`` nowhere, not even inside a
    function, and its tree holds JSON files only."""
    module = REPO / "latent_diffusion_planning_tpu_torch" / "utils" / "config.py"
    tree = ast.parse(module.read_text())
    assert not [m for m in _imported(tree) if m.split(".")[0] == "yaml"]
    conf = REPO / "latent_diffusion_planning_tpu_torch" / "conf"
    files = [p for p in conf.rglob("*") if p.is_file()]
    assert files and all(p.suffix == ".json" for p in files)


def test_aloha_modules_are_covered():
    port = REPO / "latent_diffusion_planning_tpu_torch"
    for module in ("envs/aloha_constants.py", "envs/aloha_kdops.py",
                   "envs/aloha_base.py", "envs/aloha_cube.py",
                   "envs/aloha_insertion.py"):
        assert port / module in FILES, module


def test_runtime_and_offline_modules_are_covered():
    """The video, rank, transfer, prefetch, synthetic, MJCF modules and
    their tools are checked above; the prefetcher's C++ source is the JAX
    package's, byte for byte below its header comment."""
    port = REPO / "latent_diffusion_planning_tpu_torch"
    for module in ("parallel/mesh.py", "train/transfer.py",
                   "data/host_prefetch.py", "data/synthetic.py",
                   "envs/mjcf.py", "utils/media.py", "rollout/engine.py"):
        assert port / module in FILES, module
    for tool in ("export_reference_ckpt_torch.py",
                 "import_reference_ckpt_torch.py", "roundtrip_eval_torch.py"):
        assert REPO / "tools" / tool in FILES, tool
    body = lambda p: p.read_text().split("#include <atomic>", 1)[1]
    assert body(port / "csrc" / "window_prefetch.cpp") == body(
        REPO / "native" / "window_prefetch.cpp")
