"""The port and chip_smoke.py import nothing of JAX or the JAX package,
and nothing the card's machine lacks (``h5py``, ``yaml``) at module level.

Checked on the source with ``ast`` (not by importing), so a forbidden import
anywhere in a module fails even on a path the tests do not run.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax",
             "latent_diffusion_planning_tpu")
FILES = sorted((REPO / "latent_diffusion_planning_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


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


ABSENT_ON_THE_CARD = ("h5py", "yaml")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_level_imports_the_card_lacks(path):
    """``h5py`` and ``yaml`` may be imported inside a function (a loader the
    card's path never calls), not when the module is imported."""
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
