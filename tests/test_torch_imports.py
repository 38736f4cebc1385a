"""
The port imports neither jax nor anything of the JAX package: an AST scan
of every module of dedalus_tpu_torch/ and of chip_smoke.py (importing any
dedalus_tpu module would import jax, dedalus_tpu/__init__.py:29-31).
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "dedalus_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dedalus_tpu")


def imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("chip_smoke.py", "dedalus_tpu_torch/core/fusedstep.py",
                 "dedalus_tpu_torch/libraries/pencilops.py",
                 "dedalus_tpu_torch/public.py",
                 "dedalus_tpu_torch/core/curvilinear.py",
                 "dedalus_tpu_torch/core/polar.py",
                 "dedalus_tpu_torch/core/sphere.py",
                 "dedalus_tpu_torch/libraries/sphere.py"):
        assert must in names


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
