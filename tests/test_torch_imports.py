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
                 "dedalus_tpu_torch/libraries/sphere.py",
                 "dedalus_tpu_torch/core/stepgraph.py",
                 "dedalus_tpu_torch/core/spherical3d.py",
                 "dedalus_tpu_torch/libraries/spin_intertwiners.py",
                 "dedalus_tpu_torch/libraries/zernike.py",
                 "dedalus_tpu_torch/core/arithmetic.py",
                 "dedalus_tpu_torch/core/subsystems.py",
                 "dedalus_tpu_torch/core/solvers.py",
                 "dedalus_tpu_torch/extras/flow_tools.py",
                 "dedalus_tpu_torch/extras/bench_problems.py",
                 "dedalus_tpu_torch/tools/carry.py",
                 "dedalus_tpu_torch/core/cylinder.py"):
        assert must in names


def test_shell_public_api_without_jax():
    """The shell's public names import in a fresh interpreter with no jax
    module loaded."""
    import subprocess
    import sys
    code = ("import sys; "
            "from dedalus_tpu_torch.public import (SphericalCoordinates, "
            "ShellBasis, cross, curl, transpose, angular, "
            "SphericalEllProduct); "
            "from dedalus_tpu_torch.core import spherical3d; "
            "from dedalus_tpu_torch.libraries import spin_intertwiners; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_ball_public_api_without_jax():
    """The ball's public names (BallBasis, its build functions and the Zernike
    library) import in a fresh interpreter with no jax module loaded."""
    import subprocess
    import sys
    code = ("import sys; "
            "from dedalus_tpu_torch.public import (SphericalCoordinates, "
            "BallBasis, trans, Lift, NLBVP); "
            "from dedalus_tpu_torch.extras.bench_problems import ("
            "build_ball_convection, build_lane_emden); "
            "from dedalus_tpu_torch.libraries import zernike; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_cylinder_public_api_without_jax():
    """The cylinder's public names (DirectProduct, its calculus module and
    builders) import, and d3.DirectProduct(Coordinate, PolarCoordinates)
    builds, in a fresh interpreter with no jax module loaded."""
    import subprocess
    import sys
    code = ("import sys; "
            "import dedalus_tpu_torch.public as d3; "
            "c = d3.DirectProduct(d3.Coordinate('z'), "
            "d3.PolarCoordinates('phi', 'r')); "
            "assert c.dim == 3 and not c.right_handed; "
            "from dedalus_tpu_torch.core import cylinder; "
            "from dedalus_tpu_torch.extras.bench_problems import ("
            "build_pipe_flow, build_cylinder_diffusion, "
            "build_pipe_flow_evp, build_annulus_cylinder_poisson); "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
