"""Demo CLIs run end-to-end in CI — both reference modes (bg | sub).

Subprocess invocations exactly as a user would type them (reference CLI
contract, e.g. ``demo/weak-dirichlet/flower/main.py:17-29``), shrunk via
``--n``.  The sub runs exercise the submesh path (box_mode=False tag
transfer + exterior measure) through a full solve.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")


def _run(rel, *args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, rel), *args],
        capture_output=True,
        text=True,
        # 1800: a demo CLI can share the 1-CPU box with long study jobs
        # (a 900s cap flaked under 4-way contention in round 5)
        timeout=1800,
        env=env,
        cwd=REPO,
    )
    assert r.returncode == 0, f"{rel} {args} failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}"
    return r.stdout


@pytest.mark.parametrize("mode", ["bg", "sub"])
def test_weak_dirichlet_flower_cli(mode):
    out = _run("demo/weak-dirichlet/flower/main.py", mode, "--n", "40")
    assert "converged=True" in out, out[-500:]


@pytest.mark.parametrize("mode", ["bg", "sub"])
def test_neumann_square_cli(mode):
    out = _run("demo/neumann/square/main.py", mode, "--n", "40")
    assert "H1" in out or "error" in out.lower(), out[-500:]


def test_interface_elasticity_quick_cli():
    out = _run("demo/interface-elasticity/main.py", "param_quick")
    assert "slope" in out.lower(), out[-500:]


@pytest.mark.parametrize("scheme", ["weak", "strong", "neumann", "robin"])
def test_poisson3d_cli(scheme):
    out = _run("demo/poisson3d/main.py", scheme, "--n", "8")
    assert "converged=True" in out, out[-500:]
    assert "Relative L2 error" in out, out[-500:]


def test_poisson3d_elasticity_cli():
    out = _run(
        "demo/poisson3d/main.py", "elasticity", "--n", "8",
        "--tol", "1e-6", "--sweeps", "12", "--maxiter", "120",
    )
    assert "converged=True" in out, out[-500:]
    assert "Relative L2 error" in out, out[-500:]
