"""chip_smoke.py on the CPU backend: its phase functions at tiny sizes with
the same checks, its device gate, and the package's placement of the
compilation cache.  The run on the card itself is the ``gpu``-marked test
at the end."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.mark.parametrize(
    "phase, n, keys",
    [
        ("phase_s1", 24, ("u_vs_sparse_rel_l2", "tap_vs_generic_f64", "tap_f32_vs_f64")),
        ("phase_box", 32, ("true_residual", "nodal_l2_error")),
    ],
)
def test_phase_small(phase, n, keys):
    """The phase runs end to end and every check it records holds."""
    cs = _load()
    info = getattr(cs, phase)(n)
    assert info["n"] == n
    for k in keys:
        assert info[k] <= info[k + "_limit"], (k, info[k])


def test_device_gate_refuses_cpu():
    """Without a GPU the script exits non-zero and prints no result."""
    p = subprocess.run(
        [sys.executable, SCRIPT],
        cwd=REPO,
        env=_child_env(),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


@pytest.mark.parametrize("where", ["env", "checkout"])
def test_compilation_cache_dir(where, tmp_path):
    """JAX_COMPILATION_CACHE_DIR places the cache when set; otherwise it
    is ``.jax_cache`` at the root of the checkout.  A compiled program
    lands there."""
    want = str(tmp_path / "xla") if where == "env" else os.path.join(REPO, ".jax_cache")
    extra = {"JAX_COMPILATION_CACHE_DIR": want} if where == "env" else {}
    code = (
        "import jax, jax.numpy as jnp, phifem_tpu\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0 + %r)(jnp.ones(7))\n"
        "print(jax.config.jax_compilation_cache_dir)\n" % float(len(where))
    )
    p = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=_child_env(**extra),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == want
    assert os.path.isdir(want) and os.listdir(want)


def test_preconditioner_products_pinned():
    """Every product and dot in the float32 S1 lattice preconditioner asks
    for full float32 precision (a GPU would otherwise be free to run
    them in TF32)."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    import phifem_tpu as pf
    from phifem_tpu.models import WeakDirichletPoisson

    g = pf.Grid(24, 24, ((-1.0, -1.0), (1.0, 1.0)), pf.CellType.triangle)
    s = WeakDirichletPoisson(g, mode="bg")
    s.setup(lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49, lambda x: jnp.ones(x.shape[:-1]))
    s.assemble()
    vc = s.lattice_preconditioner(min_n=6)
    assert vc.interface_inv is not None and vc.interface_inv.dtype == jnp.float32
    jaxpr = jax.make_jaxpr(vc)(s.b)

    dots = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                dots.append(eqn)
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    if isinstance(sub, ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr)
    f32 = [e for e in dots if e.invars[0].aval.dtype == np.float32]
    assert f32, "no float32 products traced"
    for e in f32:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec
        ), e


@pytest.fixture
def gpu():
    """Skip unless this machine has an NVIDIA card."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole smoke run on the card (its own process: the test session
    itself is pinned to the CPU)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    p = subprocess.run(
        [sys.executable, SCRIPT], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=1500,
    )
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
