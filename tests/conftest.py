"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Must set platform/XLA flags before jax initializes (mirrors the multi-device
testing recipe from SURVEY.md section 4).
"""

import os

# The suite runs on the CPU backend as a virtual 8-device mesh, whatever
# platform the environment names.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402  (after the env setup above)

# --slow is registered in the ROOTDIR conftest.py (sub-directory conftests
# only register CLI options when tests/ is an initial command-line path).


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running convergence/3D/unstructured study — excluded "
        "from the default fast lane; run with --slow or PHIFEM_SLOW=1",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card; skips without one (run on the card "
        "with `pytest -m gpu tests/`)",
    )


def _slow_manifest():
    """Measured-duration slow list (node ids, one per line): every test
    whose setup+call exceeded 15 s in the last full-suite run
    (`PHIFEM_SLOW=1 pytest -q --durations=0`).  Regenerate by re-running
    the full suite and updating tests/slow_tests.txt; explicit
    ``@pytest.mark.slow`` marks work too."""
    path = os.path.join(os.path.dirname(__file__), "slow_tests.txt")
    try:
        with open(path) as f:
            return {l.strip() for l in f if l.strip()}
    except OSError:
        return set()


def pytest_collection_modifyitems(config, items):
    if config.getoption("--slow") or os.environ.get("PHIFEM_SLOW") == "1":
        return
    manifest = _slow_manifest()
    skip = pytest.mark.skip(reason="slow lane (pass --slow or PHIFEM_SLOW=1)")
    for item in items:
        if "slow" in item.keywords or item.nodeid in manifest:
            item.add_marker(skip)
