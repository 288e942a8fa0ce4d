"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The reference tests run single-threaded CPU Rust; our analogue
(SURVEY §4 "multi-node testing") is the CPU backend with
``xla_force_host_platform_device_count=8`` so sharding tests exercise a
virtual 8-device mesh without accelerator hardware.  Tests marked ``gpu``
need the card: the ``gpu_device`` fixture skips them elsewhere, and
``JAX_PLATFORMS= python -m pytest tests -m gpu`` runs them on a GPU host.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402
import relp_tpu  # noqa: E402,F401  — x64 before any jax use

REFERENCE_DATA = "/root/reference/tests"


def reference_problem(suite: str, name: str) -> str:
    """Path to a vendored public problem file of the reference test corpora
    (Netlib/Burkardt/Unicamp/MIPLIB/Cook); skip if unavailable."""
    path = os.path.join(REFERENCE_DATA, suite, "problem_files", name)
    if not os.path.exists(path):
        pytest.skip(f"reference problem file {path} not available")
    return path


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none (decided at run
    time, so every worker collects the same tests)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (device 0 is {dev.platform})")
    return dev


def pytest_collection_modifyitems(config, items):
    """Slow (beyond-ceiling) instances are hours-long on the CPU backend;
    they are opt-in here."""
    if os.environ.get("RELP_TPU_RUN_SLOW"):
        return
    skip = pytest.mark.skip(
        reason="slow on CPU; set RELP_TPU_RUN_SLOW=1"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
