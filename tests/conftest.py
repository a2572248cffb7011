"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite is hermetic and CPU-only. Tests that need a GPU carry the
``chip`` marker and skip here (see the ``gpu_devices`` fixture); run them
on a GPU machine with ``python -m pytest tests/test_chip.py``.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import pytest  # noqa: E402

from musicstyletransfer_tpu.utils import configure_jax_cache  # noqa: E402

# Persist XLA compilations across test runs (the suite is compile-bound).
configure_jax_cache(min_compile_secs=0.5)

_REPO_CORPUS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "work", "data", "guitar_bass")


@pytest.fixture(scope="session", autouse=True)
def _cpu_default_device():
    cpus = jax.devices("cpu")
    assert len(cpus) >= 8, f"expected 8 virtual CPU devices, got {len(cpus)}"
    with jax.default_device(cpus[0]):
        yield


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture(scope="session")
def corpus_path():
    if not os.path.isdir(_REPO_CORPUS):
        pytest.skip("bundled corpus not available")
    return _REPO_CORPUS


@pytest.fixture(scope="session")
def gpu_devices():
    """The GPU devices, for ``chip``-marked tests; skips where JAX has no
    GPU (decided here, at run time, never while collecting)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (chip test); none visible to JAX")
    return gpus
