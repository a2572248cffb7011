"""Device discipline on the CPU: the GPU-or-fail gate, the peak table, and
where the persistent compilation cache lands."""

import os
import subprocess
import sys

import pytest

from musicstyletransfer_tpu import hardware, utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gate_refuses_cpu():
    with pytest.raises(hardware.NoGPUError, match="no GPU found"):
        hardware.require_gpu()


def test_device_summary_names_the_platform():
    summary = hardware.device_summary()
    assert summary["platform"] == "cpu" and summary["count"] >= 1
    assert isinstance(summary["kind"], str)


def test_peak_table_raises_on_unknown_kind():
    with pytest.raises(KeyError, match="no published peaks"):
        hardware.peaks("cpu")


@pytest.mark.parametrize("kind", sorted(hardware.PEAKS))
def test_peak_table_entries_are_complete(kind):
    p = hardware.peaks(kind)
    assert set(p) == {"bf16_flops", "hbm_bytes_per_s"}
    assert p["bf16_flops"] > 0 and p["hbm_bytes_per_s"] > 0


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(hardware.shutil, "which", lambda name: None)
    with pytest.raises(hardware.NoGPUError, match="nvidia-smi"):
        hardware.card_info()


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(utils.COMPILE_CACHE_ENV, str(tmp_path))
    assert utils.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv(utils.COMPILE_CACHE_ENV)
    assert utils.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


_PROBE = """
import jax, jax.numpy as jnp
from musicstyletransfer_tpu.utils import configure_jax_cache
print(configure_jax_cache(min_compile_secs=0.0))
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
"""


def _probe(env):
    env = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_cache_lands_exactly_in_env_dir(tmp_path):
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache))
    returned, configured = _probe(env)
    assert returned == configured == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_cache_defaults_to_one_fixed_dir_in_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    returned, configured = _probe(env)
    want = os.path.join(REPO, ".jax_cache")
    assert returned == configured == want
    assert os.path.isdir(want)
