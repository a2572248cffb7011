"""Tests that need a GPU (marker ``chip``): compiled for the card, compared
with the float32 references at real widths. They skip on machines without
one; run them on a GPU machine with ``python -m pytest tests/test_chip.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.ops.attention import (
    attention,
    choose_implementation,
    cudnn_min_seq_len,
    reference_attention,
)

pytestmark = pytest.mark.chip

# bf16 operands and output: ~2^-8 relative per rounding (see chip_smoke.py).
TOL_BF16 = 3e-2


def _case(B, T, H, D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (jnp.asarray(rng.normal(size=(B, T, H, D)), jnp.bfloat16)
               for _ in range(3))
    lens = jnp.asarray(rng.integers(T // 2, T + 1, B), jnp.int32)
    return q, k, v, lens


@pytest.fixture
def on_gpu(gpu_devices):
    """Run the test body with the GPU as default device (the session
    fixture pins the CPU for the rest of the suite)."""
    with jax.default_device(gpu_devices[0]):
        yield gpu_devices[0]


@pytest.mark.parametrize("B,T,H,D,causal", [
    (32, 66, 8, 16, True),      # flagship decoder (XLA below the crossover)
    (8, 513, 16, 64, False),    # wide encoder (odd T: cuDNN pads)
    (4, 2048, 8, 32, True),     # long decoder
])
def test_attention_matches_reference_on_gpu(on_gpu, B, T, H, D, causal):
    q, k, v, lens = _case(B, T, H, D)
    want_impl = "cudnn" if T >= cudnn_min_seq_len(D) else "xla"
    assert choose_implementation(q) == want_impl
    out = jax.jit(attention, static_argnums=(4,))(q, k, v, lens, causal)
    with jax.default_matmul_precision("highest"):
        ref = reference_attention(q, k, v, lens, causal)
    err = float(jnp.max(jnp.abs(out.astype(jnp.float32) - ref))
                / jnp.max(jnp.abs(ref)))
    assert err < TOL_BF16, err


def test_long_attention_lowers_to_cudnn(on_gpu):
    q, k, v, lens = _case(4, 2048, 8, 64)

    def loss(q, k, v):
        return jnp.sum(attention(q, k, v, lens, True).astype(jnp.float32))

    hlo = jax.jit(jax.grad(loss, argnums=(0, 1, 2))).lower(
        q, k, v).compile().as_text()
    assert "cudnn$fmha" in hlo
