"""Ring attention (ops/ring_attention.py) on the virtual 8-device CPU mesh.

Exactness bar: the ring is a re-association of the same softmax, so forward
must match plain attention to f32 roundoff and gradients must match the
reference (the lse-cotangent path through the per-visit block attention is
what makes the merged backward exact — also pinned here standalone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.models import init_params, make_model
from musicstyletransfer_tpu.ops import ring_attention_sharded
from musicstyletransfer_tpu.ops import attention as attention_ops
from musicstyletransfer_tpu.ops.ring_attention import block_attention
from musicstyletransfer_tpu.parallel import make_mesh
from tests.test_model import tiny_config


def _qkv(B=2, H=2, T=32, D=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (
        jnp.asarray(rng.normal(size=(B, H, T, D)).astype(np.float32))
        for _ in range(3)
    )
    return q, k, v


def reference_attention(q, k, v, key_lens, causal, sm_scale):
    """ops.attention.reference_attention in this file's [B, H, T, D]
    layout (its scale is always 1/sqrt(D))."""
    assert np.isclose(sm_scale, 1.0 / np.sqrt(q.shape[-1]))
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    return t(attention_ops.reference_attention(t(q), t(k), t(v), key_lens,
                                               causal))


def _ref_lse(q, k, v, key_lens, causal, sm_scale):
    """XLA out + logsumexp ground truth (same masking as the kernel)."""
    T = q.shape[2]
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    mask = jnp.arange(T)[None, :] < key_lens[:, None]
    bias = jnp.where(mask[:, None, None, :], 0.0, -1e30)
    if causal:
        tri = jnp.tril(jnp.ones((T, T), bool))
        bias = bias + jnp.where(tri[None, None], 0.0, -1e30)
    z = logits + bias
    lse = jax.scipy.special.logsumexp(z, axis=-1)
    out = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(z, axis=-1), v)
    return out, lse


class TestFlashWithLse:
    """The ring's per-visit block attention (out, logsumexp): both outputs
    and both cotangent paths."""

    @pytest.mark.parametrize("causal", [False, True])
    def test_forward_out_and_lse(self, causal):
        q, k, v = _qkv()
        key_lens = jnp.asarray([32, 17], jnp.int32)
        sm = 1.0 / np.sqrt(q.shape[-1])
        out, lse = block_attention(q, k, v, key_lens, causal, sm)
        ref_out, ref_lse = _ref_lse(q, k, v, key_lens, causal, sm)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref_out),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(lse), np.asarray(ref_lse),
                                   atol=1e-4)

    @pytest.mark.parametrize("causal", [False, True])
    def test_grads_through_both_outputs(self, causal):
        """The lse cotangent folds into delta (ds = p*(dp - delta + g_lse));
        grads of a scalar consuming BOTH outputs must match XLA."""
        q, k, v = _qkv(seed=1)
        key_lens = jnp.asarray([32, 21], jnp.int32)
        sm = 1.0 / np.sqrt(q.shape[-1])
        rng = np.random.default_rng(2)
        w_out = jnp.asarray(rng.normal(size=q.shape).astype(np.float32))
        w_lse = jnp.asarray(
            rng.normal(size=q.shape[:3]).astype(np.float32)
        )

        def f_flash(q, k, v):
            out, lse = block_attention(q, k, v, key_lens, causal, sm)
            return jnp.sum(out * w_out) + jnp.sum(lse * w_lse)

        def f_ref(q, k, v):
            out, lse = _ref_lse(q, k, v, key_lens, causal, sm)
            return jnp.sum(out * w_out) + jnp.sum(lse * w_lse)

        g_flash = jax.grad(f_flash, argnums=(0, 1, 2))(q, k, v)
        g_ref = jax.grad(f_ref, argnums=(0, 1, 2))(q, k, v)
        for a, b in zip(g_flash, g_ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=2e-4)


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("tp", [2, 4])
    def test_matches_reference(self, cpu_devices, causal, tp):
        mesh = make_mesh(cpu_devices[:8], tp=tp)
        q, k, v = _qkv(B=4, T=32)
        key_lens = jnp.asarray([32, 17, 9, 25], jnp.int32)
        out = ring_attention_sharded(
            q, k, v, key_lens, causal=causal, mesh=mesh
        )
        ref = reference_attention(
            q, k, v, key_lens, causal, 1.0 / np.sqrt(q.shape[-1])
        )
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=1e-5)

    @pytest.mark.parametrize("causal", [False, True])
    def test_grads_match_reference(self, cpu_devices, causal):
        """grad through scan + ppermute + the lse merge must equal the
        plain-attention gradient (the ring is exact, not approximate)."""
        mesh = make_mesh(cpu_devices[:8], tp=4)
        q, k, v = _qkv(B=2, T=32, seed=3)
        key_lens = jnp.asarray([32, 19], jnp.int32)
        sm = 1.0 / np.sqrt(q.shape[-1])
        rng = np.random.default_rng(4)
        w = jnp.asarray(rng.normal(size=q.shape).astype(np.float32))

        def f_ring(q, k, v):
            out = ring_attention_sharded(
                q, k, v, key_lens, causal=causal, mesh=mesh
            )
            return jnp.sum(out * w)

        def f_ref(q, k, v):
            return jnp.sum(
                reference_attention(q, k, v, key_lens, causal, sm) * w
            )

        g_ring = jax.jit(jax.grad(f_ring, argnums=(0, 1, 2)))(q, k, v)
        g_ref = jax.grad(f_ref, argnums=(0, 1, 2))(q, k, v)
        for a, b in zip(g_ring, g_ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=2e-4)

    def test_fully_hidden_and_partial_chunks(self, cpu_devices):
        """key_lens shorter than one chunk: later chunks contribute nothing
        (their ring steps are fully masked) and the result still matches."""
        mesh = make_mesh(cpu_devices[:8], tp=4)
        q, k, v = _qkv(B=2, T=32, seed=5)
        key_lens = jnp.asarray([5, 11], jnp.int32)  # inside chunk 0 / 1
        out = ring_attention_sharded(
            q, k, v, key_lens, causal=True, mesh=mesh
        )
        ref = reference_attention(
            q, k, v, key_lens, True, 1.0 / np.sqrt(q.shape[-1])
        )
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=1e-5)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("T", [29, 33])
    def test_time_axis_not_divisible_by_ring(self, cpu_devices, causal, T):
        """T that does not divide the ring is padded internally and sliced
        back — required because the VAE's encoder (L+1) and decoder (L+2)
        see consecutive lengths that no ring > 1 could both divide."""
        mesh = make_mesh(cpu_devices[:8], tp=4)
        q, k, v = _qkv(B=2, T=T, seed=8)
        key_lens = jnp.asarray([T, T - 7], jnp.int32)
        out = ring_attention_sharded(
            q, k, v, key_lens, causal=causal, mesh=mesh
        )
        ref = reference_attention(
            q, k, v, key_lens, causal, 1.0 / np.sqrt(q.shape[-1])
        )
        assert out.shape == q.shape
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=1e-5)


def _ring_config(base, **tc_overrides):
    tc = dataclasses.replace(
        base.encoder_config.transformer_config, ring_attention=True,
        **tc_overrides,
    )
    return dataclasses.replace(
        base,
        encoder_config=dataclasses.replace(
            base.encoder_config, transformer_config=tc
        ),
        decoder_config=dataclasses.replace(
            base.decoder_config, transformer_config=tc
        ),
    )


class TestRingInModel:
    """ring_attention=True engages on BOTH stacks: the encoder's L+1 and
    decoder's L+2 are consecutive lengths, which the internal time-padding
    serves (no ring > 1 could divide both). Both L parities must agree
    with the base model."""

    @pytest.mark.parametrize("L", [6, 7])
    def test_forward_matches_base(self, cpu_devices, L):
        from musicstyletransfer_tpu.parallel.mesh import use_mesh

        base = tiny_config(vocab=10, classes=3, latent=8, size=16, heads=2,
                           layers=1)
        m0 = make_model(base)
        m1 = make_model(_ring_config(base))
        params = init_params(m0, jax.random.key(0), max_seq_len=L)
        B = 4
        rng = np.random.default_rng(6)
        tokens = np.concatenate(
            [np.full((B, 1), 1, np.int32),
             rng.integers(3, 10, (B, L)).astype(np.int32)], axis=1,
        )
        seq_lens = np.asarray([L + 1, L, L - 1, L + 1], np.int32)
        classes = rng.integers(0, 3, (B,)).astype(np.int32)

        def fwd(model):
            return model(params, jnp.asarray(tokens), jnp.asarray(seq_lens),
                         jnp.asarray(classes))

        ref = fwd(m0)
        mesh = make_mesh(cpu_devices[:8], tp=2)
        with use_mesh(mesh):
            got = jax.jit(lambda: fwd(m1))()
        for a, b in zip(ref, got):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-5)

    def test_train_step_on_mesh(self, cpu_devices):
        """Full sharded train step with ring attention: loss matches the
        unsharded base-model step (dropout off, deterministic z via rng)."""
        from musicstyletransfer_tpu.training import (
            LossConfig, OptimizerConfig, build_optimizer, create_train_state,
            make_train_step, shard_train_state,
        )

        base = tiny_config(vocab=10, classes=3, latent=8, size=16, heads=2,
                           layers=1)
        m0 = make_model(base)
        m1 = make_model(_ring_config(base))
        L, B = 6, 8
        params = init_params(m0, jax.random.key(0), max_seq_len=L)
        tx = build_optimizer(OptimizerConfig("adam", "", 1e-3))
        loss_cfg = LossConfig()
        rng = np.random.default_rng(7)
        tokens = np.concatenate(
            [np.full((B, 1), 1, np.int32),
             rng.integers(3, 10, (B, L)).astype(np.int32)], axis=1,
        )
        seq_lens = np.full((B,), L + 1, np.int32)
        classes = rng.integers(0, 3, (B,)).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((B, 1), 2, np.int32)], axis=1
        )
        data = (tokens, seq_lens, classes, labels)

        s0 = create_train_state(params, tx, jax.random.key(7))
        step0 = make_train_step(m0, tx, loss_cfg)
        s0, a0 = step0(s0, None, *(jnp.asarray(x) for x in data))

        mesh = make_mesh(cpu_devices[:8], tp=2)
        s1 = create_train_state(params, tx, jax.random.key(7))
        s1 = shard_train_state(s1, mesh)
        step1 = make_train_step(m1, tx, loss_cfg, mesh=mesh)
        s1, a1 = step1(s1, None, *data)

        np.testing.assert_allclose(
            float(a0["total_loss"][0]), float(a1["total_loss"][0]), rtol=1e-5
        )
