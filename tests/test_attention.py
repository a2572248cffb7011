"""ops/attention.py: the one attention function of the model against its
float32 reference (masks, causality, padding lengths, odd T, gradients),
the choice between cuDNN and XLA, and the model's attention block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.ops import attention as attn_mod
from musicstyletransfer_tpu.ops.attention import (
    attention,
    choose_implementation,
    reference_attention,
)


def _qkv(B=3, T=17, H=2, D=8, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    return tuple(
        jnp.asarray(rng.normal(size=(B, T, H, D)).astype(np.float32)).astype(
            dtype)
        for _ in range(3)
    )


def _naive(q, k, v, key_lens, causal):
    """Loop-free numpy restatement of the masking contract."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    B, T, H, D = q.shape
    S = k.shape[1]
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    mask = np.arange(S)[None, None, None, :] < np.asarray(key_lens)[
        :, None, None, None]
    if causal:
        mask = mask & (np.arange(S)[None, :] <= np.arange(T)[:, None])
    s = np.where(mask, s, -np.inf)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1, 7, 33, 66])
def test_reference_matches_numpy(causal, T):
    q, k, v = _qkv(T=T, seed=T)
    key_lens = jnp.asarray([T, max(1, T - 3), 1], jnp.int32)
    got = reference_attention(q, k, v, key_lens, causal)
    np.testing.assert_allclose(np.asarray(got),
                               _naive(q, k, v, key_lens, causal), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1, 7, 33, 66])
def test_forward_matches_reference_f32(causal, T):
    q, k, v = _qkv(T=T, seed=10 + T)
    key_lens = jnp.asarray([T, max(1, T // 2), 1], jnp.int32)
    with jax.default_matmul_precision("highest"):
        got = jax.jit(attention, static_argnums=(4,))(q, k, v, key_lens,
                                                      causal)
    want = reference_attention(q, k, v, key_lens, causal)
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_bf16_close_to_reference(causal):
    """bf16 operands: 8 mantissa bits on q, k, v and the output, so agree
    to ~2^-7 relative of the O(1) outputs."""
    q, k, v = _qkv(T=40, seed=5, dtype=jnp.bfloat16)
    key_lens = jnp.asarray([40, 23, 2], jnp.int32)
    got = attention(q, k, v, key_lens, causal)
    want = reference_attention(q, k, v, key_lens, causal)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want), atol=3e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [9, 32])
def test_gradients_match_reference(causal, T):
    q, k, v = _qkv(B=2, T=T, seed=20 + T)
    key_lens = jnp.asarray([T, T - 4], jnp.int32)
    w = jnp.asarray(np.random.default_rng(1).normal(size=q.shape),
                    jnp.float32)

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v, key_lens, causal) * w)

    with jax.default_matmul_precision("highest"):
        g = jax.grad(loss(attention), argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(loss(reference_attention), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_padded_keys_do_not_leak():
    """Values beyond key_lens never reach the output: rewriting them
    leaves the result bit-identical."""
    q, k, v = _qkv(B=2, T=12, seed=3)
    key_lens = jnp.asarray([5, 9], jnp.int32)
    out = attention(q, k, v, key_lens, False)
    k2 = k.at[0, 5:].set(100.0).at[1, 9:].set(-100.0)
    v2 = v.at[0, 5:].set(7.0).at[1, 9:].set(-7.0)
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(attention(q, k2, v2, key_lens,
                                                       False)))


def test_causal_ignores_future_keys():
    q, k, v = _qkv(B=1, T=10, seed=4)
    lens = jnp.asarray([10], jnp.int32)
    out = attention(q, k, v, lens, True)
    k2, v2 = k.at[:, 6:].set(3.0), v.at[:, 6:].set(-3.0)
    out2 = attention(q, k2, v2, lens, True)
    np.testing.assert_array_equal(np.asarray(out[:, :6]),
                                  np.asarray(out2[:, :6]))
    assert not np.allclose(np.asarray(out[:, 6:]), np.asarray(out2[:, 6:]))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1, 9, 65])
def test_odd_length_padding_is_exact(causal, T):
    """The pad-to-even route cuDNN takes at odd T (here through XLA) gives
    the unpadded result."""
    q, k, v = _qkv(T=T, seed=30 + T)
    key_lens = jnp.asarray([T, max(1, T - 5), 1], jnp.int32)
    with jax.default_matmul_precision("highest"):
        got = attn_mod.attend_even_length(q, k, v, key_lens, causal, "xla")
        want = attention(q, k, v, key_lens, causal, implementation="xla")
    assert got.shape == q.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-6)


class TestChooseImplementation:
    def test_cpu_takes_xla(self):
        q, _, _ = _qkv(dtype=jnp.bfloat16, D=32)
        assert choose_implementation(q) == "xla"

    @pytest.mark.parametrize("dtype,head_dim,want", [
        (jnp.bfloat16, 16, "cudnn"),   # long decoder heads
        (jnp.bfloat16, 64, "cudnn"),   # wide encoder heads
        (jnp.float16, 256, "cudnn"),
        (jnp.float32, 32, "xla"),      # cuDNN flash attention is half only
        (jnp.bfloat16, 12, "xla"),     # head dim must be a multiple of 8
        (jnp.bfloat16, 512, "xla"),    # and at most 256
    ])
    def test_gpu_choice_by_dtype_and_head_dim(self, monkeypatch, dtype,
                                              head_dim, want):
        monkeypatch.setattr(attn_mod, "_on_gpu", lambda: True)
        q = jnp.zeros((1, 513, 2, head_dim), dtype)
        assert choose_implementation(q) == want

    @pytest.mark.parametrize("T,head_dim,want", [
        (65, 32, "xla"), (66, 16, "xla"),  # flagship encoder / decoder
        (66, 64, "xla"),
        (127, 32, "xla"), (128, 32, "cudnn"), (129, 64, "cudnn"),
        (128, 16, "xla"), (255, 16, "xla"), (256, 16, "cudnn"),
        (513, 64, "cudnn"), (2048, 32, "cudnn"),  # wide, long
    ])
    def test_gpu_choice_by_length(self, monkeypatch, T, head_dim, want):
        monkeypatch.setattr(attn_mod, "_on_gpu", lambda: True)
        q = jnp.zeros((1, T, 2, head_dim), jnp.bfloat16)
        assert choose_implementation(q) == want

    def test_explicit_implementation_wins(self, monkeypatch):
        """attention(..., implementation="xla") must not consult the
        platform (callers force XLA on time-sharded operands)."""
        monkeypatch.setattr(attn_mod, "_on_gpu", lambda: True)
        q, k, v = _qkv(dtype=jnp.bfloat16, D=16)
        out = attention(q, k, v, jnp.asarray([17, 3, 1], jnp.int32), True,
                        implementation="xla")
        assert out.shape == q.shape


class TestModelAttentionBlock:
    """MultiHeadSelfAttention's batched path against the cached step path
    and against a hand-written masked softmax over its own projections."""

    @pytest.mark.parametrize("causal", [False, True])
    def test_block_matches_manual(self, causal):
        from musicstyletransfer_tpu.models import layers
        from musicstyletransfer_tpu.models.transformer import (
            MultiHeadSelfAttention,
        )

        mha = MultiHeadSelfAttention(model_size=32, num_heads=4,
                                     causal=causal)
        p = mha.init(jax.random.key(0))
        B, T = 3, 11
        x = jax.random.normal(jax.random.key(1), (B, T, 32))
        lens = jnp.asarray([11, 6, 1], jnp.int32)
        mask = jnp.arange(T)[None, :] < lens[:, None]
        with jax.default_matmul_precision("highest"):
            got = mha(p, x, mask)
            q, k, v = (layers.dense(p[n], x, jnp.float32).reshape(B, T, 4, 8)
                       for n in ("w_q", "w_k", "w_v"))
            ctx = reference_attention(q, k, v, lens, causal)
            want = layers.dense(p["w_o"], ctx.reshape(B, T, 32), jnp.float32)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=2e-5)

    def test_rejects_indivisible_heads(self):
        from musicstyletransfer_tpu.models.transformer import (
            MultiHeadSelfAttention,
        )

        with pytest.raises(ValueError, match="num_heads"):
            MultiHeadSelfAttention(model_size=30, num_heads=4).init(
                jax.random.key(0))
