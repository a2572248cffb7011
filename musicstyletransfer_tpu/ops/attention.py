"""Multi-head attention over prefix-masked keys, and its float32 reference.

One function serves every batched attention in the model (encoder, decoder,
short and long sequences): ``jax.nn.dot_product_attention`` with
``key_value_seq_lengths`` for the PAD suffix and ``is_causal`` for the
decoder. On a GPU with half-precision operands and sequences of at least
cudnn_min_seq_len(head_dim) it runs cuDNN's fused flash attention (no
[T, T] score tensor in device memory, fused softmax, a fused backward);
for shorter sequences, and everywhere else, it runs XLA's lowering.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

_CUDNN_DTYPES = (jnp.bfloat16, jnp.float16)
_CUDNN_MAX_HEAD_DIM = 256
_NEG_INF = -1e30


def cudnn_min_seq_len(head_dim: int) -> int:
    """Shortest query length from which cuDNN's forward+backward beats
    XLA's at this head dim. Two sweeps of scripts/attention-crossover.py
    (bf16, 8 heads, ~16k tokens per call; an H100 at a 400 W power limit):
    at T=65/66 XLA leads 1.05-1.5x at head dims 16 and 32 and the two are
    within 15% of each other at 64 (kept on XLA); at T=129/130 cuDNN
    leads 1.10-1.83x for head dims 32 and 64 and ties for 16; at
    T=257/258 it leads 1.6-2.8x for all three, and more beyond."""
    return 128 if head_dim >= 32 else 256


def _on_gpu() -> bool:
    device = jax.config.jax_default_device
    if device is not None and not isinstance(device, str):
        return device.platform == "gpu"
    return jax.default_backend() == "gpu"


def choose_implementation(q: jax.Array) -> str:
    """cuDNN where it can run this shape and dtype and is the faster of the
    two (see cudnn_min_seq_len), else XLA."""
    head_dim = q.shape[-1]
    if (_on_gpu() and q.dtype in _CUDNN_DTYPES and head_dim % 8 == 0
            and head_dim <= _CUDNN_MAX_HEAD_DIM
            and q.shape[1] >= cudnn_min_seq_len(head_dim)):
        return "cudnn"
    return "xla"


def attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    key_lens: jax.Array,
    causal: bool,
    implementation: Optional[str] = None,
) -> jax.Array:
    """q, k, v: [B, T, H, hd]; key_lens: [B] valid keys per row (keys are a
    prefix, the PAD suffix is masked). Returns [B, T, H, hd] in q's dtype.

    ``implementation`` None picks by platform, dtype and head size
    (choose_implementation); "xla" forces XLA's lowering, which callers
    need where the operands are sharded along time (cuDNN's partitioner
    refuses that layout)."""
    impl = implementation or choose_implementation(q)
    if impl == "cudnn" and q.shape[1] % 2:
        return attend_even_length(q, k, v, key_lens, causal, impl)
    return _dot_product_attention(q, k, v, key_lens, causal, impl)


def attend_even_length(q, k, v, key_lens, causal, implementation):
    """Attention over a time axis padded by one position to an even
    length, with the pad sliced off again. cuDNN's training path refuses
    odd sequence lengths (the encoder sees L+1); the padded key lies
    beyond every ``key_lens`` and the padded query row is dropped, so the
    result is exact."""
    T = q.shape[1]
    pad = [(0, 0), (0, 1), (0, 0), (0, 0)]
    q, k, v = (jnp.pad(x, pad) for x in (q, k, v))
    out = _dot_product_attention(q, k, v, key_lens, causal, implementation)
    return out[:, :T]


def _dot_product_attention(q, k, v, key_lens, causal, implementation):
    return jax.nn.dot_product_attention(
        q, k, v,
        key_value_seq_lengths=key_lens.astype(jnp.int32),
        is_causal=causal,
        implementation=implementation,
    )


def reference_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    key_lens: jax.Array,
    causal: bool,
) -> jax.Array:
    """Plain float32 masked softmax attention at "highest" matmul precision
    (same layout and masking contract as ``attention``)."""
    T, S = q.shape[1], k.shape[1]
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    hp = jax.lax.Precision.HIGHEST
    s = jnp.einsum("bqhd,bkhd->bhqk", qf, kf, precision=hp)
    s = s / jnp.sqrt(jnp.float32(q.shape[-1]))
    mask = jnp.arange(S)[None, None, None, :] < key_lens[:, None, None, None]
    if causal:
        mask = mask & (jnp.arange(S)[None, :] <= jnp.arange(T)[:, None])
    s = jnp.where(mask, s, _NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p, vf, precision=hp)
