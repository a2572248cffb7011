"""Transformer encoder/decoder stacks as parameter pytrees plus functions.

Reference: VarAutoEncoder/transformer.py:24-273. Behavioral divergences,
chosen per SURVEY.md §7 (implement the evident intent, document the delta):

- attention softmax is over the *key* axis with a real padding mask
  (the reference normalizes over queries, making its pad mask a no-op —
  SURVEY.md §8.4);
- the decoder applies a causal mask in training (the reference trains
  non-causally while sampling autoregressively — SURVEY.md §8.5);
- the decoder-layer FFN residual is ``x + dropout(ff(x))`` (the reference
  drops the residual input at transformer.py:200);
- no debug prints in the hot path (reference transformer.py:95,97).

Kept from the reference: post-LN residual blocks, 4x ReLU feed-forward
("DualFeedForward", transformer.py:24-46), sqrt(d) input scaling + additive
sinusoidal positional table built with the reference's exponent formula
(transformer.py:204-211), per-layer KV caching for incremental decoding
(transformer.py:242-249) — here as explicit static-shape cache arrays
updated via ``lax.dynamic_update_slice`` so the whole decode loop stays
on-device inside one jitted ``lax.while_loop``.

Each module is a frozen dataclass of static settings (hashable, so a model
can be a static jit argument) with an ``init(key)`` that builds its
parameter dict and apply methods that take that dict first. Dropout is
active exactly when a PRNG key is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import layers
from .config import TransformerConfig

# Per-layer KV cache: (k, v) each [batch, max_len, num_heads, head_dim].
LayerCache = Tuple[jax.Array, jax.Array]
Cache = Tuple[LayerCache, ...]

_NEG_INF = -1e9


def positional_encodings(model_size: int, max_len: int) -> np.ndarray:
    """Sinusoidal table with the reference's exponent layout
    (reference: transformer.py:204-211)."""
    pos = np.arange(max_len).reshape(-1, 1) / np.power(
        10000, (2.0 / model_size) * np.arange(model_size).reshape(1, -1)
    )
    pos[:, 0::2] = np.sin(pos[:, 0::2])
    pos[:, 1::2] = np.cos(pos[:, 1::2])
    return pos.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FeedForward:
    """4x-expansion ReLU FFN (reference DualFeedForward, transformer.py:24-46)."""

    model_size: int
    hidden_size: int
    dropout: float
    dtype: Any = jnp.float32

    def init(self, key: jax.Array) -> layers.Params:
        k1, k2 = jax.random.split(key)
        return {
            "ff1": layers.dense_params(k1, self.model_size, self.hidden_size),
            "ff2": layers.dense_params(k2, self.hidden_size, self.model_size),
        }

    def __call__(self, p, x: jax.Array,
                 rng: Optional[jax.Array] = None) -> jax.Array:
        x = jax.nn.relu(layers.dense(p["ff1"], x, self.dtype))
        x = layers.dropout(x, self.dropout, rng)
        return layers.dense(p["ff2"], x, self.dtype)


@dataclasses.dataclass(frozen=True)
class MultiHeadSelfAttention:
    """Scaled-dot self-attention with a batched train path and cached
    single-position step paths (reference: transformer.py:49-126).

    The batched path runs ops/attention.py (cuDNN fused attention on a GPU
    in half precision). Keys must be prefix-masked (PAD is always a
    suffix in this pipeline). Parameters: ``w_q``, ``w_k``, ``w_v``,
    ``w_o``, each a dense ``{kernel [D, D], bias [D]}``.
    """

    model_size: int
    num_heads: int
    causal: bool = False
    use_ring: bool = False
    sequence_sharding: bool = False
    dtype: Any = jnp.float32

    @property
    def head_dim(self) -> int:
        return self.model_size // self.num_heads

    def init(self, key: jax.Array) -> layers.Params:
        if self.model_size % self.num_heads:
            raise ValueError(f"model_size {self.model_size} is not a "
                             f"multiple of num_heads {self.num_heads}")
        D = self.model_size
        keys = jax.random.split(key, 4)
        return {name: layers.dense_params(k, D, D)
                for name, k in zip(("w_q", "w_k", "w_v", "w_o"), keys)}

    def _heads(self, x: jax.Array) -> jax.Array:
        return x.reshape(*x.shape[:-1], self.num_heads, self.head_dim)

    @staticmethod
    def _model_axis() -> int:
        from ..parallel.mesh import AXIS_MODEL, current_mesh

        mesh = current_mesh()
        return 1 if mesh is None else mesh.shape.get(AXIS_MODEL, 1)

    def _qkv(self, p, x: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Q/K/V projection. Single-device / dp meshes run ONE ``[D, 3D]``
        dot (three same-activation ``[D, D]`` dots triple the matmul
        launches fwd AND bwd — dX and dW each collapse to one dot too);
        tp>1 meshes keep three dots: the Q/K/V kernels are column-sharded
        ``(None, "model")`` there, and an apply-time concat of three
        column-sharded arrays would make GSPMD reshard them every step."""
        dt = self.dtype
        names = ("w_q", "w_k", "w_v")
        if self._model_axis() <= 1:
            w = jnp.concatenate([p[n]["kernel"].astype(dt) for n in names],
                                axis=1)
            b = jnp.concatenate([p[n]["bias"].astype(dt) for n in names])
            q, k, v = jnp.split(x.astype(dt) @ w + b, 3, axis=-1)
            return q, k, v
        q, k, v = (layers.dense(p[n], x, dt) for n in names)
        return q, k, v

    def _ring_eligible(self, x: jax.Array) -> bool:
        """Ring attention engages on a live mesh with a >1 "model" axis and
        a batch the data axis divides; the time axis need not divide the
        ring (ring_attention_sharded pads it — the encoder's L+1 and
        decoder's L+2 are consecutive, so no ring could serve both
        otherwise)."""
        if not self.use_ring:
            return False
        from ..parallel.mesh import AXIS_DATA, current_mesh

        mesh = current_mesh()
        return (
            self._model_axis() > 1
            and x.shape[0] % mesh.shape.get(AXIS_DATA, 1) == 0
        )

    def __call__(self, p, x: jax.Array, key_mask: jax.Array) -> jax.Array:
        """x: [B, T, D]; key_mask: [B, T] True at valid (non-PAD) keys."""
        from ..ops.attention import attention

        q, k, v = (self._heads(a) for a in self._qkv(p, x))
        key_lens = jnp.sum(key_mask.astype(jnp.int32), axis=-1)
        if self._ring_eligible(x):
            from ..ops.ring_attention import ring_attention_sharded

            out = ring_attention_sharded(
                q.transpose(0, 2, 1, 3),
                k.transpose(0, 2, 1, 3),
                v.transpose(0, 2, 1, 3),
                key_lens,
                causal=self.causal,
            ).transpose(0, 2, 1, 3)
        else:
            # Time-sharded activations (sequence parallelism on a model
            # axis) must take XLA's lowering: cuDNN's partitioner refuses
            # a sharded sequence dimension.
            seq_sharded = self.sequence_sharding and self._model_axis() > 1
            out = attention(q, k, v, key_lens, self.causal,
                            implementation="xla" if seq_sharded else None)
        out = out.reshape(*x.shape[:-1], self.model_size)
        return layers.dense(p["w_o"], out, self.dtype)

    def _cached_attend(self, p, q_t, cache_k, cache_v, valid):
        """q_t: [S, H, hd]; valid: [S or 1, T] visible cache positions."""
        logits = jnp.einsum("bhd,bkhd->bhk", q_t, cache_k) / jnp.sqrt(
            jnp.asarray(self.head_dim, dtype=q_t.dtype)
        )
        logits = jnp.where(valid[:, None, :], logits, _NEG_INF)
        probs = jax.nn.softmax(logits, axis=-1)
        out = jnp.einsum("bhk,bkhd->bhd", probs, cache_v)
        return layers.dense(p["w_o"], out.reshape(q_t.shape[0],
                                                  self.model_size),
                            self.dtype)

    def step_ragged(
        self, p, x_t: jax.Array, cache_k: jax.Array, cache_v: jax.Array,
        t: jax.Array,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Per-row cached decode step: row ``s`` sits at its own position
        ``t[s]`` (the continuous-batching engine's slots advance
        independently — inference/streaming.py).

        x_t: [S, D]; t: [S] int32; cache_{k,v}: [S, T_max, H, hd]. Writes
        (k, v) at ``[s, t[s]]`` and attends over keys ``<= t[s]`` per row.
        The write is a vectorized one-hot select over the time axis rather
        than a per-row scatter. Numerically identical to ``step`` when
        every row shares t: stale cache positions beyond t[s] are masked
        before the softmax, so their (arbitrary) contents multiply exact
        zeros.
        """
        T = cache_k.shape[1]
        q_t, k_t, v_t = self._qkv(p, x_t)
        k_t = self._heads(k_t)[:, None]  # [S, 1, H, hd]
        v_t = self._heads(v_t)[:, None]
        positions = jnp.arange(T)
        write = (positions[None, :] == t[:, None])[:, :, None, None]
        cache_k = jnp.where(write, k_t.astype(cache_k.dtype), cache_k)
        cache_v = jnp.where(write, v_t.astype(cache_v.dtype), cache_v)
        valid = positions[None, :] <= t[:, None]  # [S, T]
        out = self._cached_attend(p, self._heads(q_t), cache_k, cache_v,
                                  valid)
        return out, cache_k, cache_v

    def step(
        self, p, x_t: jax.Array, cache_k: jax.Array, cache_v: jax.Array,
        t: jax.Array,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """One cached decode step.

        x_t: [B, D] input at position ``t``; cache_{k,v}: [B, T_max, H, hd].
        Returns (out [B, D], new_cache_k, new_cache_v).
        """
        q_t, k_t, v_t = self._qkv(p, x_t)
        k_t = self._heads(k_t)[:, None]  # [B, 1, H, hd]
        v_t = self._heads(v_t)[:, None]
        cache_k = jax.lax.dynamic_update_slice(
            cache_k, k_t.astype(cache_k.dtype), (0, t, 0, 0)
        )
        cache_v = jax.lax.dynamic_update_slice(
            cache_v, v_t.astype(cache_v.dtype), (0, t, 0, 0)
        )
        # Mask positions beyond t (cache slots not yet written).
        valid = (jnp.arange(cache_k.shape[1]) <= t)[None, :]
        out = self._cached_attend(p, self._heads(q_t), cache_k, cache_v,
                                  valid)
        return out, cache_k, cache_v


@dataclasses.dataclass(frozen=True)
class TransformerLayer:
    """Residual block: self-attention + FFN, post-LN (reference encoder
    layer transformer.py:129-159; decoder layer transformer.py:162-200
    with its residual bug fixed) or pre-LN (config.norm_scheme)."""

    config: TransformerConfig
    causal: bool = False
    dtype: Any = jnp.float32

    @property
    def attention(self) -> MultiHeadSelfAttention:
        c = self.config
        return MultiHeadSelfAttention(
            model_size=c.model_size,
            num_heads=c.num_heads,
            causal=self.causal,
            use_ring=c.ring_attention,
            sequence_sharding=c.sequence_sharding,
            dtype=self.dtype,
        )

    @property
    def ff(self) -> FeedForward:
        c = self.config
        return FeedForward(
            model_size=c.model_size,
            hidden_size=c.model_size * c.ffn_multiplier,
            dropout=c.dropout,
            dtype=self.dtype,
        )

    @property
    def _pre_ln(self) -> bool:
        return self.config.norm_scheme == "pre"

    def init(self, key: jax.Array) -> layers.Params:
        k_att, k_ff = jax.random.split(key)
        D = self.config.model_size
        return {
            "attention": self.attention.init(k_att),
            "ln1": layers.layer_norm_params(D),
            "ff": self.ff.init(k_ff),
            "ln2": layers.layer_norm_params(D),
        }

    def __call__(self, p, x: jax.Array, key_mask: jax.Array,
                 rng: Optional[jax.Array] = None) -> jax.Array:
        dt, rate = self.dtype, self.config.dropout
        r_att, r_ff, r_res = layers.split_key(rng, 3)

        def ln(name, h):
            return layers.layer_norm(p[name], h, dt)

        if self._pre_ln:
            att = self.attention(p["attention"], ln("ln1", x), key_mask)
            x = x + layers.dropout(att, rate, r_att)
            ff = self.ff(p["ff"], ln("ln2", x), r_ff)
            return x + layers.dropout(ff, rate, r_res)
        att = self.attention(p["attention"], x, key_mask)
        x = ln("ln1", x + layers.dropout(att, rate, r_att))
        ff = self.ff(p["ff"], x, r_ff)
        return ln("ln2", x + layers.dropout(ff, rate, r_res))

    def _step_with(self, attend, p, x_t, cache, t):
        dt = self.dtype
        if self._pre_ln:
            att, ck, cv = attend(p["attention"],
                                 layers.layer_norm(p["ln1"], x_t, dt),
                                 cache[0], cache[1], t)
            x_t = x_t + att
            ff = self.ff(p["ff"], layers.layer_norm(p["ln2"], x_t, dt))
            return x_t + ff, (ck, cv)
        att, ck, cv = attend(p["attention"], x_t, cache[0], cache[1], t)
        x_t = layers.layer_norm(p["ln1"], x_t + att, dt)
        x_t = layers.layer_norm(p["ln2"], x_t + self.ff(p["ff"], x_t), dt)
        return x_t, (ck, cv)

    def step(self, p, x_t: jax.Array, cache: LayerCache,
             t: jax.Array) -> Tuple[jax.Array, LayerCache]:
        return self._step_with(self.attention.step, p, x_t, cache, t)

    def step_ragged(self, p, x_t: jax.Array, cache: LayerCache,
                    t: jax.Array) -> Tuple[jax.Array, LayerCache]:
        return self._step_with(self.attention.step_ragged, p, x_t, cache, t)


@dataclasses.dataclass(frozen=True)
class TransformerStack:
    """Shared encoder/decoder stack: sqrt(d)*x + positional table, N layers
    ``layer{i}``, and under pre-LN one ``final_ln`` (reference:
    transformer.py:214-273)."""

    config: TransformerConfig
    causal: bool
    dtype: Any = jnp.float32

    @property
    def layer(self) -> TransformerLayer:
        return TransformerLayer(config=self.config, causal=self.causal,
                                dtype=self.dtype)

    @property
    def _pre_ln(self) -> bool:
        # Pre-LN stacks end with one final LayerNorm (the per-block LNs
        # move inside the residual branches; without this the stack's
        # output scale grows with depth).
        return self.config.norm_scheme == "pre"

    def init(self, key: jax.Array) -> layers.Params:
        c = self.config
        keys = jax.random.split(key, c.num_layers)
        p = {f"layer{i}": self.layer.init(keys[i])
             for i in range(c.num_layers)}
        if self._pre_ln:
            p["final_ln"] = layers.layer_norm_params(c.model_size)
        return p

    def _pos_table(self) -> jax.Array:
        c = self.config
        return jnp.asarray(positional_encodings(c.model_size, c.max_positions),
                           dtype=self.dtype)

    def _scale(self, x: jax.Array) -> jax.Array:
        return jnp.sqrt(jnp.asarray(self.config.model_size, dtype=x.dtype)) * x

    def _seq_shard(self, x: jax.Array) -> jax.Array:
        """Sequence-parallel activation constraint (config.sequence_sharding):
        shard [B, T, D] as ("data", "model", None) so LN/FFN/dropout regions
        compute on T/tp slices; GSPMD all-gathers around attention."""
        if not self.config.sequence_sharding:
            return x
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import AXIS_DATA, AXIS_MODEL, current_mesh

        mesh = current_mesh()
        if mesh is None or AXIS_MODEL not in mesh.shape:
            return x
        if x.shape[1] % mesh.shape[AXIS_MODEL] != 0:
            return x  # time axis must divide the model axis
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(AXIS_DATA, AXIS_MODEL, None))
        )

    def __call__(self, p, x: jax.Array, key_mask: jax.Array,
                 rng: Optional[jax.Array] = None) -> jax.Array:
        """x: [B, T, D]; key_mask: [B, T] 1 for valid positions. Dropout
        runs when ``rng`` is given; config.remat then recomputes each
        layer in the backward pass instead of saving its activations."""
        c = self.config
        layer_fn = self.layer.__call__
        if c.remat and rng is not None:
            layer_fn = jax.checkpoint(layer_fn)
        x = self._scale(x) + self._pos_table()[: x.shape[1]]
        x = self._seq_shard(x)
        keys = layers.split_key(rng, c.num_layers)
        for i in range(c.num_layers):
            x = self._seq_shard(layer_fn(p[f"layer{i}"], x, key_mask,
                                         keys[i]))
        if self._pre_ln:
            x = layers.layer_norm(p["final_ln"], x, self.dtype)
        return x

    def _step_layers(self, p, x_t, cache, t, ragged: bool):
        layer = self.layer
        step = layer.step_ragged if ragged else layer.step
        new_cache = []
        for i, layer_cache in enumerate(cache):
            x_t, layer_cache = step(p[f"layer{i}"], x_t, layer_cache, t)
            new_cache.append(layer_cache)
        if self._pre_ln:
            x_t = layers.layer_norm(p["final_ln"], x_t, self.dtype)
        return x_t, tuple(new_cache)

    def step(self, p, x_t: jax.Array, cache: Cache,
             t: jax.Array) -> Tuple[jax.Array, Cache]:
        """One incremental decode position. x_t: [B, D] (pre-scaling)."""
        pos = jax.lax.dynamic_slice_in_dim(self._pos_table(), t, 1, axis=0)[0]
        x_t = self._scale(x_t) + pos.astype(x_t.dtype)
        return self._step_layers(p, x_t, cache, t, ragged=False)

    def step_ragged(self, p, x_t: jax.Array, cache: Cache,
                    t: jax.Array) -> Tuple[jax.Array, Cache]:
        """Per-row-position decode step. x_t: [S, D]; t: [S] int32."""
        pos = jnp.take(self._pos_table(), t, axis=0)  # [S, D]
        x_t = self._scale(x_t) + pos.astype(x_t.dtype)
        return self._step_layers(p, x_t, cache, t, ragged=True)

    def init_cache(
        self, batch_size: int, max_len: int, dtype: Optional[Any] = None
    ) -> Cache:
        c = self.config
        shape = (batch_size, max_len, c.num_heads, c.model_size // c.num_heads)
        dt = dtype or self.dtype
        return tuple(
            (jnp.zeros(shape, dt), jnp.zeros(shape, dt))
            for _ in range(c.num_layers)
        )
