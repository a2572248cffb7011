"""Parameter-pytree building blocks: dense, embedding, layer norm, dropout,
LSTM cell.

Every layer is an ``*_params(key, ...)`` initializer returning a dict of
float32 arrays plus a pure apply function taking that dict. The dict keys
(``kernel``/``bias``, ``embedding``, ``scale``/``bias``, the LSTM cell's
``ii``..``ho``) and the initializers are the ones the model's checkpoints
were written with, so parameter trees keep their paths and distributions.

Compute-dtype convention: parameters stay float32; apply functions cast
inputs and parameters to the compute ``dtype`` before the matmul, and
layer norm takes its statistics in float32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

Params = Dict[str, Any]

_lecun_normal = jax.nn.initializers.lecun_normal()
_orthogonal = jax.nn.initializers.orthogonal()
# Embedding tables: unit-variance rows scaled by 1/sqrt(features).
_embed_init = jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal",
                                                   out_axis=0)
LN_EPSILON = 1e-6
LSTM_GATES = ("i", "f", "g", "o")


def dense_params(key: jax.Array, in_dim: int, out_dim: int,
                 use_bias: bool = True, kernel_init=_lecun_normal) -> Params:
    p = {"kernel": kernel_init(key, (in_dim, out_dim), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((out_dim,), jnp.float32)
    return p


def dense(p: Params, x: jax.Array, dtype) -> jax.Array:
    y = x.astype(dtype) @ p["kernel"].astype(dtype)
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def embed_params(key: jax.Array, num: int, features: int) -> Params:
    return {"embedding": _embed_init(key, (num, features), jnp.float32)}


def embed(p: Params, ids: jax.Array, dtype) -> jax.Array:
    return jnp.take(p["embedding"].astype(dtype), ids, axis=0)


def layer_norm_params(features: int) -> Params:
    return {"scale": jnp.ones((features,), jnp.float32),
            "bias": jnp.zeros((features,), jnp.float32)}


def layer_norm(p: Params, x: jax.Array, dtype) -> jax.Array:
    """LayerNorm over the last axis with float32 statistics
    (var = E[x^2] - E[x]^2, clipped at 0)."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    mean2 = jnp.mean(xf * xf, axis=-1, keepdims=True)
    var = jnp.maximum(0.0, mean2 - mean * mean)
    y = (xf - mean) * (jax.lax.rsqrt(var + LN_EPSILON) * p["scale"])
    return (y + p["bias"]).astype(dtype)


def dropout(x: jax.Array, rate: float, key: Optional[jax.Array]) -> jax.Array:
    """Inverted dropout; identity when ``key`` is None (inference) or the
    rate is 0."""
    if key is None or rate <= 0.0:
        return x
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))


def split_key(key: Optional[jax.Array], n: int):
    """``n`` subkeys of ``key``, or ``n`` Nones when there is no key."""
    if key is None:
        return (None,) * n
    return tuple(jax.random.split(key, n))


def lstm_cell_params(key: jax.Array, in_dim: int, hidden: int) -> Params:
    """Per-gate input kernels ``i{g}`` (no bias) and recurrent kernels
    ``h{g}`` (orthogonal init, with bias)."""
    keys = jax.random.split(key, 2 * len(LSTM_GATES))
    p = {}
    for n, g in enumerate(LSTM_GATES):
        p[f"i{g}"] = dense_params(keys[2 * n], in_dim, hidden, use_bias=False)
        p[f"h{g}"] = dense_params(keys[2 * n + 1], hidden, hidden,
                                  kernel_init=_orthogonal)
    return p


def lstm_cell(p: Params, carry: Tuple[jax.Array, jax.Array], x: jax.Array,
              dtype) -> Tuple[Tuple[jax.Array, jax.Array], jax.Array]:
    """One LSTM step; ``carry`` is (c, h). The four gates run as one
    concatenated matmul for the input and one for the recurrence."""
    c, h = carry
    k_h = jnp.concatenate([p[f"h{g}"]["kernel"] for g in LSTM_GATES], -1)
    b_h = jnp.concatenate([p[f"h{g}"]["bias"] for g in LSTM_GATES], -1)
    k_i = jnp.concatenate([p[f"i{g}"]["kernel"] for g in LSTM_GATES], -1)
    y = (h.astype(dtype) @ k_h.astype(dtype) + b_h.astype(dtype)
         + x.astype(dtype) @ k_i.astype(dtype))
    i, f, g, o = jnp.split(y, 4, axis=-1)
    i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
    new_c = f * c + i * jnp.tanh(g)
    new_h = o * jnp.tanh(new_c)
    return (new_c, new_h), new_h


def lstm_scan(p: Params, carry, xs: jax.Array, dtype):
    """Run the cell over the time axis of ``xs`` [B, T, F] with
    ``lax.scan``; returns (final carry, outputs [B, T, H])."""
    def step(c, x_t):
        return lstm_cell(p, c, x_t, dtype)

    carry, ys = jax.lax.scan(step, carry, jnp.swapaxes(xs, 0, 1))
    return carry, jnp.swapaxes(ys, 0, 1)
