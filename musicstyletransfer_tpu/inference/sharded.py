"""Mesh-sharded batched inference: style transfer over a device mesh.

The reference serves from a single ``mx.Context`` (sampler.py:273-292); its
only scaling story is a bigger host loop. Here the same single-program
decode loop (inference/decode.py) is compiled by GSPMD over a
``jax.sharding.Mesh``:

- the request batch is sharded over the mesh's "data" axis (each device
  decodes its slice of the batch; rows are independent, so data-parallel
  decode is exact — no collectives in the hot loop);
- parameters follow the training-time tensor-parallel rules
  (parallel/mesh.py): replicated under pure DP, Megatron-style
  column/row-split under tp>1, in which case XLA inserts one psum per
  attention/FFN block.

Batches are padded to a multiple of the data-axis size with copies of
row 0 (static shapes; padding rows are dropped from the result).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..parallel.mesh import (
    AXIS_DATA,
    batch_sharding,
    shard_params,
    use_mesh,
)
from .decode import sample_sequences


def _pad_rows(arr: jax.Array, target: int) -> jax.Array:
    """Pad the leading axis to ``target`` rows by repeating row 0."""
    extra = target - arr.shape[0]
    if extra == 0:
        return arr
    fill = jnp.broadcast_to(arr[:1], (extra,) + arr.shape[1:])
    return jnp.concatenate([arr, fill], axis=0)


def prepare_params(params, mesh) -> any:
    """Place a parameter pytree onto the mesh once (TP rules + replication).

    Call this at service start; passing the result to the functions below
    avoids a re-placement per request.
    """
    return shard_params(params, mesh)


def sharded_sample_sequences(
    model,
    params,
    tokens: jax.Array,
    seq_lens: jax.Array,
    classes: jax.Array,
    max_len: int,
    rng: jax.Array,
    mesh,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    greedy: bool = False,
    params_on_mesh: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Encode + ancestral decode with the batch sharded over the data axis.

    Same contract as decode.sample_sequences. Rows are independent, so the
    data-parallel result is identical to the single-device one; under tp>1
    the attention/FFN reductions are split across the model axis (same math,
    partitioned reduction order).
    """
    B = tokens.shape[0]
    dp = mesh.shape[AXIS_DATA]
    padded = -(-B // dp) * dp
    tokens = _pad_rows(tokens, padded)
    seq_lens = _pad_rows(seq_lens, padded)
    classes = _pad_rows(classes, padded)
    if not params_on_mesh:
        params = shard_params(params, mesh)
    bs = batch_sharding(mesh)
    tokens, seq_lens, classes = (
        jax.device_put(tokens, bs),
        jax.device_put(seq_lens, bs),
        jax.device_put(classes, bs),
    )
    with use_mesh(mesh):
        seqs, scores = sample_sequences(
            model, params, tokens, seq_lens, classes, max_len, rng,
            temperature, top_k=top_k, top_p=top_p, greedy=greedy,
        )
    return seqs[:B], scores[:B]


def sharded_style_transfer_all_classes(
    model,
    params,
    tokens: jax.Array,
    seq_lens: jax.Array,
    max_len: int,
    num_classes: int,
    rng: jax.Array,
    mesh,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    params_on_mesh: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Mesh-sharded variant of decode.style_transfer_all_classes: transfer a
    batch into every target class, C*B sequences sharded over the data axis.

    Returns (seqs [C, B, max_len], scores [C, B]).
    """
    B = tokens.shape[0]
    C = num_classes
    tokens_rep = jnp.tile(tokens, (C, 1))
    seq_lens_rep = jnp.tile(seq_lens, (C,))
    classes_rep = jnp.repeat(jnp.arange(C, dtype=jnp.int32), B)
    seqs, scores = sharded_sample_sequences(
        model, params, tokens_rep, seq_lens_rep, classes_rep, max_len, rng,
        mesh, temperature, top_k=top_k, top_p=top_p,
        params_on_mesh=params_on_mesh,
    )
    return seqs.reshape(C, B, max_len), scores.reshape(C, B)
