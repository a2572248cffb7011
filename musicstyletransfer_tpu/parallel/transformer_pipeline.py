"""Pipeline-parallel TransformerStack: the adapter between per-layer
params and pipeline.py's stacked-stage contract.

``pipeline_apply`` (parallel/pipeline.py) wants stage params stacked on a
leading stage axis and a stage_fn that maps activations to activations.
A trained ``TransformerStack`` (models/transformer.py) instead carries
``layer0..layer{N-1}`` subtrees and threads a key mask beside the hidden
state. This module bridges the two so the REAL model blocks — not an MLP
toy — run through the pipeline primitive:

- ``stack_stage_params``: groups the N per-layer subtrees into S
  contiguous stages of K = N/S layers each and stacks them, leaf-wise,
  to ``[S, K, ...]`` — stage s's slice lands on mesh position s.
- ``transformer_stage_fn``: applies the K layers of one stage with a
  ``lax.scan`` over the stacked layer axis (layers share one config, so
  the scan is shape-uniform); the key mask rides through the pipeline as
  the second tuple element and passes through each stage unchanged.
- ``pipeline_transformer_stack``: the full equivalent of
  ``TransformerStack.__call__`` (sqrt(d) input scaling + positional
  table, then the layers) pipelined over the mesh's model axis. Output
  equals the sequential stack bit-for-bit in f32 on CPU
  (tests/test_pipeline.py::TestTransformerPipeline).

The stage application is deterministic (train-time dropout is a no-op
here): the primitive exists for inference- and training-step pipelining
of deep stacks, and the grads==sequential / train-one-step pins in
tests/test_pipeline.py run with dropout 0, which is also how the wide
config trains its attention/FFN blocks under bf16 autocast with dropout
applied OUTSIDE the pipelined region if ever composed. The reference has
no counterpart (SURVEY.md §2: no distribution of any kind).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from .mesh import AXIS_MODEL
from .pipeline import pipeline_apply


def _layer_keys(stack_params: Any) -> list:
    keys = [k for k in stack_params if k.startswith("layer")]
    keys.sort(key=lambda k: int(k[len("layer"):]))
    assert keys, "no layer{i} subtrees in stack params"
    assert keys == [f"layer{i}" for i in range(len(keys))], keys
    return keys


def stack_stage_params(stack_params: Any, n_stages: int) -> Any:
    """``{layer0..layer{N-1}: tree}`` -> one tree with ``[S, K, ...]``
    leaves (S stages of K = N/S consecutive layers)."""
    keys = _layer_keys(stack_params)
    n_layers = len(keys)
    assert n_layers % n_stages == 0, (
        f"{n_layers} layers do not split into {n_stages} equal stages"
    )
    k = n_layers // n_stages
    stages = []
    for s in range(n_stages):
        group = [stack_params[keys[s * k + j]] for j in range(k)]
        stages.append(jax.tree.map(lambda *xs: jnp.stack(xs), *group))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *stages)


def transformer_stage_fn(layer_module):
    """stage_fn for pipeline_apply: params ``[K, ...]`` = K stacked
    layers, activations ``(h [mb, T, D], key_mask [mb, T])``; the mask
    passes through so downstream stages (and the hop) keep it with its
    microbatch."""

    def stage(params_k, carry):
        h, key_mask = carry

        def body(h, p_layer):
            return layer_module(p_layer, h, key_mask), None

        h, _ = jax.lax.scan(body, h, params_k)
        return h, key_mask

    return stage


def pipeline_transformer_stack(
    stack_params: Any,
    x: jax.Array,
    key_mask: jax.Array,
    *,
    config,
    causal: bool,
    mesh,
    microbatches: int,
    dtype: Any = jnp.float32,
    axis_name: str = AXIS_MODEL,
) -> jax.Array:
    """``TransformerStack.__call__`` semantics (remat/sequence-sharding
    off, deterministic) with the N layers pipelined over ``mesh``'s
    ``axis_name`` in S = mesh.shape[axis_name] stages of N/S layers.

    x: [B, T, D] embedded inputs (pre-scaling); key_mask: [B, T].
    """
    from ..models.transformer import TransformerLayer, positional_encodings

    n_stages = mesh.shape[axis_name]
    stage_params = stack_stage_params(stack_params, n_stages)
    layer = TransformerLayer(config=config, causal=causal, dtype=dtype)
    T = x.shape[1]
    pos = jnp.asarray(
        positional_encodings(config.model_size, config.max_positions)[:T],
        dtype=dtype,
    )
    scale = jnp.sqrt(jnp.asarray(config.model_size, dtype=x.dtype))
    h = scale * x + pos
    out, _ = pipeline_apply(
        transformer_stage_fn(layer),
        stage_params,
        (h, key_mask),
        mesh=mesh,
        microbatches=microbatches,
        axis_name=axis_name,
    )
    return out
