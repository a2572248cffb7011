"""Pipeline parallelism (GPipe-style) over a mesh axis.

The reference has no distribution of any kind (SURVEY.md §2: single
mx.Context). This framework's mesh covers data, tensor and sequence
parallelism (mesh.py, ops/ring_attention.py); this module completes the
sharding matrix with a PIPELINE primitive: a stack of identical stages is
sharded one-stage-per-device over a mesh axis, and microbatches stream
through the stages with activations hopping device-to-device via
``ppermute`` — the JAX equivalent of NCCL send/recv stage wiring,
expressed as one jitted SPMD program.

Schedule: plain GPipe. M microbatches over S stages take M + S - 1 ticks;
each tick every device applies its stage (devices in the bubble compute on
garbage and their result is masked out), then activations rotate one hop.
Reverse-mode autodiff works through the scan + ppermute (ppermute's
transpose is the reverse rotation), so the same primitive trains — the
backward pass is the mirrored pipeline, as in GPipe.

Scope note: the VAE this framework ships is 1-4 layers deep — pipelining
it is pointless (the bubble dominates), so the trainer does not use this
path; it exists as the framework-level primitive, correctness-pinned by
tests/test_pipeline.py (forward == sequential, grads == sequential) and
compile-validated by the driver's multichip dryrun.

Activations are PYTREES: ``x`` (and therefore what hops between stages)
may be any pytree of arrays sharing a leading batch axis, so side inputs
that must travel with their microbatch — the attention key mask, ragged
seq_lens — ride along as tuple elements that ``stage_fn`` passes through
unchanged. ``transformer_pipeline.py`` builds on exactly that to carry
real TransformerLayer stacks (stage = K layers) through this primitive.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .mesh import AXIS_MODEL

from .mesh import unchecked_shard_map as _unchecked_shard_map

_shard_map = _unchecked_shard_map()


def _pipeline_body(
    stage_params: Any,
    x_mb: jax.Array,
    *,
    stage_fn: Callable[[Any, jax.Array], jax.Array],
    axis_name: str,
    n_stages: int,
):
    """Inside shard_map: stage_params is THIS device's stage (leading axis
    stripped to 1), x_mb is the full [M, mb, ...] microbatch stream
    (replicated). Returns [M, mb, ...] outputs of the last stage
    (valid on every device after the final broadcast hop)."""
    idx = jax.lax.axis_index(axis_name)
    params_local = jax.tree.map(lambda p: p[0], stage_params)
    M = jax.tree.leaves(x_mb)[0].shape[0]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def tick(carry, t):
        acts, outputs = carry
        # Stage 0 ingests microbatch t (while it exists); others take the
        # activation that just hopped in. Activations are pytrees; every
        # per-leaf op below is treemapped.
        mb_in = jax.tree.map(
            lambda leaf: jax.lax.dynamic_index_in_dim(
                leaf, jnp.minimum(t, M - 1), keepdims=False
            ),
            x_mb,
        )
        h_in = jax.tree.map(
            lambda m, a: jnp.where(idx == 0, m, a), mb_in, acts
        )
        h_out = stage_fn(params_local, h_in)
        # The LAST stage's result for microbatch t - (S-1) is ready when
        # 0 <= t - S + 1 < M; collect it (masked elsewhere / in the bubble).
        out_slot = t - (n_stages - 1)
        valid = (out_slot >= 0) & (out_slot < M)
        slot = jnp.clip(out_slot, 0, M - 1)

        def collect(outs, h):
            return jax.lax.dynamic_update_index_in_dim(
                outs,
                jnp.where(
                    valid & (idx == n_stages - 1),
                    h,
                    jax.lax.dynamic_index_in_dim(outs, slot, keepdims=False),
                ),
                slot,
                axis=0,
            )

        outputs = jax.tree.map(collect, outputs, h_out)
        # Hop activations one stage forward.
        acts = jax.tree.map(
            lambda h: jax.lax.ppermute(h, axis_name, perm), h_out
        )
        return (acts, outputs), None

    acts0 = jax.tree.map(lambda leaf: jnp.zeros_like(leaf[0]), x_mb)
    outputs0 = jax.tree.map(jnp.zeros_like, x_mb)
    (_, outputs), _ = jax.lax.scan(
        tick, (acts0, outputs0), jnp.arange(M + n_stages - 1)
    )
    # Only the last device holds real outputs; broadcast them to all so the
    # result is replicated over the pipe axis (psum of one-hot-masked data).
    return jax.tree.map(
        lambda o: jax.lax.psum(
            o * (idx == n_stages - 1).astype(o.dtype), axis_name
        ),
        outputs,
    )


def pipeline_apply(
    stage_fn: Callable[[Any, jax.Array], jax.Array],
    stage_params: Any,
    x: jax.Array,
    *,
    mesh,
    microbatches: int,
    axis_name: str = AXIS_MODEL,
) -> jax.Array:
    """Run ``x`` through ``n_stages`` chained stages, pipelined over
    ``mesh``'s ``axis_name``.

    stage_fn(params_i, h) -> h' applies ONE stage; it must preserve the
    activation pytree structure and shapes (stages are chained), and must
    be total — bubble ticks evaluate it on zero-filled garbage whose
    result is masked out, so it may not produce NaN/inf on arbitrary
    finite inputs. stage_params is a pytree whose leaves are stacked on a
    leading stage axis of size mesh.shape[axis_name] (stage i's slice
    lands on mesh position i). x: a pytree of [B, ...] arrays (a bare
    array included) sharing the leading batch axis, B % microbatches == 0;
    non-activation data that must travel with its microbatch (key masks,
    seq_lens) rides along as extra tuple elements stage_fn passes through.
    Returns stage_{S-1}(...stage_0(x)) with x's structure, replicated.
    """
    n_stages = mesh.shape[axis_name]
    x_leaves = jax.tree.leaves(x)
    assert x_leaves, "x has no array leaves"
    B = x_leaves[0].shape[0]
    for leaf in x_leaves:
        assert leaf.shape[0] == B, (leaf.shape, B)
    assert B % microbatches == 0, (B, microbatches)
    for leaf in jax.tree.leaves(stage_params):
        assert leaf.shape[0] == n_stages, (
            f"stage_params leading axis {leaf.shape[0]} != pipe axis "
            f"{n_stages}"
        )
    mb = B // microbatches
    x_mb = jax.tree.map(
        lambda leaf: leaf.reshape(microbatches, mb, *leaf.shape[1:]), x
    )

    body = functools.partial(
        _pipeline_body,
        stage_fn=stage_fn,
        axis_name=axis_name,
        n_stages=n_stages,
    )
    param_specs = jax.tree.map(lambda _: P(axis_name), stage_params)
    out = _shard_map(
        body,
        mesh=mesh,
        in_specs=(param_specs, jax.tree.map(lambda _: P(), x_mb)),
        out_specs=jax.tree.map(lambda _: P(), x_mb),
    )(stage_params, x_mb)
    return jax.tree.map(
        lambda leaf: leaf.reshape(leaf.shape[0] * leaf.shape[1],
                                  *leaf.shape[2:]),
        out,
    )
