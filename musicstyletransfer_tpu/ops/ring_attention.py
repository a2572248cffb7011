"""Ring attention: exact sequence-parallel attention over a mesh axis.

The reference has no distribution and its longest-sequence answer is
chunking melodies to ``--max-seq-len`` at tensorization time
(reference: data.py:139-155; SURVEY.md §5.7). On one device the fused
attention of ops/attention.py handles long sequences; THIS module is the
multi-device continuation: shard the TIME axis over the mesh's "model"
axis and rotate K/V chunks around the devices with ``ppermute`` so no
device ever holds the full K/V in the forward pass.

Mechanics (per ``shard_map``-mapped device holding a [B, H, T/n, D] chunk):

- step 0 is ALWAYS the diagonal chunk (the K/V a device starts with is its
  own), so causality there is an ordinary causal mask — no per-step
  branching on ring position is ever needed;
- steps 1..n-1 receive a strictly off-diagonal chunk which is either fully
  visible (source chunk index < local index) or fully hidden (> local):
  both cases are expressed through the per-chunk visible key count;
- each visit's block attention is plain jnp in float32 and returns its
  logsumexp; partials merge by exact logsumexp reweighting
  (``out = sum_i out_i * exp(lse_i - LSE)``).

The backward pass is JAX's own differentiation of this forward, through
``ppermute`` (whose transpose is the reverse rotation). Reverse mode keeps
the rotated K/V chunks of every visit as residuals, so gradient memory is
one full K/V copy per device; pinned against jax.grad of plain attention
in tests/test_ring_attention.py.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..parallel.mesh import AXIS_DATA, AXIS_MODEL, current_mesh
from ..parallel.mesh import unchecked_shard_map as _unchecked_shard_map

_shard_map = _unchecked_shard_map()
_NEG_INF = -1e30


def _merge(out1, lse1, out2, lse2):
    """Exact combination of two normalized softmax partials, f32.

    out_i: [B, H, Tl, D] (already normalized per chunk), lse_i: [B, H, Tl].
    """
    lse = jnp.logaddexp(lse1, lse2)
    w1 = jnp.exp(lse1 - lse)[..., None]
    w2 = jnp.exp(lse2 - lse)[..., None]
    return out1 * w1 + out2 * w2, lse


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def _chunk_vis(key_lens, src, idx, Tl, causal):
    """Visible key count of chunk ``src`` for this device's queries: the
    global prefix ``key_lens`` clipped to the chunk, zeroed (causal) for
    chunks strictly after the local one (the diagonal applies its own
    causal mask, never through this path)."""
    vis = jnp.clip(key_lens - src * Tl, 0, Tl)
    if causal:
        vis = jnp.where(src < idx, vis, 0)
    return vis


def block_attention(q, k, v, key_lens, causal, sm_scale):
    """One visit: q [B, H, Tq, D] against a K/V chunk [B, H, Tk, D] whose
    first ``key_lens`` [B] keys are visible. Returns (out f32, lse f32).
    A row with no visible key gets a finite lse near -1e30, so the merge
    gives it zero weight."""
    hp = jax.lax.Precision.HIGHEST
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32),
                   k.astype(jnp.float32), precision=hp) * sm_scale
    Tq, Tk = q.shape[2], k.shape[2]
    mask = jnp.arange(Tk)[None, None, None, :] < key_lens[:, None, None, None]
    if causal:
        mask = mask & (jnp.arange(Tk)[None, :] <= jnp.arange(Tq)[:, None])
    s = jnp.where(mask, s, _NEG_INF)
    lse = jax.nn.logsumexp(s, axis=-1)
    p = jnp.exp(s - lse[..., None])
    out = jnp.einsum("bhqk,bhkd->bhqd", p, v.astype(jnp.float32),
                     precision=hp)
    return out, lse


def ring_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    key_lens: jax.Array,
    *,
    causal: bool,
    axis_name: str,
    axis_size: int,
    sm_scale: Optional[float] = None,
) -> jax.Array:
    """Ring attention body — call INSIDE shard_map.

    q, k, v: [B, H, Tl, D] — this device's time chunk (global time axis is
    ``axis_size * Tl``, chunk ``i`` on mesh position ``i``).
    key_lens: [B] GLOBAL valid key counts (keys are a global prefix).
    Returns [B, H, Tl, D] — the local chunk of the exact global attention.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    n = axis_size
    idx = jax.lax.axis_index(axis_name)
    Tl = q.shape[2]

    # Step 0: the diagonal chunk (own K/V) — ordinary causal mask inside.
    lens0 = jnp.clip(key_lens - idx * Tl, 0, Tl)
    out, lse = block_attention(q, k, v, lens0, causal, sm_scale)
    if n > 1:
        perm = _ring_perm(n)

        def ring_step(carry, s):
            out, lse, k_c, v_c = carry
            k_c = jax.lax.ppermute(k_c, axis_name, perm)
            v_c = jax.lax.ppermute(v_c, axis_name, perm)
            src = (idx - s) % n  # origin chunk of the K/V now on this device
            vis = _chunk_vis(key_lens, src, idx, Tl, causal)
            o_s, l_s = block_attention(q, k_c, v_c, vis, False, sm_scale)
            out, lse = _merge(out, lse, o_s, l_s)
            return (out, lse, k_c, v_c), None

        (out, lse, _, _), _ = jax.lax.scan(
            ring_step, (out, lse, k, v), jnp.arange(1, n)
        )
    return out.astype(q.dtype)


def ring_attention_sharded(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    key_lens: jax.Array,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    mesh=None,
    seq_axis: str = AXIS_MODEL,
    batch_axis: str = AXIS_DATA,
) -> jax.Array:
    """Jit-compatible wrapper: shard_map the ring over ``mesh``.

    q, k, v: [B, H, T, D] (global); key_lens: [B]. The time axis is mapped
    over ``seq_axis``, batch over ``batch_axis`` — GSPMD reshards the
    operands into that layout if they arrive differently. Requires
    B % mesh.shape[batch_axis] == 0; T is padded up to the next multiple
    of the ring internally (padded keys sit beyond every ``key_lens`` so
    they are masked; padded query rows are sliced away) — this matters
    because the VAE's encoder and decoder see CONSECUTIVE lengths (L+1 and
    L+2), which no ring size > 1 could otherwise serve simultaneously.
    """
    if mesh is None:
        mesh = current_mesh()
    if mesh is None:
        raise ValueError("ring_attention_sharded needs a mesh")
    n = mesh.shape[seq_axis]
    if q.shape[0] % mesh.shape[batch_axis]:
        raise ValueError(f"batch {q.shape[0]} does not divide the "
                         f"{batch_axis!r} axis of {dict(mesh.shape)}")

    T = q.shape[2]
    T_pad = ((T + n - 1) // n) * n
    if T_pad != T:
        pad = [(0, 0), (0, 0), (0, T_pad - T), (0, 0)]
        q, k, v = (jnp.pad(x, pad) for x in (q, k, v))

    qkv_spec = P(batch_axis, None, seq_axis, None)
    body = functools.partial(
        ring_attention,
        causal=causal,
        axis_name=seq_axis,
        axis_size=n,
        sm_scale=sm_scale,
    )
    out = _shard_map(
        body,
        mesh=mesh,
        in_specs=(qkv_spec, qkv_spec, qkv_spec, P(batch_axis)),
        out_specs=qkv_spec,
    )(q, k, v, key_lens)
    return out[:, :, :T, :] if T_pad != T else out
