"""On-device autoregressive decoding: ancestral sampling + beam search.

Replaces the reference's Python-stepped generation loop with one host sync
per token (sampler.py:161-257, SURVEY.md §3.3) by a single jitted program:
``lax.while_loop`` over KV-cache decode steps, batched multinomial sampling
via ``jax.random.categorical``, per-sequence EOS stopping (fixing the §8.9
SOS/PAD stop quirk), and an early exit once every sequence is done.

Beam search is a working re-design of the reference's LSTM-API-bound
implementation (sampler.py:192-257, broken against the transformer decoder —
SURVEY.md §8.10): score-folded top-k over (beam x vocab) with on-device
hypothesis and cache reordering.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..midi.vocab import EOS_ID, PAD_ID, SOS_ID
from ..models.vae import StyleVAE

_NEG_INF = -1e30  # filtered-out logits (avoids inf-inf NaNs in softmax)


class _SampleLoopState(NamedTuple):
    seqs: jax.Array  # [B, max_len] generated ids (position 0 = SOS)
    scores: jax.Array  # [B] accumulated -log p of sampled tokens
    cache: Tuple  # per-layer KV cache
    t: jax.Array  # current position
    rng: jax.Array
    done: jax.Array  # [B] bool


def _encode_deterministic(model: StyleVAE, params, tokens, seq_lens, classes):
    """z = mu: deterministic encode at inference (reference: sampler.py:145-151)."""
    mu, _ = model.encode(params, tokens, seq_lens, classes)
    return mu


def _filter_logits(logits: jax.Array, top_k: int, top_p: float) -> jax.Array:
    """Restrict sampling support: top-k and/or nucleus (top-p) filtering.

    Both are trace-time constants (static under jit). top_k > 0 keeps the
    k highest-probability tokens; 0 < top_p <= 1 keeps the smallest set of
    tokens whose cumulative probability reaches top_p (the argmax token is
    always kept). Filtered entries go to -inf before the categorical draw.
    """
    if top_k > 0:
        kth = jax.lax.top_k(logits, min(top_k, logits.shape[-1]))[0][..., -1:]
        logits = jnp.where(logits < kth, _NEG_INF, logits)
    if top_p > 0.0:
        sorted_desc = -jnp.sort(-logits, axis=-1)
        probs = jax.nn.softmax(sorted_desc, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # token i (sorted) is kept while the mass BEFORE it is < top_p
        keep = cum - probs < top_p
        threshold = jnp.min(
            jnp.where(keep, sorted_desc, jnp.inf), axis=-1, keepdims=True
        )
        logits = jnp.where(logits < threshold, _NEG_INF, logits)
    return logits


@functools.partial(jax.jit, static_argnums=(0, 5),
                   static_argnames=("max_len", "top_k", "top_p", "greedy"))
def sample_sequences(
    model: StyleVAE,
    params,
    tokens: jax.Array,
    seq_lens: jax.Array,
    classes: jax.Array,
    max_len: int,
    rng: jax.Array,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    greedy: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Encode + ancestral multinomial decode, fully on device.

    tokens: [B, L+1] SOS-prefixed source sequences; classes: [B] target
    style ids (style transfer = pass a different class than encoded —
    reference sampler.py:93-104 swaps batch.data[2]).

    ``top_k``/``top_p`` restrict the sampling support (0 disables each —
    the reference's plain multinomial).

    Returns (seqs [B, max_len] with SOS at position 0 and PAD after EOS,
    scores [B] = sum of -log p of emitted tokens).
    """
    z = _encode_deterministic(model, params, tokens, seq_lens, classes)
    return decode_sampled(model, params, z, classes, max_len, rng, temperature,
                          top_k=top_k, top_p=top_p, greedy=greedy)


@functools.partial(jax.jit, static_argnums=(0, 4),
                   static_argnames=("max_len", "top_k", "top_p", "greedy"))
def decode_sampled(
    model: StyleVAE,
    params,
    z: jax.Array,
    classes: jax.Array,
    max_len: int,
    rng: jax.Array,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    greedy: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Ancestral multinomial decode from (z, classes); ``temperature``
    scales the logits before sampling (1.0 = reference behavior);
    ``top_k``/``top_p`` restrict the support (see _filter_logits);
    ``greedy=True`` takes the argmax instead of sampling.
    """
    B = z.shape[0]
    cache = model.decode_prefill(params, z, classes, max_len + 1)
    seqs = jnp.full((B, max_len), PAD_ID, jnp.int32).at[:, 0].set(SOS_ID)

    def cond(st: _SampleLoopState):
        return (st.t < max_len) & ~jnp.all(st.done)

    def body(st: _SampleLoopState) -> _SampleLoopState:
        last = jax.lax.dynamic_slice_in_dim(st.seqs, st.t - 1, 1, axis=1)[:, 0]
        logits, cache = model.decode_step(params, last, st.cache, st.t,
                                          classes)
        rng, key = jax.random.split(st.rng)
        filtered = _filter_logits(logits / temperature, top_k, top_p)
        if greedy:
            nxt = jnp.argmax(filtered, axis=-1).astype(jnp.int32)
        else:
            nxt = jax.random.categorical(key, filtered).astype(jnp.int32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        tok_logp = jnp.take_along_axis(logp, nxt[:, None], axis=-1)[:, 0]
        scores = st.scores + jnp.where(st.done, 0.0, -tok_logp)
        done = st.done | (nxt == EOS_ID)
        nxt = jnp.where(st.done, PAD_ID, nxt)
        seqs = jax.lax.dynamic_update_slice(st.seqs, nxt[:, None], (0, st.t))
        return _SampleLoopState(seqs, scores, cache, st.t + 1, rng, done)

    init = _SampleLoopState(
        seqs=seqs,
        scores=jnp.zeros((B,), jnp.float32),
        cache=cache,
        t=jnp.asarray(1, jnp.int32),
        rng=rng,
        done=jnp.zeros((B,), bool),
    )
    final = jax.lax.while_loop(cond, body, init)
    return final.seqs, final.scores


@functools.partial(jax.jit, static_argnums=(0, 4, 5),
                   static_argnames=("max_len", "num_classes", "top_k",
                                    "top_p"))
def style_transfer_all_classes(
    model: StyleVAE,
    params,
    tokens: jax.Array,
    seq_lens: jax.Array,
    max_len: int,
    num_classes: int,
    rng: jax.Array,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
) -> Tuple[jax.Array, jax.Array]:
    """Transfer a batch into EVERY target class in one fused device call.

    The reference loops classes on the host, re-running encode+decode per
    class (sampler.py:93-104, with the target class written into the batch
    so the ENCODER also sees it — semantics kept here). This tiles the
    batch C times instead: one encode, one decode loop, C*B sequences.

    Returns (seqs [C, B, max_len], scores [C, B]).
    """
    B = tokens.shape[0]
    C = num_classes
    tokens_rep = jnp.tile(tokens, (C, 1))
    seq_lens_rep = jnp.tile(seq_lens, (C,))
    classes_rep = jnp.repeat(jnp.arange(C, dtype=jnp.int32), B)
    seqs, scores = sample_sequences(
        model, params, tokens_rep, seq_lens_rep, classes_rep, max_len, rng,
        temperature, top_k=top_k, top_p=top_p,
    )
    return seqs.reshape(C, B, max_len), scores.reshape(C, B)


class _BeamLoopState(NamedTuple):
    seqs: jax.Array  # [B*K, max_len]
    scores: jax.Array  # [B, K] cumulative -log p (lower is better)
    cache: Tuple
    t: jax.Array
    done: jax.Array  # [B*K]


@functools.partial(jax.jit, static_argnums=(0, 5, 6, 7),
                   static_argnames=("max_len", "beam_size",
                                    "length_penalty"))
def beam_search(
    model: StyleVAE,
    params,
    tokens: jax.Array,
    seq_lens: jax.Array,
    classes: jax.Array,
    max_len: int,
    beam_size: int,
    length_penalty: float = 0.0,
) -> Tuple[jax.Array, jax.Array]:
    """Encode + batched beam-search decode.

    ``length_penalty`` alpha > 0 ranks final hypotheses by
    score / len^alpha (GNMT-style length normalization; 0 = raw
    cumulative score, the reference's behavior).

    Returns (seqs [B, max_len] best hypothesis per sequence, scores [B]).
    """
    z = _encode_deterministic(model, params, tokens, seq_lens, classes)
    return decode_beam(model, params, z, classes, max_len, beam_size,
                       length_penalty)


@functools.partial(jax.jit, static_argnums=(0, 4, 5, 6),
                   static_argnames=("max_len", "beam_size",
                                    "length_penalty"))
def decode_beam(
    model: StyleVAE,
    params,
    z: jax.Array,
    classes: jax.Array,
    max_len: int,
    beam_size: int,
    length_penalty: float = 0.0,
) -> Tuple[jax.Array, jax.Array]:
    B = z.shape[0]
    K = beam_size
    V = model.config.decoder_config.output_dim

    z_rep = jnp.repeat(z, K, axis=0)  # [B*K, latent]
    classes_rep = jnp.repeat(classes, K, axis=0)
    cache = model.decode_prefill(params, z_rep, classes_rep, max_len + 1)
    seqs = jnp.full((B * K, max_len), PAD_ID, jnp.int32).at[:, 0].set(SOS_ID)
    # Only beam 0 is live initially so identical expansions don't tie.
    scores = jnp.where(
        jnp.arange(K)[None, :] == 0, 0.0, jnp.inf
    ) * jnp.ones((B, 1))
    batch_offset = (jnp.arange(B) * K)[:, None]  # [B, 1]

    def cond(st: _BeamLoopState):
        return (st.t < max_len) & ~jnp.all(st.done)

    def body(st: _BeamLoopState) -> _BeamLoopState:
        last = jax.lax.dynamic_slice_in_dim(st.seqs, st.t - 1, 1, axis=1)[:, 0]
        logits, cache = model.decode_step(params, last, st.cache, st.t,
                                          classes_rep)
        nll = -jax.nn.log_softmax(logits, axis=-1)  # [B*K, V]
        # Finished hypotheses may only extend with PAD at no cost.
        pad_only = jnp.full((V,), jnp.inf).at[PAD_ID].set(0.0)
        nll = jnp.where(st.done[:, None], pad_only[None, :], nll)
        expanded = st.scores.reshape(B * K, 1) + nll  # [B*K, V]
        folded = expanded.reshape(B, K * V)
        top_scores, top_idx = jax.lax.top_k(-folded, K)  # max of negated
        new_scores = -top_scores  # [B, K]
        hyp_idx = top_idx // V  # [B, K] source beam per new hypothesis
        word_idx = (top_idx % V).astype(jnp.int32)  # [B, K]

        flat_src = (hyp_idx + batch_offset).reshape(B * K)
        seqs = jnp.take(st.seqs, flat_src, axis=0)
        seqs = jax.lax.dynamic_update_slice(
            seqs, word_idx.reshape(B * K, 1), (0, st.t)
        )
        cache = jax.tree.map(lambda c: jnp.take(c, flat_src, axis=0), cache)
        done = jnp.take(st.done, flat_src, axis=0) | (
            word_idx.reshape(B * K) == EOS_ID
        )
        return _BeamLoopState(seqs, new_scores, cache, st.t + 1, done)

    init = _BeamLoopState(
        seqs=seqs,
        scores=scores,
        cache=cache,
        t=jnp.asarray(1, jnp.int32),
        done=jnp.zeros((B * K,), bool),
    )
    final = jax.lax.while_loop(cond, body, init)
    if length_penalty > 0.0:
        # GNMT-style: rank by score / len^alpha (lower is better).
        seqs_bk = final.seqs.reshape(B, K, max_len)
        # Normalize over GENERATED tokens only: position 0 is the SOS, which
        # contributes no score term.
        lens = (jnp.sum(seqs_bk != PAD_ID, axis=-1) - 1).astype(jnp.float32)
        normed = final.scores / jnp.maximum(lens, 1.0) ** length_penalty
        best_idx = jnp.argmin(normed, axis=-1)  # [B]
        best = jnp.take_along_axis(
            seqs_bk, best_idx[:, None, None], axis=1
        )[:, 0]
        best_scores = jnp.take_along_axis(normed, best_idx[:, None], axis=1)[:, 0]
        return best, best_scores
    # Hypotheses are kept sorted by top_k: beam 0 is the best.
    best = final.seqs.reshape(B, K, max_len)[:, 0]
    return best, final.scores[:, 0]
