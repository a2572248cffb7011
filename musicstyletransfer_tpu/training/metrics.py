"""PAD-ignoring training metrics as pure-JAX (sum, count) accumulators.

Reference: VarAutoEncoder/metrics.py:1-74 + the trainer's metric set
(trainer.py:107-119): perplexity, accuracy, top-5 accuracy, mean KL, mean
total loss. The reference's TopKAccuracy label-reshape bug (metrics.py:25-26,
SURVEY.md §8.8) is fixed: labels are compared against predictions, not
against themselves.

Each update function returns (sum, count); ``MetricAccumulator`` keeps host
floats so the jitted step returns only small scalars.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..midi.vocab import PAD_ID


def masked_log_perplexity(
    logits: jax.Array, labels: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """(sum of -log p(label), #valid). exp(sum/count) = perplexity."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    mask = labels != PAD_ID
    return jnp.sum(nll * mask), jnp.sum(mask)


def masked_accuracy(
    logits: jax.Array, labels: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    pred = jnp.argmax(logits, axis=-1)
    mask = labels != PAD_ID
    return jnp.sum((pred == labels) & mask), jnp.sum(mask)


def masked_topk_accuracy(
    logits: jax.Array, labels: jax.Array, k: int = 5
) -> Tuple[jax.Array, jax.Array]:
    """Label-in-top-k via the label's RANK, not a top_k/sort.

    ``lax.top_k`` can lower to a full sort over the vocabulary, purely
    for this metric. The label is in
    the top k iff fewer than k entries outrank it, where an entry outranks
    the label if it is strictly greater OR equal-valued at a lower index
    (top_k's lowest-index-first tie rule) — two cheap compare+reduce
    passes. Matches top_k everywhere except one irrelevant corner: IEEE
    equality merges -0.0 with +0.0 while the sort's total order splits
    them, so results can differ only when distinct signed zeros straddle
    the k boundary — impossible-in-practice for real logits.
    """
    label_logit = jnp.take_along_axis(logits, labels[..., None], axis=-1)
    vocab_idx = jnp.arange(logits.shape[-1])
    outranked = jnp.sum(
        (logits > label_logit)
        | ((logits == label_logit) & (vocab_idx < labels[..., None])),
        axis=-1,
    )
    hit = outranked < k
    mask = labels != PAD_ID
    return jnp.sum(hit & mask), jnp.sum(mask)


def step_metrics(
    logits: jax.Array,
    labels: jax.Array,
    loss_scalars: Dict[str, jax.Array],
) -> Dict[str, Tuple[jax.Array, jax.Array]]:
    """All per-step metric (sum, count) pairs, computed inside jit."""
    out: Dict[str, Tuple[jax.Array, jax.Array]] = {
        "ppl": masked_log_perplexity(logits, labels),
        "acc": masked_accuracy(logits, labels),
        "top5_acc": masked_topk_accuracy(logits, labels, k=5),
    }
    for name, val in loss_scalars.items():
        out[name] = (val, jnp.asarray(1, jnp.int32))
    return out


class MetricAccumulator:
    """Host-side running (sum, count) store mirroring the reference's
    metric reset/get cycle (trainer.py:107-119, metrics reset per log)."""

    LOG_SPACE = {"ppl"}  # report exp(mean) for these

    def __init__(self) -> None:
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, float] = {}

    def update(self, metrics: Dict[str, Tuple[jax.Array, jax.Array]]) -> None:
        for name, (s, c) in metrics.items():
            self._sums[name] = self._sums.get(name, 0.0) + float(s)
            self._counts[name] = self._counts.get(name, 0.0) + float(c)

    def get(self) -> Dict[str, float]:
        out = {}
        for name, s in self._sums.items():
            c = self._counts[name]
            mean = s / c if c else float("nan")
            if name in self.LOG_SPACE:
                mean = math.exp(min(mean, 50.0))
            out[name] = mean
        return out

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()
