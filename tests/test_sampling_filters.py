"""Sampling support filters and the XLA decode loop's agreement with the
full causal forward.

``_filter_logits`` (top-k / nucleus) is pinned against a plain numpy
restatement of its contract; greedy and teacher-forced decoding through
the ``lax.while_loop`` KV-cache path must reproduce what one batched
causal forward over the same tokens predicts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.inference.decode import (
    _filter_logits,
    decode_sampled,
)
from musicstyletransfer_tpu.models import (
    LSTMConfig,
    TransformerConfig,
    init_params,
    make_model,
)
from tests.test_model import tiny_config

_CUT = -1e29  # filtered entries sit at -1e30


def _np_filter(logits, top_k, top_p):
    """numpy reference: the kept set is (a) every logit >= the k-th largest
    (ties kept), then (b) the smallest prefix of the descending-sorted
    distribution whose mass BEFORE each kept token is < top_p, with ties
    at the threshold kept. Returns a boolean keep mask."""
    x = np.asarray(logits, np.float64)
    keep = np.ones_like(x, bool)
    if top_k > 0:
        kth = -np.sort(-x, axis=-1)[:, min(top_k, x.shape[-1]) - 1:][:, :1]
        keep &= x >= kth
    if top_p > 0.0:
        xf = np.where(keep, x, -1e30)
        out = np.zeros_like(keep)
        for b in range(x.shape[0]):
            order = np.argsort(-xf[b], kind="stable")
            srt = xf[b][order]
            p = np.exp(srt - srt.max())
            p /= p.sum()
            before = np.cumsum(p) - p
            kept_vals = srt[before < top_p]
            out[b] = xf[b] >= kept_vals.min()
        keep &= out
    return keep


def _random_logits(seed, B=8, V=293):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(scale=3.0, size=(B, V)).astype(np.float32))


def _kept(filtered):
    return np.asarray(filtered) > _CUT


@pytest.mark.parametrize("top_k", [1, 3, 7, 50, 293])
def test_top_k_matches_numpy(top_k):
    logits = _random_logits(top_k)
    got = _filter_logits(logits, top_k, 0.0)
    np.testing.assert_array_equal(_kept(got), _np_filter(logits, top_k, 0.0))
    # kept logits pass through unchanged
    np.testing.assert_array_equal(np.asarray(got)[_kept(got)],
                                  np.asarray(logits)[_kept(got)])


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 0.99])
def test_top_p_matches_numpy(top_p):
    logits = _random_logits(int(top_p * 100))
    got = _filter_logits(logits, 0, top_p)
    np.testing.assert_array_equal(_kept(got), _np_filter(logits, 0, top_p))


def test_combined_filters_match_numpy():
    logits = _random_logits(42)
    got = _filter_logits(logits, 10, 0.7)
    np.testing.assert_array_equal(_kept(got), _np_filter(logits, 10, 0.7))


def test_top_k_tie_semantics():
    """With logits [5, 5, 5, 3, ...], top_k=2's threshold is 5 and all
    THREE fives survive (``logits < kth`` keeps ties) while 3 does not."""
    row = np.full((1, 293), -10.0, np.float32)
    row[0, [4, 100, 292]] = 5.0
    row[0, 7] = 3.0
    got = np.asarray(_filter_logits(jnp.asarray(row), 2, 0.0))[0]
    assert (got[[4, 100, 292]] == 5.0).all()
    assert got[7] < _CUT
    np.testing.assert_array_equal(got > _CUT, _np_filter(row, 2, 0.0)[0])


def test_top_p_always_keeps_argmax():
    logits = _random_logits(7)
    got = _kept(_filter_logits(logits, 0, 1e-6))
    best = np.argmax(np.asarray(logits), axis=-1)
    for b in range(got.shape[0]):
        assert list(np.flatnonzero(got[b])) == [best[b]]


def test_randomized_cross_check_vs_numpy():
    """Random rows x several (k, p), including rows with duplicate plateaus
    (half-integer logits force exact ties at the cut)."""
    rng = np.random.default_rng(2024)
    smooth = rng.normal(scale=4.0, size=(60, 293)).astype(np.float32)
    tied = np.round(rng.normal(scale=2.0, size=(60, 293)) * 2).astype(
        np.float32) / 2
    logits = jnp.asarray(np.concatenate([smooth, tied]))
    for top_k, top_p in [(5, 0.0), (64, 0.0), (0, 0.3), (0, 0.95),
                         (16, 0.8)]:
        np.testing.assert_array_equal(
            _kept(_filter_logits(logits, top_k, top_p)),
            _np_filter(logits, top_k, top_p),
            err_msg=f"keep-set mismatch at k={top_k} p={top_p}",
        )


def _decoder_variant(name):
    cfg = tiny_config(vocab=12, classes=2, latent=8, size=16, heads=2,
                      layers=2)
    if name == "pre_ln":
        tc = TransformerConfig(model_size=16, num_layers=2, num_heads=2,
                               vocab_size=12, norm_scheme="pre")
        cfg = cfg.copy(decoder_config=cfg.decoder_config.copy(
            transformer_config=tc))
    elif name == "per_step":
        cfg = cfg.copy(decoder_config=cfg.decoder_config.copy(
            class_conditioning="per_step"))
    elif name == "lstm":
        cfg = cfg.copy(decoder_config=cfg.decoder_config.copy(
            decoder_type="lstm", lstm_config=LSTMConfig(n_layers=2,
                                                        hidden_dim=16)))
    return cfg


@pytest.mark.parametrize("variant", ["post_ln", "pre_ln", "per_step", "lstm"])
def test_greedy_decode_matches_full_causal_forward(variant):
    """Greedy XLA decode == argmax of the batched causal forward re-run on
    the decoded tokens (teacher-forced), position by position, until EOS,
    and the per-token scores equal the forward's -log p."""
    from musicstyletransfer_tpu.midi.vocab import EOS_ID, PAD_ID

    cfg = _decoder_variant(variant)
    model = make_model(cfg)
    params = init_params(model, jax.random.key(3), max_seq_len=8)
    B, max_len = 4, 10
    z = jax.random.normal(jax.random.key(4), (B, 8))
    classes = jnp.asarray([0, 1, 0, 1], jnp.int32)
    with jax.default_matmul_precision("highest"):
        seqs, scores = decode_sampled(model, params, z, classes, max_len,
                                      jax.random.key(0), greedy=True)
        seqs = np.asarray(seqs)
        # Teacher-forced forward over the decoded prefix (PAD after EOS is
        # masked out by seq_lens, exactly as in training).
        lens = np.array([
            (np.flatnonzero(r == EOS_ID)[0] if (r == EOS_ID).any()
             else max_len - 1) for r in seqs])
        dec = model.decoder
        logits = dec(params["decoder"], jnp.asarray(seqs),
                     jnp.asarray(lens + 1, jnp.int32), z, classes)
    logits = np.asarray(logits)
    want_scores = np.zeros(B)
    for b in range(B):
        for t in range(1, max_len):
            tok = seqs[b, t]
            if tok == PAD_ID and t > lens[b]:
                break
            assert tok == np.argmax(logits[b, t - 1]), (variant, b, t)
            lp = logits[b, t - 1] - np.log(np.sum(np.exp(
                logits[b, t - 1] - logits[b, t - 1].max()))) - logits[
                b, t - 1].max()
            want_scores[b] -= lp[tok]
            if tok == EOS_ID:
                break
    np.testing.assert_allclose(np.asarray(scores), want_scores, rtol=1e-4,
                               atol=1e-4)
