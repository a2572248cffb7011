"""Inference tests: jitted sampling loop, beam search, style-transfer sampler."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.inference.decode import (
    beam_search,
    decode_sampled,
    sample_sequences,
)
from musicstyletransfer_tpu.midi.vocab import EOS_ID, PAD_ID, SOS_ID
from musicstyletransfer_tpu.models import init_params, make_model
from tests.test_model import tiny_config


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(vocab=10, classes=3, latent=8, size=16, heads=2, layers=1)
    model = make_model(cfg)
    params = init_params(model, jax.random.key(0), max_seq_len=6)
    B, L = 2, 6
    tokens = jnp.ones((B, L + 1), jnp.int32).at[:, 0].set(SOS_ID)
    seq_lens = jnp.full((B,), L + 1, jnp.int32)
    classes = jnp.arange(B, dtype=jnp.int32)
    return cfg, model, params, tokens, seq_lens, classes


class TestSampling:
    def test_shapes_and_layout(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        seqs, scores = sample_sequences(
            model, params, tokens, seq_lens, classes, 14, jax.random.key(1)
        )
        assert seqs.shape == (2, 14)
        assert scores.shape == (2,)
        assert np.all(np.asarray(seqs[:, 0]) == SOS_ID)
        assert np.all(np.asarray(seqs) >= 0)
        assert np.all(np.asarray(seqs) < 10)

    def test_eos_stops_sequence(self, setup):
        """After a sequence emits EOS, all later positions must be PAD."""
        cfg, model, params, tokens, seq_lens, classes = setup
        seqs, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 14, jax.random.key(2)
        )
        s = np.asarray(seqs)
        for row in s:
            eos_pos = np.nonzero(row == EOS_ID)[0]
            if len(eos_pos):
                assert np.all(row[eos_pos[0] + 1 :] == PAD_ID)

    def test_deterministic_given_key(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        a, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 14, jax.random.key(3)
        )
        b, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 14, jax.random.key(3)
        )
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_class_conditioning_changes_samples(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        a, _ = sample_sequences(
            model, params, tokens, seq_lens,
            jnp.zeros_like(classes), 14, jax.random.key(4),
        )
        b, _ = sample_sequences(
            model, params, tokens, seq_lens,
            jnp.ones_like(classes), 14, jax.random.key(4),
        )
        # Same rng, different conditioning: distributions differ, so with
        # 13 sampled positions the sequences should differ somewhere.
        assert not np.array_equal(np.asarray(a), np.asarray(b))


class TestBeamSearch:
    def test_shapes(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        seqs, scores = beam_search(
            model, params, tokens, seq_lens, classes, 14, 4
        )
        assert seqs.shape == (2, 14)
        assert scores.shape == (2,)
        assert np.all(np.asarray(seqs[:, 0]) == SOS_ID)

    def test_beam1_is_greedy(self, setup):
        """Beam size 1 must equal greedy argmax decoding step by step."""
        cfg, model, params, tokens, seq_lens, classes = setup
        seqs, _ = beam_search(model, params, tokens, seq_lens, classes, 10, 1)

        # Manual greedy rollout through the public decode-step API.
        mu, _ = model.encode(params, tokens, seq_lens, classes)
        cache = model.decode_prefill(params, mu, classes, 11)
        cur = jnp.full((2,), SOS_ID, jnp.int32)
        out = [cur]
        done = np.zeros(2, bool)
        for t in range(1, 10):
            logits, cache = model.decode_step(params, cur, cache, jnp.asarray(t))
            cur = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            nxt = np.asarray(cur).copy()
            nxt[done] = PAD_ID
            out.append(jnp.asarray(nxt))
            done |= nxt == EOS_ID
            cur = jnp.asarray(nxt)
        greedy = np.stack([np.asarray(o) for o in out], axis=1)
        np.testing.assert_array_equal(np.asarray(seqs), greedy)

    def test_scores_sorted(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        from musicstyletransfer_tpu.inference.decode import decode_beam

        mu = jnp.zeros((2, 8))
        seqs, scores = decode_beam(model, params, mu, classes, 12, 3)
        assert np.all(np.isfinite(np.asarray(scores)))


class TestSamplerEndToEnd:
    def test_style_transfer_writes_files(self, setup, tmp_path):
        """Full surface: config+params on disk -> sampler -> MIDI files with
        the reference naming scheme."""
        cfg, model, params, tokens, seq_lens, classes = setup
        from musicstyletransfer_tpu.inference.sampler import Sampling
        from musicstyletransfer_tpu.training import (
            OptimizerConfig,
            build_optimizer,
            create_train_state,
            save_checkpoint,
        )
        from musicstyletransfer_tpu.data.dataset import Batch
        from musicstyletransfer_tpu.midi.vocab import note_on_id

        folder = str(tmp_path)
        cfg.save(os.path.join(folder, "config"))
        tx = build_optimizer(OptimizerConfig("adam", "", 1e-3))
        state = create_train_state(params, tx, jax.random.key(0))
        save_checkpoint(folder, 1, state)

        sampler = Sampling(folder, checkpoint=-1, max_seq_len=6)
        batch = Batch(
            tokens=np.asarray(tokens),
            seq_lens=np.asarray(seq_lens),
            classes=np.asarray(classes),
            labels=np.asarray(tokens),
        )
        out = str(tmp_path / "samples")
        sampler.process_batch(batch, out, num_classes=3)
        files = sorted(os.listdir(out))
        assert "out-0.original.mid" in files
        assert "out-1.original.mid" in files
        for c in range(3):
            assert f"out-0.class-{c}.mid" in files
            assert f"out-1.class-{c}.mid" in files


class TestFusedStyleTransfer:
    def test_all_classes_one_call(self, setup):
        from musicstyletransfer_tpu.inference.decode import (
            style_transfer_all_classes,
        )

        cfg, model, params, tokens, seq_lens, classes = setup
        seqs, scores = style_transfer_all_classes(
            model, params, tokens, seq_lens, 14, 3, jax.random.key(0)
        )
        assert seqs.shape == (3, 2, 14)
        assert scores.shape == (3, 2)
        s = np.asarray(seqs)
        assert np.all(s[:, :, 0] == SOS_ID)
        # different target classes produce different transfers
        assert not (np.array_equal(s[0], s[1]) and np.array_equal(s[1], s[2]))


class TestTemperature:
    def test_low_temperature_approaches_greedy(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        from musicstyletransfer_tpu.inference.decode import beam_search

        cold, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 12, jax.random.key(9),
            0.01,
        )
        greedy, _ = beam_search(model, params, tokens, seq_lens, classes, 12, 1)
        np.testing.assert_array_equal(np.asarray(cold), np.asarray(greedy))

    def test_high_temperature_changes_samples(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        a, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 12, jax.random.key(9), 1.0
        )
        b, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 12, jax.random.key(9), 5.0
        )
        assert not np.array_equal(np.asarray(a), np.asarray(b))


class TestTopKTopP:
    def test_top_k_1_is_greedy(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        from musicstyletransfer_tpu.inference.decode import beam_search

        topk1, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 12, jax.random.key(3),
            1.0, top_k=1,
        )
        greedy, _ = beam_search(model, params, tokens, seq_lens, classes, 12, 1)
        np.testing.assert_array_equal(np.asarray(topk1), np.asarray(greedy))

    def test_tiny_top_p_is_greedy(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        from musicstyletransfer_tpu.inference.decode import beam_search

        nucleus, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 12, jax.random.key(3),
            1.0, top_p=1e-6,  # keeps only the argmax token
        )
        greedy, _ = beam_search(model, params, tokens, seq_lens, classes, 12, 1)
        np.testing.assert_array_equal(np.asarray(nucleus), np.asarray(greedy))

    def test_filters_default_off_match_plain_sampling(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        a, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 12, jax.random.key(5)
        )
        b, _ = sample_sequences(
            model, params, tokens, seq_lens, classes, 12, jax.random.key(5),
            1.0, top_k=0, top_p=0.0,
        )
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_filter_logits_semantics(self):
        from musicstyletransfer_tpu.inference.decode import _filter_logits

        logits = jnp.log(jnp.asarray([[0.5, 0.25, 0.15, 0.1]]))
        k2 = np.asarray(_filter_logits(logits, top_k=2, top_p=0.0))
        assert np.isfinite(k2[0, :2]).all() and (k2[0, 2:] < -1e29).all()
        # top_p=0.6: 0.5 alone misses 0.6, so {0.5, 0.25} survives
        p6 = np.asarray(_filter_logits(logits, top_k=0, top_p=0.6))
        assert np.isfinite(p6[0, :2]).all() and (p6[0, 2:] < -1e29).all()
        # top_p=0.5: the argmax alone reaches it
        p5 = np.asarray(_filter_logits(logits, top_k=0, top_p=0.5))
        assert np.isfinite(p5[0, 0]) and (p5[0, 1:] < -1e29).all()


class TestLengthPenalty:
    def test_zero_penalty_is_default_behavior(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        a, _ = beam_search(model, params, tokens, seq_lens, classes, 12, 3)
        b, _ = beam_search(model, params, tokens, seq_lens, classes, 12, 3, 0.0)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_penalty_returns_valid_hypothesis(self, setup):
        cfg, model, params, tokens, seq_lens, classes = setup
        seqs, scores = beam_search(
            model, params, tokens, seq_lens, classes, 12, 3, 0.7
        )
        assert seqs.shape == (2, 12)
        assert np.all(np.asarray(seqs[:, 0]) == SOS_ID)
        assert np.all(np.isfinite(np.asarray(scores)))


class TestReorderMatchesOneHot:
    """The beam loop's cache reorder is a row gather (``jnp.take`` over the
    flattened batch*beam axis). It must equal the one-hot permutation
    matmul formulation of the same reorder BIT-exactly, for both cache
    dtypes, including many-to-one selections (two hypotheses descending
    from one beam)."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_take_bitwise(self, dtype):
        import jax.numpy as jnp

        rng = np.random.default_rng(11)
        N = 24
        c = jnp.asarray(
            (rng.normal(scale=7.0, size=(N, 9, 2, 5)) ** 3).astype(
                np.float32
            )
        ).astype(dtype)
        src = jnp.asarray(rng.integers(0, N, (N,)), jnp.int32)  # many-to-one
        sel = jax.nn.one_hot(src, N, dtype=jnp.float32)
        got = jnp.take(c, src, axis=0)
        ref = jnp.einsum("nm,m...->n...", sel, c.astype(jnp.float32),
                         precision=jax.lax.Precision.HIGHEST)
        assert got.dtype == c.dtype
        np.testing.assert_array_equal(
            np.asarray(got, np.float32), np.asarray(ref, np.float32)
        )
