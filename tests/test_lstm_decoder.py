"""Legacy LSTM decoder tests: step==scan, toy overfit, jitted decode loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.data import ToyData
from musicstyletransfer_tpu.models import (
    LSTMConfig,
    init_params,
    make_model,
)
from musicstyletransfer_tpu.models.lstm import LSTMDecoder
from tests.test_model import tiny_config


def lstm_config(vocab=10, classes=3):
    base = tiny_config(vocab=vocab, classes=classes, latent=8, size=16, heads=2,
                       layers=1)
    dec = dataclasses.replace(
        base.decoder_config,
        decoder_type="lstm",
        lstm_config=LSTMConfig(n_layers=2, hidden_dim=16, dropout=0.0),
    )
    return dataclasses.replace(base, decoder_config=dec)


@pytest.fixture(scope="module")
def setup():
    cfg = lstm_config()
    model = make_model(cfg)
    params = init_params(model, jax.random.key(0), max_seq_len=4)
    return cfg, model, params


class TestLSTMDecoder:
    def test_forward_shape(self, setup):
        cfg, model, params = setup
        B, L = 3, 4
        tokens = jnp.ones((B, L + 1), jnp.int32)
        logits, mu, logvar = model(params, tokens,
                                   jnp.full((B,), L, jnp.int32),
                                   jnp.zeros((B,), jnp.int32))
        assert logits.shape == (B, L + 1, 10)

    def test_step_matches_scan(self, setup):
        cfg, model, params = setup
        dec = LSTMDecoder(config=cfg.decoder_config, dtype=jnp.float32)
        dp = params["decoder"]
        B, L = 2, 5
        rng = np.random.default_rng(0)
        tokens = jnp.asarray(rng.integers(1, 10, (B, L)), jnp.int32)
        z = jnp.asarray(rng.normal(size=(B, 8)), jnp.float32)
        classes = jnp.asarray([0, 2], jnp.int32)

        batched = dec(dp, tokens, None, z, classes)
        cache = dec.prefill(dp, z, classes, 0)
        for t in range(L):
            logits_t, cache = dec.step_token(dp, tokens[:, t], cache, jnp.asarray(t))
            np.testing.assert_allclose(
                np.asarray(logits_t), np.asarray(batched[:, t]), rtol=2e-4,
                atol=2e-4, err_msg=f"step {t}",
            )

    def test_toy_overfit(self):
        from musicstyletransfer_tpu.training import (
            LossConfig,
            OptimizerConfig,
            build_optimizer,
            create_train_state,
            make_train_step,
        )

        cfg = lstm_config()
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=4)
        tx = build_optimizer(OptimizerConfig("adam", "clip_gradient:1.0", 2e-3))
        state = create_train_state(params, tx, jax.random.key(1))
        step = make_train_step(model, tx, LossConfig(kl_weight=0.1))
        batch = next(iter(ToyData()))
        args = tuple(
            jnp.asarray(a)
            for a in (batch.tokens, batch.seq_lens, batch.classes, batch.labels)
        )
        first = None
        for _ in range(300):
            state, m = step(state, None, *args)
            if first is None:
                first = float(m["total_loss"][0])
        assert float(m["total_loss"][0]) < first * 0.5

    def test_jitted_sampling_loop(self, setup):
        """The shared decode loop must work with the LSTM cache pytree."""
        from musicstyletransfer_tpu.inference.decode import sample_sequences
        from musicstyletransfer_tpu.midi.vocab import SOS_ID

        cfg, model, params = setup
        B, L = 2, 4
        tokens = jnp.ones((B, L + 1), jnp.int32).at[:, 0].set(SOS_ID)
        seqs, scores = sample_sequences(
            model, params, tokens, jnp.full((B,), L + 1, jnp.int32),
            jnp.zeros((B,), jnp.int32), 10, jax.random.key(5),
        )
        assert seqs.shape == (B, 10)
        assert np.all(np.asarray(seqs[:, 0]) == SOS_ID)

    def test_beam_search_with_lstm(self, setup):
        from musicstyletransfer_tpu.inference.decode import beam_search
        from musicstyletransfer_tpu.midi.vocab import SOS_ID

        cfg, model, params = setup
        B, L = 2, 4
        tokens = jnp.ones((B, L + 1), jnp.int32).at[:, 0].set(SOS_ID)
        seqs, scores = beam_search(
            model, params, tokens, jnp.full((B,), L + 1, jnp.int32),
            jnp.zeros((B,), jnp.int32), 10, 3,
        )
        assert seqs.shape == (B, 10)
