"""Model core tests: shapes, masking invariance, config round-trip,
incremental-decode vs batched-forward equivalence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.models import (
    DecoderConfig,
    EncoderConfig,
    ModelConfig,
    TransformerConfig,
    init_params,
    make_model,
)
from musicstyletransfer_tpu.models.config import Config


def tiny_config(vocab=10, classes=3, latent=8, size=16, heads=2, layers=2):
    tc = TransformerConfig(
        model_size=size, num_layers=layers, num_heads=heads, dropout=0.0,
        vocab_size=vocab,
    )
    return ModelConfig(
        encoder_config=EncoderConfig(
            transformer_config=tc, latent_dim=latent, num_classes=classes,
            input_dim=vocab,
        ),
        decoder_config=DecoderConfig(
            transformer_config=tc, latent_dim=latent, num_classes=classes,
            output_dim=vocab,
        ),
        dtype="float32",
    )


@pytest.fixture(scope="module")
def model_and_params():
    cfg = tiny_config()
    model = make_model(cfg)
    params = init_params(model, jax.random.key(0), max_seq_len=6)
    return cfg, model, params


class TestForward:
    def test_shapes(self, model_and_params):
        cfg, model, params = model_and_params
        B, L = 4, 6
        tokens = jnp.ones((B, L + 1), jnp.int32)
        seq_lens = jnp.full((B,), L, jnp.int32)
        classes = jnp.zeros((B,), jnp.int32)
        logits, mu, logvar = model(params, tokens, seq_lens, classes)
        assert logits.shape == (B, L + 1, 10)
        assert mu.shape == (B, 8) and logvar.shape == (B, 8)

    def test_pad_invariance(self, model_and_params):
        """The amount of PAD tail must not change the encoder latent:
        proves the padding mask is real (the reference's was a no-op, §8.4)."""
        cfg, model, params = model_and_params
        from musicstyletransfer_tpu.models.vae import VAEEncoder

        enc = VAEEncoder(config=cfg.encoder_config, dtype=jnp.float32)
        ep = params["encoder"]
        B = 2
        content = np.array([[1, 4, 5, 6], [1, 7, 8, 9]], np.int32)
        classes = jnp.zeros((B,), jnp.int32)

        def mu_for(pad_len):
            toks = np.concatenate(
                [content, np.zeros((B, pad_len), np.int32)], axis=1
            )
            mu, _ = enc(ep, jnp.asarray(toks), classes)
            return np.asarray(mu)

        np.testing.assert_allclose(mu_for(1), mu_for(5), rtol=1e-5, atol=1e-5)

    def test_causality(self, model_and_params):
        """Decoder prediction at position t must not depend on tokens > t."""
        cfg, model, params = model_and_params
        B, L = 2, 6
        t0 = np.ones((B, L + 1), np.int32) * 5
        t0[:, 0] = 1
        t1 = t0.copy()
        t1[:, 4:] = 7  # change late tokens only
        seq_lens = jnp.full((B,), L, jnp.int32)
        classes = jnp.zeros((B,), jnp.int32)
        # Drive the decoder directly with a fixed z to isolate causality
        # from the encoder (which legitimately sees the whole sequence).
        from musicstyletransfer_tpu.models.vae import VAEDecoder

        z = jnp.zeros((B, 8))
        dec = VAEDecoder(config=cfg.decoder_config, dtype=jnp.float32)
        dp = params["decoder"]
        da = dec(dp, jnp.asarray(t0), seq_lens, z, classes)
        db = dec(dp, jnp.asarray(t1), seq_lens, z, classes)
        np.testing.assert_allclose(
            np.asarray(da)[:, :4], np.asarray(db)[:, :4], rtol=1e-5, atol=1e-5
        )
        assert not np.allclose(np.asarray(da)[:, 5], np.asarray(db)[:, 5])

    def test_class_conditioning_changes_output(self, model_and_params):
        cfg, model, params = model_and_params
        B, L = 2, 6
        tokens = jnp.ones((B, L + 1), jnp.int32) * 3
        seq_lens = jnp.full((B,), L, jnp.int32)
        l0, m0, _ = model(params, tokens, seq_lens, jnp.zeros((B,), jnp.int32))
        l1, m1, _ = model(params, tokens, seq_lens, jnp.ones((B,), jnp.int32))
        assert not np.allclose(np.asarray(m0), np.asarray(m1))
        assert not np.allclose(np.asarray(l0), np.asarray(l1))


class TestIncrementalDecode:
    def test_step_matches_batched_forward(self, model_and_params):
        """KV-cache stepping must reproduce the batched causal forward —
        the correctness anchor for the on-device sampling loop."""
        cfg, model, params = model_and_params
        from musicstyletransfer_tpu.models.vae import VAEDecoder

        B, L = 3, 6
        rng = np.random.default_rng(1)
        tokens = np.concatenate(
            [np.full((B, 1), 1), rng.integers(3, 10, (B, L))], axis=1
        ).astype(np.int32)
        seq_lens = jnp.full((B,), L + 1, jnp.int32)  # all positions valid
        classes = jnp.asarray(rng.integers(0, 3, (B,)), jnp.int32)
        z = jnp.asarray(rng.normal(size=(B, 8)), jnp.float32)

        dec = VAEDecoder(config=cfg.decoder_config, dtype=jnp.float32)
        dp = params["decoder"]
        batched = dec(dp, jnp.asarray(tokens), seq_lens, z, classes)

        # Incremental: prefill fills cache position 0 (conditioning state,
        # whose prediction is dropped); stepping token j at position j+1
        # must reproduce batched logits[:, j].
        cache = dec.prefill(dp, z, classes, L + 2)
        for t in range(1, L + 2):
            logits_t, cache = dec.step_token(
                dp, jnp.asarray(tokens[:, t - 1]), cache, jnp.asarray(t))
            np.testing.assert_allclose(
                np.asarray(logits_t),
                np.asarray(batched[:, t - 1]),
                rtol=2e-4,
                atol=2e-4,
                err_msg=f"mismatch at step {t}",
            )


class TestPreLN:
    """norm_scheme="pre": the stability scheme the wide preset uses.
    Must preserve the
    incremental-decode == batched-forward anchor and carry its final
    stack LN in both paths."""

    @pytest.fixture(scope="class")
    def pre_model(self):
        tc = TransformerConfig(
            model_size=16, num_layers=2, num_heads=2, dropout=0.0,
            vocab_size=10, norm_scheme="pre",
        )
        cfg = ModelConfig(
            encoder_config=EncoderConfig(
                transformer_config=tc, latent_dim=8, num_classes=3,
                input_dim=10,
            ),
            decoder_config=DecoderConfig(
                transformer_config=tc, latent_dim=8, num_classes=3,
                output_dim=10,
            ),
            dtype="float32",
        )
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=6)
        return cfg, model, params

    def test_final_ln_exists(self, pre_model):
        _, _, params = pre_model
        assert "final_ln" in params["decoder"]["decoder"]
        assert "final_ln" in params["encoder"]["encoder"]

    def test_step_matches_batched_forward(self, pre_model):
        cfg, model, params = pre_model
        from musicstyletransfer_tpu.models.vae import VAEDecoder

        B, L = 3, 6
        rng = np.random.default_rng(2)
        tokens = np.concatenate(
            [np.full((B, 1), 1), rng.integers(3, 10, (B, L))], axis=1
        ).astype(np.int32)
        seq_lens = jnp.full((B,), L + 1, jnp.int32)
        classes = jnp.asarray(rng.integers(0, 3, (B,)), jnp.int32)
        z = jnp.asarray(rng.normal(size=(B, 8)), jnp.float32)

        dec = VAEDecoder(config=cfg.decoder_config, dtype=jnp.float32)
        dp = params["decoder"]
        batched = dec(dp, jnp.asarray(tokens), seq_lens, z, classes)
        cache = dec.prefill(dp, z, classes, L + 2)
        for t in range(1, L + 2):
            logits_t, cache = dec.step_token(
                dp, jnp.asarray(tokens[:, t - 1]), cache, jnp.asarray(t))
            np.testing.assert_allclose(
                np.asarray(logits_t), np.asarray(batched[:, t - 1]),
                rtol=2e-4, atol=2e-4, err_msg=f"mismatch at step {t}",
            )

    def test_train_step_runs_and_is_finite(self, pre_model):
        cfg, model, params = pre_model
        from musicstyletransfer_tpu.training.loss import vae_loss

        B, L = 4, 6
        rng = np.random.default_rng(3)
        tokens = jnp.asarray(rng.integers(1, 10, (B, L + 1)), jnp.int32)
        labels = jnp.asarray(rng.integers(0, 10, (B, L + 1)), jnp.int32)
        seq_lens = jnp.full((B,), L, jnp.int32)
        classes = jnp.zeros((B,), jnp.int32)

        def loss_fn(p):
            logits, mu, logvar = model(p, tokens, seq_lens, classes,
                                       rng=jax.random.key(1))
            total, _ = vae_loss(logits, labels, mu, logvar, kl_weight=0.5)
            return total

        loss, grads = jax.value_and_grad(loss_fn)(params)
        assert np.isfinite(float(loss))
        assert all(np.all(np.isfinite(np.asarray(g)))
                   for g in jax.tree.leaves(grads))


class TestPerStepConditioning:
    """class_conditioning="per_step": the class embedding is added to every
    decoder position's input."""

    @pytest.fixture(scope="class")
    def per_step_model(self):
        cfg = tiny_config()
        cfg = cfg.copy(
            decoder_config=cfg.decoder_config.copy(
                class_conditioning="per_step"
            )
        )
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=6)
        return cfg, model, params

    def test_step_matches_batched_forward(self, per_step_model):
        """The incremental-decode anchor must hold under per-step
        conditioning too — everything in inference rests on it."""
        cfg, model, params = per_step_model
        from musicstyletransfer_tpu.models.vae import VAEDecoder

        B, L = 3, 6
        rng = np.random.default_rng(1)
        tokens = np.concatenate(
            [np.full((B, 1), 1), rng.integers(3, 10, (B, L))], axis=1
        ).astype(np.int32)
        seq_lens = jnp.full((B,), L + 1, jnp.int32)
        classes = jnp.asarray(rng.integers(0, 3, (B,)), jnp.int32)
        z = jnp.asarray(rng.normal(size=(B, 8)), jnp.float32)

        dec = VAEDecoder(config=cfg.decoder_config, dtype=jnp.float32)
        dp = params["decoder"]
        batched = dec(dp, jnp.asarray(tokens), seq_lens, z, classes)
        cache = dec.prefill(dp, z, classes, L + 2)
        for t in range(1, L + 2):
            logits_t, cache = dec.step_token(
                dp, jnp.asarray(tokens[:, t - 1]), cache, jnp.asarray(t),
                classes)
            np.testing.assert_allclose(
                np.asarray(logits_t),
                np.asarray(batched[:, t - 1]),
                rtol=2e-4,
                atol=2e-4,
                err_msg=f"mismatch at step {t}",
            )

    def test_bias_applied_beyond_position_zero(self, per_step_model):
        """Same params, same z: per_step logits must differ from the
        initial-mode decoder at LATE positions even when the class signal
        at position 0 is removed from the comparison — i.e. the bias really
        lands on every input, not just the conditioning state."""
        cfg, model, params = per_step_model
        from musicstyletransfer_tpu.models.vae import VAEDecoder

        B, L = 2, 6
        tokens = jnp.ones((B, L + 1), jnp.int32) * 3
        seq_lens = jnp.full((B,), L + 1, jnp.int32)
        z = jnp.zeros((B, 8), jnp.float32)
        dp = params["decoder"]

        dec_ps = VAEDecoder(config=cfg.decoder_config, dtype=jnp.float32)
        dec_init = VAEDecoder(
            config=cfg.decoder_config.copy(class_conditioning="initial"),
            dtype=jnp.float32,
        )
        classes = jnp.ones((B,), jnp.int32)
        out_ps = dec_ps(dp, tokens, seq_lens, z, classes)
        out_init = dec_init(dp, tokens, seq_lens, z, classes)
        # identical parameter tree (checkpoint compatibility), different math
        assert not np.allclose(np.asarray(out_ps), np.asarray(out_init))

    def test_sampling_loop_threads_classes(self, per_step_model):
        """decode_sampled under per_step: runs, and the target class changes
        the generated distribution (classes reach every step)."""
        from musicstyletransfer_tpu.inference.decode import sample_sequences

        cfg, model, params = per_step_model
        B, L = 2, 6
        tokens = jnp.ones((B, L + 1), jnp.int32) * 4
        seq_lens = jnp.full((B,), L, jnp.int32)
        seqs0, _ = sample_sequences(
            model, params, tokens, seq_lens, jnp.zeros((B,), jnp.int32),
            max_len=8, rng=jax.random.key(7),
        )
        seqs1, _ = sample_sequences(
            model, params, tokens, seq_lens, jnp.ones((B,), jnp.int32),
            max_len=8, rng=jax.random.key(7),
        )
        assert seqs0.shape == (B, 8) and seqs1.shape == (B, 8)
        # Greedy decode differs by class (random init net: logit argmaxes
        # shift with a full-position bias; same key isolates the class).
        g0, _ = sample_sequences(
            model, params, tokens, seq_lens, jnp.zeros((B,), jnp.int32),
            max_len=8, rng=jax.random.key(7), greedy=True,
        )
        g1, _ = sample_sequences(
            model, params, tokens, seq_lens, jnp.ones((B,), jnp.int32),
            max_len=8, rng=jax.random.key(7), greedy=True,
        )
        assert not np.array_equal(np.asarray(g0), np.asarray(g1))

    def test_beam_runs(self, per_step_model):
        from musicstyletransfer_tpu.inference.decode import beam_search

        cfg, model, params = per_step_model
        B, L = 2, 6
        tokens = jnp.ones((B, L + 1), jnp.int32) * 4
        seq_lens = jnp.full((B,), L, jnp.int32)
        seqs, scores = beam_search(
            model, params, tokens, seq_lens, jnp.ones((B,), jnp.int32),
            max_len=8, beam_size=2,
        )
        assert seqs.shape == (B, 8) and scores.shape == (B,)

    def test_lstm_rejects_per_step(self):
        from musicstyletransfer_tpu.models import LSTMConfig

        cfg = tiny_config()
        cfg = cfg.copy(
            decoder_config=cfg.decoder_config.copy(
                decoder_type="lstm",
                lstm_config=LSTMConfig(n_layers=1, hidden_dim=16),
                class_conditioning="per_step",
            )
        )
        model = make_model(cfg)
        with pytest.raises(ValueError, match="per_step"):
            init_params(model, jax.random.key(0), max_seq_len=6)

    def test_yaml_round_trip(self, tmp_path, per_step_model):
        cfg, _, _ = per_step_model
        p = str(tmp_path / "config")
        cfg.save(p)
        loaded = Config.load(p)
        assert loaded.decoder_config.class_conditioning == "per_step"
        assert loaded == cfg


class TestConfigYaml:
    def test_round_trip(self, tmp_path):
        cfg = tiny_config()
        p = str(tmp_path / "config")
        cfg.save(p)
        loaded = Config.load(p)
        assert isinstance(loaded, ModelConfig)
        assert loaded == cfg
        assert loaded.encoder_config.transformer_config.model_size == 16

    def test_backward_compatible_defaults(self, tmp_path):
        # A config file missing newer fields loads with defaults, and keys
        # of removed options (the attention-kernel switches of older
        # versions) are ignored (reference: config.py:105-115).
        p = str(tmp_path / "config")
        with open(p, "w") as fh:
            fh.write('{"__type__": "TransformerConfig", "model_size": 64, '
                     '"num_layers": 3, "use_flash_attention": true, '
                     '"flash_min_seq_len": 1024, '
                     '"attention_core_min_seq_len": 256, '
                     '"attention_core_xla_backward": false}')
        loaded = Config.load(p)
        assert loaded.model_size == 64
        assert loaded.num_layers == 3
        assert loaded.num_heads == 8  # default filled in
        assert not hasattr(loaded, "use_flash_attention")


class TestRemat:
    def test_remat_matches_plain(self):
        """config.remat must not change values or gradients."""
        import dataclasses

        from musicstyletransfer_tpu.training import (
            LossConfig, OptimizerConfig, build_optimizer, create_train_state,
            make_train_step,
        )
        from musicstyletransfer_tpu.data import ToyData

        base = tiny_config(vocab=10, classes=3, latent=8, size=16, heads=2,
                           layers=2)
        tc_r = dataclasses.replace(
            base.encoder_config.transformer_config, remat=True
        )
        cfg_r = dataclasses.replace(
            base,
            encoder_config=dataclasses.replace(
                base.encoder_config, transformer_config=tc_r
            ),
            decoder_config=dataclasses.replace(
                base.decoder_config, transformer_config=tc_r
            ),
        )
        m0, m1 = make_model(base), make_model(cfg_r)
        params = init_params(m0, jax.random.key(0), max_seq_len=4)
        tx = build_optimizer(OptimizerConfig("adam", "", 1e-3))
        batch = next(iter(ToyData()))
        args = tuple(jnp.asarray(a) for a in
                     (batch.tokens, batch.seq_lens, batch.classes, batch.labels))

        s0 = create_train_state(params, tx, jax.random.key(5))
        s1 = create_train_state(params, tx, jax.random.key(5))
        st0 = make_train_step(m0, tx, LossConfig())
        st1 = make_train_step(m1, tx, LossConfig())
        s0, a0 = st0(s0, None, *args)
        s1, a1 = st1(s1, None, *args)
        s0, b0 = st0(s0, None, *args)
        s1, b1 = st1(s1, None, *args)
        # Step-2 loss reflects step-1's update: agreement proves remat
        # changed neither values nor gradients beyond fp reassociation.
        np.testing.assert_allclose(
            float(a0["total_loss"][0]), float(a1["total_loss"][0]), rtol=1e-6
        )
        np.testing.assert_allclose(
            float(b0["total_loss"][0]), float(b1["total_loss"][0]), rtol=1e-5
        )
        # adam amplifies fp-reassociation noise on near-zero grads up to
        # ~n_steps*lr; bound params by that envelope.
        for x, y in zip(jax.tree.leaves(s0.params), jax.tree.leaves(s1.params)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=4.5e-3)


class TestOneHotEmbedding:
    def test_onehot_lookup_exact_vs_gather(self):
        """The embedding lookup (a gather) must equal the one-hot matmul
        formulation of the same lookup bit-exactly: each output row is the
        table row times 1.0 with f32 accumulation. The table gradients must
        agree too (the gather's scatter-add vs one_hot^T @ g)."""
        from musicstyletransfer_tpu.models import layers

        params = layers.embed_params(jax.random.key(0), 293, 128)
        tokens = jax.random.randint(jax.random.key(1), (4, 37), 0, 293)

        def via_onehot(p, t):
            oh = jax.nn.one_hot(t, 293, dtype=jnp.float32)
            return jnp.dot(oh, p["embedding"],
                           precision=jax.lax.Precision.HIGHEST)

        def via_gather(p, t):
            return layers.embed(p, t, jnp.float32)

        got = jax.jit(via_onehot)(params, tokens)
        want = jax.jit(via_gather)(params, tokens)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

        def loss(fn):
            def f(p):
                out = fn(p, tokens)
                return jnp.sum(out * jnp.arange(out.size).reshape(out.shape))
            return jax.grad(f)(params)

        g0 = jax.tree.leaves(loss(via_onehot))[0]
        g1 = jax.tree.leaves(loss(via_gather))[0]
        np.testing.assert_allclose(np.asarray(g0), np.asarray(g1),
                                   rtol=1e-6, atol=1e-4)
