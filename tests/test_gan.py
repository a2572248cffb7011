"""Class-conditional sequence GAN: model, losses, trainer, CLI.

The GAN family reconstructs the reference's absent GAN module from its
launch script's flag surface (reference scripts/train.sh:5-23) and the
GAN-leftover BCE (reference loss.py:27-80) — see models/gan.py. These tests
pin: shapes/dtypes, soft-vs-hard rollout parameter sharing, gradient flow
through the soft relaxation, the D/G alternation, checkpoint save/resume,
and MIDI sample output.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.models.gan import (
    DiscriminatorConfig,
    GANConfig,
    GeneratorConfig,
    generate_tokens,
    init_gan_params,
    make_discriminator,
    make_generator,
)
from musicstyletransfer_tpu.training.gan_trainer import (
    GANTrainConfig,
    GANTrainer,
    make_gan_steps,
)


def tiny_config(L=8, V=12, C=3) -> GANConfig:
    return GANConfig(
        generator_config=GeneratorConfig(
            n_layers=2, hidden_dim=16, emb_dim=8, noise_dim=4,
            num_classes=C, output_dim=V, max_seq_len=L,
        ),
        discriminator_config=DiscriminatorConfig(
            n_layers=1, hidden_dim=16, emb_dim=8, num_classes=C, input_dim=V,
        ),
        dtype="float32",
    )


class TestGANModel:
    def test_generator_shapes(self):
        cfg = tiny_config()
        gen = make_generator(cfg)
        g_params, _ = init_gan_params(cfg, jax.random.key(0))
        B, L, V = 5, 8, 12
        noise = jax.random.normal(jax.random.key(1), (B, L, 4))
        classes = jnp.asarray([0, 1, 2, 0, 1])
        logits, tokens = gen(g_params, noise, classes, jax.random.key(2), hard=False)
        assert logits.shape == (B, L, V)
        assert logits.dtype == jnp.float32
        assert tokens.shape == (B, L)
        assert int(tokens.min()) >= 0 and int(tokens.max()) < V

    def test_soft_and_hard_share_params(self):
        """One parameter set must serve both rollout modes."""
        cfg = tiny_config()
        gen = make_generator(cfg)
        g_params, _ = init_gan_params(cfg, jax.random.key(0))
        noise = jax.random.normal(jax.random.key(1), (2, 8, 4))
        classes = jnp.zeros((2,), jnp.int32)
        # hard mode applies with the SAME params tree: structure must match.
        logits_h, tokens_h = gen(g_params, noise, classes, jax.random.key(2), hard=True)
        assert logits_h.shape == (2, 8, 12)
        # First-step logits agree between modes (divergence only enters via
        # the fed-back embedding from step 2 on).
        logits_s, _ = gen(g_params, noise, classes, jax.random.key(2), hard=False)
        np.testing.assert_allclose(
            np.asarray(logits_h[:, 0]), np.asarray(logits_s[:, 0]),
            rtol=1e-5, atol=1e-5,
        )

    def test_class_conditioning_changes_output(self):
        cfg = tiny_config()
        gen = make_generator(cfg)
        g_params, _ = init_gan_params(cfg, jax.random.key(0))
        noise = jax.random.normal(jax.random.key(1), (1, 8, 4))
        la, _ = gen(g_params, noise, jnp.asarray([0]), jax.random.key(2))
        lb, _ = gen(g_params, noise, jnp.asarray([1]), jax.random.key(2))
        assert not np.allclose(np.asarray(la), np.asarray(lb))

    def test_discriminator_projection_off(self):
        """projection=False falls back to input-additive conditioning only
        (fewer params, same output surface)."""
        import dataclasses as dc

        cfg = tiny_config()
        cfg = dc.replace(
            cfg,
            discriminator_config=dc.replace(
                cfg.discriminator_config, projection=False
            ),
        )
        disc = make_discriminator(cfg)
        dists = jnp.zeros((2, 8, 12), jnp.float32)
        classes = jnp.zeros((2,), jnp.int32)
        params = disc.init(jax.random.key(0))
        assert "class_proj" not in params
        out = disc(params, dists, classes)
        assert out.shape == (2, 8)

    def test_discriminator_shapes_and_grad_flow(self):
        cfg = tiny_config()
        gen, disc = make_generator(cfg), make_discriminator(cfg)
        g_params, d_params = init_gan_params(cfg, jax.random.key(0))
        B, L = 4, 8
        classes = jnp.zeros((B,), jnp.int32)

        def g_loss(gp):
            noise = jax.random.normal(jax.random.key(1), (B, L, 4))
            logits, _ = gen(gp, noise, classes, jax.random.key(2), hard=False)
            pred = disc(d_params, jax.nn.softmax(logits), classes)
            assert pred.shape == (B, L)
            return -jnp.mean(pred)

        grads = jax.grad(g_loss)(g_params)
        norms = [float(jnp.linalg.norm(g)) for g in jax.tree.leaves(grads)]
        # The soft relaxation must carry gradient into EVERY generator
        # parameter (embedding included — that is the point of soft feeding).
        assert all(n > 0 for n in norms), norms

    def test_generate_tokens_deterministic_per_key(self):
        cfg = tiny_config()
        gen = make_generator(cfg)
        g_params, _ = init_gan_params(cfg, jax.random.key(0))
        classes = jnp.asarray([0, 1])
        a = generate_tokens(gen, g_params, classes, jax.random.key(3))
        b = generate_tokens(gen, g_params, classes, jax.random.key(3))
        c = generate_tokens(gen, g_params, classes, jax.random.key(4))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert not np.array_equal(np.asarray(a), np.asarray(c))

    def test_config_yaml_roundtrip(self, tmp_path):
        cfg = tiny_config()
        p = str(tmp_path / "config")
        cfg.save(p)
        loaded = GANConfig.load(p)
        assert loaded == cfg


class TestGANSteps:
    def _states(self, cfg, tc):
        from musicstyletransfer_tpu.training import create_train_state

        d_step, g_step, g_tx, d_tx = make_gan_steps(cfg, tc)
        g_params, d_params = init_gan_params(cfg, jax.random.key(0))
        g_state = create_train_state(g_params, g_tx, jax.random.key(1))
        d_state = create_train_state(d_params, d_tx, jax.random.key(2))
        return d_step, g_step, g_state, d_state

    def test_d_step_updates_only_discriminator(self):
        cfg = tiny_config()
        tc = GANTrainConfig(d_learning_rate=1e-3, g_learning_rate=1e-3)
        d_step, g_step, g_state, d_state = self._states(cfg, tc)
        tokens = jnp.asarray(
            np.random.default_rng(0).integers(3, 12, (4, 8)), jnp.int32
        )
        classes = jnp.zeros((4,), jnp.int32)
        d_before = jax.tree.map(lambda x: np.asarray(x), d_state.params)
        new_d, acc = d_step(d_state, {}, g_state.params, tokens, classes)
        assert int(new_d.step) == 1
        changed = any(
            not np.array_equal(a, np.asarray(b))
            for a, b in zip(jax.tree.leaves(d_before),
                            jax.tree.leaves(new_d.params))
        )
        assert changed
        assert float(acc["d_loss"][0]) > 0
        for k in ("d_loss", "d_acc_real", "d_acc_fake"):
            assert np.isfinite(float(acc[k][0]))

    def test_g_step_updates_generator(self):
        cfg = tiny_config()
        tc = GANTrainConfig(g_learning_rate=1e-3)
        d_step, g_step, g_state, d_state = self._states(cfg, tc)
        classes = jnp.zeros((4,), jnp.int32)
        g_before = jax.tree.map(lambda x: np.asarray(x), g_state.params)
        new_g, acc = g_step(g_state, {}, d_state.params, classes)
        changed = any(
            not np.array_equal(a, np.asarray(b))
            for a, b in zip(jax.tree.leaves(g_before),
                            jax.tree.leaves(new_g.params))
        )
        assert changed
        assert np.isfinite(float(acc["g_loss"][0]))

    def test_discriminator_learns_separable_data(self):
        """A few D steps on fixed real data must beat chance vs an untrained
        generator (real sequences are constant; fake are random-ish)."""
        cfg = tiny_config()
        # r1_gamma=0: this test pins the raw BCE D-learning mechanism; the
        # shipped default (0.1, round 4) deliberately damps D and is pinned
        # separately by test_r1_penalty_positive_and_regularizing.
        tc = GANTrainConfig(d_learning_rate=5e-3, r1_gamma=0.0)
        d_step, g_step, g_state, d_state = self._states(cfg, tc)
        tokens = jnp.tile(jnp.arange(3, 11, dtype=jnp.int32)[None, :], (8, 1))
        classes = jnp.zeros((8,), jnp.int32)
        acc = {}
        for _ in range(30):
            d_state, acc = d_step(d_state, acc, g_state.params, tokens, classes)
        # accuracy over the last accumulation window
        acc_real = float(acc["d_acc_real"][0]) / float(acc["d_acc_real"][1])
        acc_fake = float(acc["d_acc_fake"][0]) / float(acc["d_acc_fake"][1])
        assert (acc_real + acc_fake) / 2 > 0.7, (acc_real, acc_fake)

    def test_r1_default_is_on(self):
        """Round-4 shipped default: r1_gamma=0.1 (the unregularized run
        measurably self-destructs); the parity
        surface is restored via cli/gan.py's --parity-gan."""
        assert GANTrainConfig().r1_gamma == 0.1
        from musicstyletransfer_tpu.cli.gan import (
            create_gan_train_config, get_gan_config,
        )

        assert create_gan_train_config(get_gan_config([])).r1_gamma == 0.1
        assert create_gan_train_config(
            get_gan_config(["--parity-gan"])
        ).r1_gamma == 0.0

    def test_r1_penalty_positive_and_regularizing(self):
        """r1_gamma > 0 must (a) report a positive d_r1 metric, (b) raise
        the total D loss by exactly gamma/2 * r1 relative to the
        unregularized step on identical inputs, and (c) keep the metric
        key present-but-zero when off (constant accumulator structure)."""
        cfg = tiny_config()
        tokens = jnp.asarray(
            np.random.default_rng(0).integers(3, 12, (4, 8)), jnp.int32
        )
        classes = jnp.zeros((4,), jnp.int32)

        def one_step(gamma):
            tc = GANTrainConfig(r1_gamma=gamma)
            d_step, _, g_state, d_state = self._states(cfg, tc)
            _, acc = d_step(d_state, {}, g_state.params, tokens, classes)
            return (float(acc["d_loss"][0]), float(acc["d_r1"][0]))

        loss_off, r1_off = one_step(0.0)
        loss_on, r1_on = one_step(10.0)
        assert r1_off == 0.0
        assert r1_on > 0.0
        # Same params/keys/inputs: the only loss difference is the penalty.
        assert abs((loss_on - loss_off) - 0.5 * 10.0 * r1_on) < 1e-4 * max(
            1.0, loss_on
        )

    def test_label_smoothing_and_downweighting_run(self):
        cfg = tiny_config()
        tc = GANTrainConfig(label_smoothing=0.1,
                            negative_label_downweighting=True)
        d_step, g_step, g_state, d_state = self._states(cfg, tc)
        tokens = jnp.asarray(
            np.random.default_rng(0).integers(3, 12, (4, 8)), jnp.int32
        )
        classes = jnp.zeros((4,), jnp.int32)
        _, acc = d_step(d_state, {}, g_state.params, tokens, classes)
        # Balanced real:fake concatenation keeps the downweighted loss live.
        assert float(acc["d_loss"][0]) > 0


class TestGANSharding:
    def test_dp_mesh_matches_single_device(self):
        """Data-parallel GAN steps on an 8-device mesh must reproduce the
        single-device result (same keys -> same noise; psum order only
        perturbs float reduction)."""
        from musicstyletransfer_tpu.parallel import make_mesh
        from musicstyletransfer_tpu.training import create_train_state
        from musicstyletransfer_tpu.training.train_step import (
            shard_train_state,
        )

        cfg = tiny_config()
        tc = GANTrainConfig(d_learning_rate=1e-3, g_learning_rate=1e-3)
        tokens = jnp.asarray(
            np.random.default_rng(0).integers(3, 12, (8, 8)), jnp.int32
        )
        classes = jnp.asarray(np.arange(8) % 3, jnp.int32)

        def run(mesh):
            d_step, g_step, g_tx, d_tx = make_gan_steps(cfg, tc, mesh=mesh)
            g_params, d_params = init_gan_params(cfg, jax.random.key(0))
            g_state = create_train_state(g_params, g_tx, jax.random.key(1))
            d_state = create_train_state(d_params, d_tx, jax.random.key(2))
            if mesh is not None:
                g_state = shard_train_state(g_state, mesh)
                d_state = shard_train_state(d_state, mesh)
            acc = {}
            for _ in range(2):
                d_state, acc = d_step(d_state, acc, g_state.params,
                                      tokens, classes)
            g_state, acc = g_step(g_state, acc, d_state.params, classes)
            return d_state, g_state, {
                k: float(s) / float(c) for k, (s, c) in acc.items()
            }

        d_ref, g_ref, m_ref = run(None)
        mesh = make_mesh(jax.devices("cpu")[:8], tp=1)
        d_mesh, g_mesh, m_mesh = run(mesh)
        for k in m_ref:
            assert m_mesh[k] == pytest.approx(m_ref[k], rel=1e-4), k
        for a, b in zip(jax.tree.leaves(d_ref.params),
                        jax.tree.leaves(d_mesh.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)
        for a, b in zip(jax.tree.leaves(g_ref.params),
                        jax.tree.leaves(g_mesh.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)


class TestGANTrainer:
    def test_fit_toy_and_resume(self, tmp_path):
        from musicstyletransfer_tpu.data import ToyData

        cfg = tiny_config(L=4, V=10, C=3)
        tc = GANTrainConfig(
            discriminator_update_steps=2, checkpoint_frequency=0,
            sampling_frequency=0, log_every=5, num_samples=2,
        )
        trainer = GANTrainer(cfg, tc)
        folder = str(tmp_path / "gan")
        metrics = trainer.fit(ToyData(), folder, epochs=6)
        assert np.isfinite(metrics["d_loss"])
        assert "g_loss" in metrics
        assert os.path.exists(os.path.join(folder, "config"))
        assert os.path.isdir(os.path.join(folder, "generator", "params.1"))
        assert os.path.isdir(os.path.join(folder, "discriminator", "params.1"))

        # Resume: a fresh trainer picks up the checkpoint and keeps stepping.
        trainer2 = GANTrainer(cfg, tc)
        trainer2.fit(ToyData(), folder, epochs=1)
        assert int(trainer2.g_state.step) > int(6 // 2)  # continued, not reset

        # Generate-only CLI mode: load the checkpoint, write N MIDIs/class.
        from musicstyletransfer_tpu.cli.gan import generate_only, get_gan_config

        out = str(tmp_path / "gen-only")
        args = get_gan_config([
            "--model-output", folder, "--generate", "2",
            "--out-samples", out, "--dtype", "float32",
        ])
        generate_only(args)
        wrote = sorted(os.listdir(out))
        assert len(wrote) == 2 * cfg.generator_config.num_classes

    def test_sample_to_midi(self, tmp_path):
        from musicstyletransfer_tpu.midi.codec import EventBasedMIDIReader

        cfg = tiny_config(L=16, V=293, C=2)
        tc = GANTrainConfig(num_samples=2)
        trainer = GANTrainer(cfg, tc)
        g_params, _ = init_gan_params(cfg, jax.random.key(0))
        out = str(tmp_path / "samples")
        paths = trainer.sample_to_midi(g_params, out)
        assert len(paths) == 4  # 2 samples x 2 classes
        names = sorted(os.path.basename(p) for p in paths)
        assert names[0] == "gan-out-0.class-0.mid"
        # Every written file must parse back through the tokenizer (they may
        # legitimately be short; an unparseable file would raise).
        from musicstyletransfer_tpu.midi import smf

        for p in paths:
            smf.read_midifile(p)


class TestGANQuality:
    def test_class_conditional_stats_detects_conditioning(self):
        """Own-class JS must beat other-class JS exactly when generated
        samples match their own class's pitch profile."""
        from musicstyletransfer_tpu.inference.quality import (
            class_conditional_stats,
        )
        from musicstyletransfer_tpu.midi.vocab import note_on_id

        c0 = [np.array([note_on_id(60 + i % 4) for i in range(20)])]
        c1 = [np.array([note_on_id(66 + i % 4) for i in range(20)])]
        corpus = {0: c0, 1: c1}

        conditioned = class_conditional_stats({0: c0, 1: c1}, corpus)
        assert (conditioned["gen_pitch_js_to_own_class"]
                < conditioned["gen_pitch_js_to_other_classes"])
        assert conditioned["gen_note_on_fraction"] == pytest.approx(1.0)
        assert conditioned["gen_mean_len"] == pytest.approx(20.0)

        swapped = class_conditional_stats({0: c1, 1: c0}, corpus)
        assert (swapped["gen_pitch_js_to_own_class"]
                > swapped["gen_pitch_js_to_other_classes"])

    def test_octave_stats_detect_register_conditioning(self):
        """Classes separated by REGISTER only (same pitch classes, like the
        bundled guitar/bass corpus) are invisible to pitch-class JS and
        must be caught by the octave histogram."""
        from musicstyletransfer_tpu.inference.quality import (
            class_conditional_stats,
        )
        from musicstyletransfer_tpu.midi.vocab import note_on_id

        low = [np.array([note_on_id(24 + i % 4) for i in range(20)])]
        high = [np.array([note_on_id(60 + i % 4) for i in range(20)])]
        corpus = {0: low, 1: high}

        conditioned = class_conditional_stats({0: low, 1: high}, corpus)
        # Pitch-class profiles are identical -> no separation there...
        assert conditioned["gen_pitch_js_to_own_class"] == pytest.approx(
            conditioned["gen_pitch_js_to_other_classes"], abs=1e-9
        )
        # ...but the octave metric separates cleanly.
        assert (conditioned["gen_octave_js_to_own_class"] + 0.1
                < conditioned["gen_octave_js_to_other_classes"])

        swapped = class_conditional_stats({0: high, 1: low}, corpus)
        assert (swapped["gen_octave_js_to_own_class"]
                > swapped["gen_octave_js_to_other_classes"] + 0.1)


class TestGANCLI:
    def test_toy_cli_runs(self, tmp_path, capsys):
        from musicstyletransfer_tpu.cli.gan import main, main_toy, get_gan_config

        args = get_gan_config([
            "--toy", "--cpu", "--dtype", "float32",
            "--sampling-frequency", "0", "--checkpoint-frequency", "0",
        ])
        main_toy(args, epochs=4)
        out = capsys.readouterr().out
        assert "d_loss" in out

    def test_flag_surface_matches_reference_train_sh(self):
        """Every flag the reference's scripts/train.sh passes must parse."""
        from musicstyletransfer_tpu.cli.gan import get_gan_config

        args = get_gan_config([
            "--batch-size", "32", "--out-samples", "/tmp/out",
            "--max-seq-len", "64", "--slices-per-quarter-note", "4",
            "--data", "work/data/guitar_bass", "--sampling-frequency", "50",
            "--epochs", "10000", "--discriminator-update-steps", "5",
            "--model-output", "test/", "--g-learning-rate", "0.00005",
            "--g-n-layers", "1", "--g-rnn-hidden-dim", "256",
            "--g-emb-hidden-dim", "256", "--noise-dim", "64",
            "--d-learning-rate", "0.00005", "--d-n-layers", "1",
            "--d-rnn-hidden-dim", "256", "--d-emb-hidden-dim", "256",
            "--gpu", "--toy",
        ])
        assert args.discriminator_update_steps == 5
        assert args.noise_dim == 64
        assert args.g_learning_rate == pytest.approx(5e-5)
        assert args.toy
