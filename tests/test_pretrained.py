"""The shipped pretrained checkpoint (models/guitar_bass) must stay loadable
and usable: config parses, params restore cleanly, decoding terminates with
EOS, and output writes as MIDI.

A config or checkpoint-layout drift would otherwise ship silently."""

import os
import warnings

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED = os.path.join(REPO, "models", "guitar_bass")


@pytest.fixture(scope="module")
def pretrained():
    if not os.path.isdir(PRETRAINED):
        pytest.skip("pretrained checkpoint not present")
    from musicstyletransfer_tpu.inference.sampler import load_inference_model

    with warnings.catch_warnings():
        # Restoring must not need an unsafe, targetless deserialization.
        warnings.filterwarnings(
            "error", message=".*[Uu]nsafe.*", category=UserWarning
        )
        model, params = load_inference_model(PRETRAINED, checkpoint=-1)
    return model, params


class TestPretrainedCheckpoint:
    def test_decodes_and_terminates(self, pretrained, corpus_path):
        from musicstyletransfer_tpu.data import Loader, MelodyDataset
        from musicstyletransfer_tpu.inference.decode import sample_sequences
        from musicstyletransfer_tpu.midi.vocab import EOS_ID, NUM_EVENTS, PAD_ID
        import jax
        import jax.numpy as jnp

        model, params = pretrained
        loader = Loader(corpus_path, max_sequence_length=64)
        ds = MelodyDataset(8, 64, loader.melodies, shuffle=False)
        batch = next(iter(ds))
        seqs, _ = sample_sequences(
            model,
            params,
            jnp.asarray(batch.tokens),
            jnp.asarray(batch.seq_lens),
            jnp.asarray(batch.classes),
            max_len=130,
            rng=jax.random.key(0),
        )
        seqs = np.asarray(seqs)
        assert seqs.shape == (8, 130)
        assert np.all(seqs < NUM_EVENTS)
        # A trained (non-collapsed) model ends most sequences with EOS
        # well before the cap.
        n_eos = int(np.sum(np.any(seqs == EOS_ID, axis=1)))
        assert n_eos >= 4, f"only {n_eos}/8 sequences terminated"
        # PAD after EOS, never tokens.
        for row in seqs:
            eos = np.nonzero(row == EOS_ID)[0]
            if len(eos):
                assert np.all(row[eos[0] + 1 :] == PAD_ID)

    def test_content_preservation_bound(self, pretrained, corpus_path):
        """The shipped checkpoint's latent must carry row-specific content,
        not just class style: each transfer's pitch-class profile sits
        measurably closer to ITS OWN source row than to a rotated
        (shuffled-null) source row. Measured on this checkpoint: own 0.209
        vs shuffled 0.274 over 64 transfers."""
        from musicstyletransfer_tpu.data import Loader, MelodyDataset
        from musicstyletransfer_tpu.inference.quality import transfer_stats

        model, params = pretrained
        loader = Loader(corpus_path, max_sequence_length=64)
        # shuffle=True (seeded): batches mix chunks across files, so the
        # rotated-row null is a fair random pairing — unshuffled batches
        # are consecutive chunks of ONE file and bias the null low.
        ds = MelodyDataset(16, 64, loader.melodies, shuffle=True, seed=7)
        stats = transfer_stats(model, params, ds, num_classes=2,
                               max_batches=2, seed=0)
        own = stats["pitch_js_to_own_source"]
        null = stats["pitch_js_to_shuffled_source"]
        assert own < 0.25, f"content preservation degraded: own-source JS {own}"
        assert own < null - 0.02, (
            f"latent no longer row-specific: own {own} vs shuffled null {null}"
        )

    def test_output_writes_as_midi(self, pretrained, corpus_path, tmp_path):
        from musicstyletransfer_tpu.data import Loader, MelodyDataset
        from musicstyletransfer_tpu.inference.decode import sample_sequences
        from musicstyletransfer_tpu.midi.codec import (
            EventBasedMIDIReader,
            MelodyWriter,
            melody_from_ids,
        )
        import jax
        import jax.numpy as jnp

        model, params = pretrained
        loader = Loader(corpus_path, max_sequence_length=64)
        ds = MelodyDataset(4, 64, loader.melodies, shuffle=False)
        batch = next(iter(ds))
        seqs, _ = sample_sequences(
            model,
            params,
            jnp.asarray(batch.tokens),
            jnp.asarray(batch.seq_lens),
            jnp.asarray(batch.classes),
            max_len=130,
            rng=jax.random.key(1),
        )
        wrote = 0
        writer = MelodyWriter()
        for i, row in enumerate(np.asarray(seqs)):
            melody = melody_from_ids(row)
            if not len(melody):
                continue
            path = str(tmp_path / f"gen-{i}.mid")
            writer.write_to_file(path, melody)
            back = EventBasedMIDIReader().read_file(path)
            assert len(back) >= 1
            wrote += 1
        assert wrote >= 1


PRETRAINED_GAN = os.path.join(REPO, "models", "gan_guitar_bass")


class TestPretrainedGAN:
    """The shipped GAN generator (models/gan_guitar_bass — the measured-best
    r1_gamma=0.1 14k-step run) must stay loadable and
    produce corpus-like, class-separated output."""

    @pytest.fixture(scope="class")
    def gan(self):
        if not os.path.isdir(PRETRAINED_GAN):
            pytest.skip("pretrained GAN checkpoint not present")
        import jax

        from musicstyletransfer_tpu.models.gan import (
            GANConfig, init_gan_params, make_generator,
        )
        from musicstyletransfer_tpu.training import (
            get_latest_checkpoint_index, restore_params,
        )

        config = GANConfig.load(os.path.join(PRETRAINED_GAN, "config"))
        gen_folder = os.path.join(PRETRAINED_GAN, "generator")
        idx = get_latest_checkpoint_index(gen_folder)
        assert idx >= 0
        template, _ = init_gan_params(config, jax.random.key(0))
        g_params = restore_params(gen_folder, idx, template)
        return config, make_generator(config), g_params

    def test_generates_dense_noteful_sequences(self, gan):
        import jax
        import jax.numpy as jnp

        from musicstyletransfer_tpu.midi.vocab import (
            NUM_EVENTS, is_note_on,
        )
        from musicstyletransfer_tpu.models.gan import generate_tokens

        config, gen, g_params = gan
        classes = jnp.asarray([0, 0, 1, 1], jnp.int32)
        tokens = np.asarray(generate_tokens(
            gen, g_params, classes, jax.random.key(3)
        ))
        assert tokens.shape == (4, config.generator_config.max_seq_len)
        assert tokens.min() >= 0 and tokens.max() < NUM_EVENTS
        ons = np.mean([is_note_on(int(t)) for t in tokens.ravel()])
        # The gamma=0.1 checkpoint measured note-on fraction 0.333 over 128
        # sequences; a loose floor catches a silently-collapsed restore.
        assert ons > 0.1, ons

    def test_class_conditioning_separates_registers(self, gan, corpus_path):
        """Octave (register) profile of generated class-0 rows must sit
        closer to the guitar corpus than to bass, and vice versa — the
        shipped checkpoint's measured octave JS was own 0.036 / other
        0.310."""
        import jax
        import jax.numpy as jnp

        from musicstyletransfer_tpu.data import Loader
        from musicstyletransfer_tpu.inference.quality import (
            js_divergence, octave_histogram,
        )
        from musicstyletransfer_tpu.models.gan import generate_tokens

        config, gen, g_params = gan
        loader = Loader(corpus_path, max_sequence_length=64)
        corpus = {i: [m.tokens for m in loader.melodies[name]]
                  for i, name in enumerate(sorted(loader.melodies))}
        n = 16
        gen_hist = {}
        for c in range(2):
            classes = jnp.full((n,), c, jnp.int32)
            rows = np.asarray(generate_tokens(
                gen, g_params, classes, jax.random.key(100 + c)
            ))
            gen_hist[c] = octave_histogram(list(rows))
        for c in range(2):
            own = js_divergence(gen_hist[c], octave_histogram(corpus[c]))
            other = js_divergence(gen_hist[c],
                                  octave_histogram(corpus[1 - c]))
            assert own < other, (c, own, other)
