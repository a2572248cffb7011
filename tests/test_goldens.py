"""The models against outputs recorded from the previous (flax.linen)
implementation of the same architecture, before the pure-JAX rewrite.

``tests/goldens/`` holds, for a fixed batch of corpus rows (both classes,
short and full-length rows):

- ``vae_guitar_bass.npz``: teacher-forced logits, mu and logvar of the
  shipped ``models/guitar_bass`` checkpoint, in float32 at "highest"
  matmul precision and in the shipped bfloat16;
- ``gan_guitar_bass.npz``: soft-rollout generator logits of the shipped
  ``models/gan_guitar_bass`` generator for fixed noise and key, the hard
  rollout's tokens, and a fixed random-init discriminator (its parameters
  stored in the file) on one-hot corpus rows;
- ``random_init_{transformer,lstm}.npz``: parameters of a fixed random
  init plus their forward outputs, for a pre-LN per-step-conditioned
  transformer VAE and an LSTM-decoder VAE.

Matching them pins the parameter tree paths (checkpoints load), the layer
math (dense, embedding, layer norm, LSTM cell, attention, positional
table) and the dtype conventions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.models import (
    DecoderConfig,
    DiscriminatorConfig,
    EncoderConfig,
    LSTMConfig,
    ModelConfig,
    TransformerConfig,
    make_discriminator,
    make_generator,
    make_model,
)
from musicstyletransfer_tpu.models.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")

# Tolerances. float32 at "highest" precision differs from the recording
# only by summation order (attention now takes its softmax through
# jax.nn.dot_product_attention): 1e-4 on logits of magnitude ~10.
F32_ATOL, F32_RTOL = 2e-4, 1e-4
# bfloat16 keeps 8 mantissa bits, so a bf16 forward sits ~1e-2 from the
# float32 one and any reordering moves it by as much. The bound is
# relative to the recording instead: against the float32 truth, the bf16
# path may be at most 25% less accurate (max and mean error) than the
# recorded bf16 path was.
BF16_SLACK = 1.25


def _load(name):
    with np.load(os.path.join(GOLDENS, name)) as f:
        return {k: f[k] for k in f.files}


def _unflatten(flat, prefix):
    tree = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def _paths(tree):
    return sorted("/".join(str(k.key) for k in p)
                  for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0])


def _forward(model, params, g):
    fn = jax.jit(lambda p, t, s, c: model(p, t, s, c))
    return fn(params, jnp.asarray(g["tokens"]), jnp.asarray(g["seq_lens"]),
              jnp.asarray(g["classes"]))


def _bf16_close(got, recorded_bf16, truth_f32):
    err = np.abs(np.asarray(got, np.float32) - truth_f32)
    ref = np.abs(recorded_bf16 - truth_f32)
    assert err.max() <= BF16_SLACK * ref.max(), (err.max(), ref.max())
    assert err.mean() <= BF16_SLACK * ref.mean(), (err.mean(), ref.mean())


@pytest.fixture(scope="module")
def shipped_vae():
    from musicstyletransfer_tpu.inference.sampler import load_inference_model

    return load_inference_model(os.path.join(REPO, "models", "guitar_bass"),
                                checkpoint=-1)


@pytest.fixture(scope="module")
def shipped_gan():
    from musicstyletransfer_tpu.models.gan import init_gan_params
    from musicstyletransfer_tpu.training import (
        get_latest_checkpoint_index, restore_params,
    )

    folder = os.path.join(REPO, "models", "gan_guitar_bass")
    config = Config.load(os.path.join(folder, "config"))
    gen_folder = os.path.join(folder, "generator")
    template, _ = init_gan_params(config, jax.random.key(0))
    params = restore_params(gen_folder, get_latest_checkpoint_index(gen_folder),
                            template)
    return config, jax.device_put(params)


class TestShippedVAE:
    def test_f32_highest_matches_recording(self, shipped_vae):
        model, params = shipped_vae
        g = _load("vae_guitar_bass.npz")
        m32 = make_model(model.config.copy(dtype="float32"))
        with jax.default_matmul_precision("highest"):
            logits, mu, logvar = _forward(m32, params, g)
        np.testing.assert_allclose(logits, g["logits_f32"], atol=F32_ATOL,
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(mu, g["mu_f32"], atol=F32_ATOL,
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(logvar, g["logvar_f32"], atol=F32_ATOL,
                                   rtol=F32_RTOL)

    def test_bf16_matches_recording(self, shipped_vae):
        model, params = shipped_vae
        g = _load("vae_guitar_bass.npz")
        logits, mu, _ = _forward(model, params, g)
        _bf16_close(logits, g["logits_bf16"], g["logits_f32"])
        _bf16_close(mu, g["mu_bf16"], g["mu_f32"])


class TestShippedGAN:
    def _noise(self, g):
        return (jnp.asarray(g["noise"]), jnp.asarray(g["classes"]),
                jax.random.wrap_key_data(jnp.asarray(g["roll_key"])))

    def test_generator_f32_matches_recording(self, shipped_gan):
        config, params = shipped_gan
        g = _load("gan_guitar_bass.npz")
        gen = make_generator(config.copy(dtype="float32"))
        with jax.default_matmul_precision("highest"):
            logits, _ = jax.jit(gen)(params, *self._noise(g))
        np.testing.assert_allclose(logits, g["gen_logits_f32"],
                                   atol=F32_ATOL, rtol=F32_RTOL)

    def test_generator_bf16_matches_recording(self, shipped_gan):
        config, params = shipped_gan
        g = _load("gan_guitar_bass.npz")
        logits, _ = jax.jit(make_generator(config))(params, *self._noise(g))
        _bf16_close(logits, g["gen_logits_bf16"], g["gen_logits_f32"])

    def test_hard_rollout_tokens_match_recording(self, shipped_gan):
        """Same key, same bf16 math: the sampled tokens agree except where
        a bf16 rounding difference flips a categorical draw (rare)."""
        config, params = shipped_gan
        g = _load("gan_guitar_bass.npz")
        gen = make_generator(config)
        _, tokens = jax.jit(lambda p, n, c, k: gen(p, n, c, k, hard=True))(
            params, *self._noise(g))
        agree = np.mean(np.asarray(tokens) == g["hard_tokens_bf16"])
        assert agree > 0.9, agree

    @pytest.mark.parametrize("dtype,tag", [("float32", "f32"),
                                           ("bfloat16", "bf16")])
    def test_discriminator_matches_recording(self, shipped_gan, dtype, tag):
        config, _ = shipped_gan
        g = _load("gan_guitar_bass.npz")
        small = DiscriminatorConfig(emb_dim=32, hidden_dim=24, n_layers=2)
        disc = make_discriminator(
            config.copy(discriminator_config=small, dtype=dtype))
        params = _unflatten(g, "disc/")
        assert _paths(params) == _paths(jax.eval_shape(disc.init,
                                                       jax.random.key(0)))
        onehot = jax.nn.one_hot(g["disc_tokens"], 293, dtype=jnp.float32)
        prec = "highest" if tag == "f32" else "default"
        with jax.default_matmul_precision(prec):
            out = jax.jit(disc)(params, onehot, jnp.asarray(g["disc_classes"]))
        if tag == "f32":
            np.testing.assert_allclose(out, g["disc_logits_f32"],
                                       atol=F32_ATOL, rtol=F32_RTOL)
        else:
            _bf16_close(out, g["disc_logits_bf16"], g["disc_logits_f32"])


def _random_init_config(decoder_type):
    tc = TransformerConfig(model_size=32, num_heads=4, num_layers=2,
                           dropout=0.1, norm_scheme="pre", vocab_size=293,
                           ffn_multiplier=2)
    lstm = decoder_type == "lstm"
    dc = DecoderConfig(
        transformer_config=tc, latent_dim=16, output_dim=293,
        decoder_type=decoder_type,
        lstm_config=LSTMConfig(n_layers=2, hidden_dim=24) if lstm else None,
        class_conditioning="initial" if lstm else "per_step")
    ec = EncoderConfig(transformer_config=tc, latent_dim=16, input_dim=293)
    return ModelConfig(encoder_config=ec, decoder_config=dc, dtype="float32")


@pytest.mark.parametrize("decoder_type", ["transformer", "lstm"])
def test_random_init_matches_recording(decoder_type):
    g = _load(f"random_init_{decoder_type}.npz")
    model = make_model(_random_init_config(decoder_type))
    params = _unflatten(g, "params/")
    # Same tree paths and shapes as this implementation's own init.
    want = jax.eval_shape(model.init, jax.random.key(0))
    assert _paths(params) == _paths(want)
    assert jax.tree.map(jnp.shape, params) == jax.tree.map(
        lambda s: s.shape, want)
    with jax.default_matmul_precision("highest"):
        logits, mu, logvar = _forward(model, params, g)
    for got, key in ((logits, "logits"), (mu, "mu"), (logvar, "logvar")):
        np.testing.assert_allclose(got, g[key], atol=F32_ATOL, rtol=F32_RTOL)


def test_shipped_vae_tree_matches_init(shipped_vae):
    """The converted checkpoint's parameter paths are exactly the ones the
    model initializes (the tensor-parallel rules match on them)."""
    model, params = shipped_vae
    assert _paths(params) == _paths(jax.eval_shape(model.init,
                                                   jax.random.key(0)))
