"""Class-conditional sequence VAE (encoder, decoder, model).

Reference: VarAutoEncoder/model.py:57-296. Divergences (per SURVEY.md §7):

- the latent head emits (mu, **logvar**) instead of an unconstrained
  "stddev" (fixes §8.3); sampling uses sigma = exp(0.5 * logvar);
- the decoder is causal in training (fixes §8.5) and returns **logits**
  (the loss applies log-softmax; the reference softmaxes then logs,
  loss.py:19-21);
- incremental decoding uses explicit static-shape KV caches so sampling is
  one jitted on-device loop (replaces DecoderState, model.py:107-128).

Shapes follow the reference data layout: ``tokens`` are SOS-prefixed
[B, L+1]; the decoder prepends a conditioning state built from
``latent2hid(z) + class_emb(class)`` (reference: model.py:229-232) giving
[B, L+2] positions; position 0's output is dropped so predictions align
with labels [B, L+1] (reference: model.py:250-257).

Every module takes its parameter dict as the first argument of each
method; ``StyleVAE.init(key)`` builds the whole tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..midi.vocab import PAD_ID
from . import layers
from .config import DecoderConfig, EncoderConfig, ModelConfig
from .transformer import Cache, TransformerStack


def _dtype(name: str) -> Any:
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


@dataclasses.dataclass(frozen=True)
class VAEEncoder:
    """Token+class embeddings -> transformer -> position-0 state -> (mu, logvar).

    Reference: model.py:57-104 (Encoder).
    """

    config: EncoderConfig
    dtype: Any = jnp.float32

    @property
    def encoder(self) -> TransformerStack:
        return TransformerStack(config=self.config.transformer_config,
                                causal=False, dtype=self.dtype)

    def init(self, key: jax.Array) -> layers.Params:
        c = self.config
        d = c.transformer_config.model_size
        k_tok, k_cls, k_enc, k_lat = jax.random.split(key, 4)
        return {
            "token_emb": layers.embed_params(k_tok, c.input_dim, d),
            "class_emb": layers.embed_params(k_cls, c.num_classes, d),
            "encoder": self.encoder.init(k_enc),
            "latent_proj": layers.dense_params(k_lat, d, 2 * c.latent_dim),
        }

    def __call__(
        self, p, tokens: jax.Array, classes: jax.Array,
        rng: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, jax.Array]:
        dt = self.dtype
        key_mask = tokens != PAD_ID  # reference: model.py:81-83
        x = layers.embed(p["token_emb"], tokens, dt) + (
            layers.embed(p["class_emb"], classes, dt)[:, None, :]
        )
        h = self.encoder(p["encoder"], x, key_mask, rng)
        h0 = h[:, 0, :]  # position-0 readout (reference: model.py:97)
        mu, logvar = jnp.split(
            layers.dense(p["latent_proj"], h0.astype(jnp.float32),
                         jnp.float32), 2, axis=-1)
        # Clamp logvar: exp(logvar) feeds both the KL and the
        # reparameterized sigma, so an unconstrained head is an overflow
        # channel — one spike batch pushes a dim's logvar up, exp() goes
        # inf in f32, and the whole run NaNs (observed at the wide
        # config). +/-8 spans sigma in [0.018, 54.6], far beyond any
        # useful posterior, and is the identity for healthy values. (The
        # reference's head is even less constrained — raw "stddev" with
        # no positivity, model.py:100-104.)
        logvar = jnp.clip(logvar, -8.0, 8.0)
        return mu, logvar


@dataclasses.dataclass(frozen=True)
class VAEDecoder:
    """Conditioning-state-prepended causal transformer decoder -> logits.

    Reference: model.py:206-272 (Decoder).
    """

    config: DecoderConfig
    dtype: Any = jnp.float32

    @property
    def decoder(self) -> TransformerStack:
        return TransformerStack(config=self.config.transformer_config,
                                causal=True, dtype=self.dtype)

    def init(self, key: jax.Array) -> layers.Params:
        c = self.config
        d = c.transformer_config.model_size
        k_lat, k_cls, k_tok, k_dec, k_out = jax.random.split(key, 5)
        return {
            "latent2hid": layers.dense_params(k_lat, c.latent_dim, d),
            "class_emb": layers.embed_params(k_cls, c.num_classes, d),
            "token_emb": layers.embed_params(k_tok, c.output_dim, d),
            "decoder": self.decoder.init(k_dec),
            "output_layer": layers.dense_params(k_out, d, c.output_dim),
        }

    def initial_state(self, p, z: jax.Array, classes: jax.Array) -> jax.Array:
        """[B, D] conditioning embedding (reference: model.py:229-232)."""
        return (layers.dense(p["latent2hid"], z, self.dtype)
                + layers.embed(p["class_emb"], classes, self.dtype))

    @property
    def per_step_conditioning(self) -> bool:
        return self.config.class_conditioning == "per_step"

    def _embed_step(self, p, tokens, classes: Optional[jax.Array]):
        """Token embeddings, plus the class embedding at every position
        under class_conditioning="per_step"."""
        x = layers.embed(p["token_emb"], tokens, self.dtype)
        if self.per_step_conditioning:
            if classes is None:
                raise ValueError(
                    "class_conditioning='per_step' decoders need the classes "
                    "array at every decode step")
            bias = layers.embed(p["class_emb"], classes, self.dtype)
            x = x + (bias[:, None, :] if x.ndim == 3 else bias)
        return x

    def _logits(self, p, h: jax.Array) -> jax.Array:
        return layers.dense(p["output_layer"], h.astype(jnp.float32),
                            jnp.float32)

    def __call__(
        self,
        p,
        tokens: jax.Array,
        seq_lens: jax.Array,
        z: jax.Array,
        classes: jax.Array,
        rng: Optional[jax.Array] = None,
    ) -> jax.Array:
        """tokens: SOS-prefixed [B, L+1]; returns logits [B, L+1, V]."""
        init = self.initial_state(p, z, classes)[:, None, :]  # [B, 1, D]
        x = jnp.concatenate([init, self._embed_step(p, tokens, classes)],
                            axis=1)  # [B, L+2, D]
        # Valid positions: conditioning state + seq_lens real tokens
        # (reference: model.py:246-247 masks to seq_length + 1).
        positions = jnp.arange(x.shape[1])
        key_mask = positions[None, :] < (seq_lens[:, None] + 1)
        h = self.decoder(p["decoder"], x, key_mask, rng)
        return self._logits(p, h[:, 1:, :])  # drop the conditioning position

    # --- incremental decoding -------------------------------------------

    def step_token(
        self,
        p,
        token_t: jax.Array,
        cache: Cache,
        t: jax.Array,
        classes: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, Cache]:
        """One decode position from token ids [B]. ``classes`` is required
        (and used) only under per-step class conditioning."""
        x_t = self._embed_step(p, token_t, classes)
        h_t, cache = self.decoder.step(p["decoder"], x_t, cache, t)
        return self._logits(p, h_t), cache

    def step_ragged(
        self,
        p,
        token_t: jax.Array,
        cache: Cache,
        t: jax.Array,
        classes: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, Cache]:
        """One decode position with PER-ROW positions ``t`` [S] — the
        continuous-batching engine's slots (inference/streaming.py)."""
        x_t = self._embed_step(p, token_t, classes)
        h_t, cache = self.decoder.step_ragged(p["decoder"], x_t, cache, t)
        return self._logits(p, h_t), cache

    def prefill(self, p, z: jax.Array, classes: jax.Array,
                max_len: int) -> Cache:
        """Build the cache and process position 0 (the conditioning state).

        Position 0's prediction is dropped in training (model.py:253) and is
        likewise unused here: generation starts by feeding SOS at position 1,
        whose logits predict the first real token.
        """
        cache = self.decoder.init_cache(z.shape[0], max_len, dtype=self.dtype)
        x0 = self.initial_state(p, z, classes)
        _, cache = self.decoder.step(p["decoder"], x0, cache,
                                     jnp.asarray(0))
        return cache


@dataclasses.dataclass(frozen=True)
class StyleVAE:
    """Encoder + reparameterized sampling + decoder (reference: model.py:275-296).

    Parameters: ``{"encoder": ..., "decoder": ...}``."""

    config: ModelConfig

    @property
    def dtype(self) -> Any:
        return _dtype(self.config.dtype)

    @property
    def encoder(self) -> VAEEncoder:
        return VAEEncoder(config=self.config.encoder_config, dtype=self.dtype)

    @property
    def decoder(self):
        dc = self.config.decoder_config
        if dc.decoder_type == "lstm":
            from .lstm import LSTMDecoder

            return LSTMDecoder(config=dc, dtype=self.dtype)
        return VAEDecoder(config=dc, dtype=self.dtype)

    def init(self, key: jax.Array) -> layers.Params:
        dc = self.config.decoder_config
        if dc.decoder_type == "lstm" and dc.class_conditioning != "initial":
            raise ValueError(
                "class_conditioning='per_step' requires the transformer "
                "decoder (the legacy LSTM keeps the reference's "
                "initial-state conditioning)"
            )
        k_enc, k_dec = jax.random.split(key)
        return {"encoder": self.encoder.init(k_enc),
                "decoder": self.decoder.init(k_dec)}

    def __call__(
        self,
        params,
        tokens: jax.Array,
        seq_lens: jax.Array,
        classes: jax.Array,
        rng: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Teacher-forced forward -> (logits, mu, logvar).

        With ``rng`` (training): z is sampled by reparameterization and
        dropout is active. Without (inference): z = mu and no dropout
        (reference: sampler.py:148)."""
        sample_rng, dropout_rng = layers.split_key(rng, 2)
        enc_rng, dec_rng = layers.split_key(dropout_rng, 2)
        mu, logvar = self.encoder(params["encoder"], tokens, classes, enc_rng)
        if sample_rng is not None:
            eps = jax.random.normal(sample_rng, mu.shape, mu.dtype)
            z = mu + eps * jnp.exp(0.5 * logvar)  # reference: model.py:292
        else:
            z = mu
        logits = self.decoder(params["decoder"], tokens, seq_lens, z, classes,
                              dec_rng)
        return logits, mu, logvar

    # Entry points of the jitted inference loops.

    def encode(
        self, params, tokens: jax.Array, seq_lens: jax.Array,
        classes: jax.Array,
    ) -> Tuple[jax.Array, jax.Array]:
        del seq_lens  # lengths are implied by the PAD mask
        return self.encoder(params["encoder"], tokens, classes)

    def decode_prefill(self, params, z: jax.Array, classes: jax.Array,
                       max_len: int) -> Cache:
        return self.decoder.prefill(params["decoder"], z, classes, max_len)

    def decode_step(
        self,
        params,
        token_t: jax.Array,
        cache: Cache,
        t: jax.Array,
        classes: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, Cache]:
        return self.decoder.step_token(params["decoder"], token_t, cache, t,
                                       classes)

    def decode_step_ragged(
        self,
        params,
        token_t: jax.Array,
        cache: Cache,
        t: jax.Array,
        classes: Optional[jax.Array] = None,
    ) -> Tuple[jax.Array, Cache]:
        return self.decoder.step_ragged(params["decoder"], token_t, cache, t,
                                        classes)


def make_model(config: ModelConfig) -> StyleVAE:
    return StyleVAE(config=config)


def init_params(model: StyleVAE, rng: jax.Array, max_seq_len: int):
    """Initialize a parameter pytree. ``max_seq_len`` is kept for callers
    that size inputs from it; parameter shapes do not depend on it."""
    del max_seq_len
    return jax.jit(model.init)(rng)
