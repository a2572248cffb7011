"""Legacy LSTM decoder variant (feature parity with the reference's
LSTMDecoder, model.py:131-203).

The latent+class conditioning enters through the initial (h, c) state:
``latent2hid(z) + class_emb(class)`` produces 2*hidden features split into
h0 and c0, repeated across layers (reference: model.py:155-167). Unlike the
transformer decoder there is no prepended conditioning position, so the
training output aligns with the labels directly.

Presents the same (``__call__``, ``prefill``, ``step_token``) surface as the
transformer ``VAEDecoder`` so the jitted decode loop (inference/decode.py)
works unchanged — the "cache" pytree is the tuple of per-layer LSTM
carries. Parameters: ``latent2hid``, ``class_emb``, ``token_emb``,
``rnn{i}/cell`` (one LSTM cell per layer) and ``output_layer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from . import layers
from .config import DecoderConfig, LSTMConfig


@dataclasses.dataclass(frozen=True)
class LSTMDecoder:
    config: DecoderConfig
    dtype: Any = jnp.float32

    @property
    def lstm_cfg(self) -> LSTMConfig:
        return self.config.lstm_config or LSTMConfig()

    def init(self, key: jax.Array) -> layers.Params:
        c, lc = self.config, self.lstm_cfg
        H = lc.hidden_dim
        keys = jax.random.split(key, 4 + lc.n_layers)
        p = {
            "latent2hid": layers.dense_params(keys[0], c.latent_dim, 2 * H),
            "class_emb": layers.embed_params(keys[1], c.num_classes, 2 * H),
            "token_emb": layers.embed_params(keys[2], c.output_dim, H),
            "output_layer": layers.dense_params(keys[3], H, c.output_dim),
        }
        for i in range(lc.n_layers):
            p[f"rnn{i}"] = {"cell": layers.lstm_cell_params(keys[4 + i], H, H)}
        return p

    def _initial_carries(self, p, z: jax.Array, classes: jax.Array):
        """Per-layer (c, h) carries from latent+class (model.py:155-167).

        The reference splits the 2H transform into [h, c] and repeats the
        same pair for every layer.
        """
        transform = (layers.dense(p["latent2hid"], z, self.dtype)
                     + layers.embed(p["class_emb"], classes, self.dtype))
        h0, c0 = jnp.split(transform, 2, axis=-1)
        return tuple((c0, h0) for _ in range(self.lstm_cfg.n_layers))

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
        """tokens: SOS-prefixed [B, L+1]; returns logits [B, L+1, V].

        seq_lens is unused: like the reference LSTM path, padded positions
        are processed and masked by the loss.
        """
        del seq_lens
        n = self.lstm_cfg.n_layers
        x = layers.embed(p["token_emb"], tokens, self.dtype)
        carries = self._initial_carries(p, z, classes)
        keys = layers.split_key(rng, n)
        for i in range(n):
            _, x = layers.lstm_scan(p[f"rnn{i}"]["cell"], carries[i], x,
                                    self.dtype)
            if i + 1 < n:
                x = layers.dropout(x, self.lstm_cfg.dropout, keys[i])
        return self._logits(p, x)

    # --- incremental decoding (same surface as VAEDecoder) --------------

    def prefill(self, p, z: jax.Array, classes: jax.Array, max_len: int):
        del max_len  # carries are O(1); no sequence-length cache needed
        return self._initial_carries(p, z, classes)

    def step_token(
        self, p, token_t: jax.Array, cache, t: jax.Array, classes=None
    ) -> Tuple[jax.Array, Any]:
        # t: recurrent state carries all positional context. classes: the
        # LSTM only supports initial-state conditioning (StyleVAE.init
        # rejects per_step + lstm), so the argument is accepted for surface
        # uniformity with VAEDecoder.step_token and ignored.
        del t, classes
        x = layers.embed(p["token_emb"], token_t, self.dtype)
        new_carries = []
        for i in range(self.lstm_cfg.n_layers):
            carry, x = layers.lstm_cell(p[f"rnn{i}"]["cell"], cache[i], x,
                                        self.dtype)
            new_carries.append(carry)
        return self._logits(p, x), tuple(new_carries)
