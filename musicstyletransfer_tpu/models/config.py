"""Config base + model configs with JSON round-trip persistence.

Reference: VarAutoEncoder/config.py:81-222 (Config with freeze + YAML tags +
backward-compatible default fill-in) and the model config classes at
model.py:11-54 / transformer.py:8-21.

Design: plain frozen dataclasses saved as JSON objects. Each object names
its class under ``"__type__"`` (the role the reference's YAML tags play),
so nested configs load back as their own classes. Loading fills missing
fields from dataclass defaults and ignores unknown keys, so config files
written by older versions keep working (reference: config.py:105-115).
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, Optional, Type, TypeVar

_T = TypeVar("_T", bound="Config")
_REGISTRY: Dict[str, Type["Config"]] = {}
_TYPE_KEY = "__type__"


def register_config(cls: Type[_T]) -> Type[_T]:
    """Class decorator: make a Config dataclass loadable by its name."""
    _REGISTRY[cls.__name__] = cls
    return cls


def _to_json_obj(obj: Any) -> Any:
    if isinstance(obj, Config):
        out = {_TYPE_KEY: type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = _to_json_obj(getattr(obj, f.name))
        return out
    return obj


def _from_json_obj(obj: Any) -> Any:
    if isinstance(obj, dict) and _TYPE_KEY in obj:
        cls = _REGISTRY[obj[_TYPE_KEY]]
        known = {f.name for f in dataclasses.fields(cls)}
        # Backward-compatible default fill-in: ignore unknown keys, let
        # dataclass defaults cover missing ones (reference: config.py:105-115).
        return cls(**{k: _from_json_obj(v) for k, v in obj.items()
                      if k in known})
    return obj


@dataclasses.dataclass(frozen=True)
class Config:
    """Base for JSON-persistable configs (reference: config.py:90-222)."""

    def copy(self: _T, **overrides: Any) -> _T:
        new = copy.deepcopy(self)
        for k, v in overrides.items():
            object.__setattr__(new, k, v)
        return new

    def save(self, fname: str) -> None:
        with open(fname, "w") as out:
            out.write(self.to_json() + "\n")

    @staticmethod
    def load(fname: str) -> "Config":
        with open(fname) as inp:
            text = inp.read()
        if text.lstrip().startswith("!"):
            raise ValueError(
                f"{fname} is a YAML config from an older version; configs "
                "are JSON now (one object per config class, named under "
                f"{_TYPE_KEY!r})"
            )
        return _from_json_obj(json.loads(text))

    def to_json(self) -> str:
        return json.dumps(_to_json_obj(self), indent=2, sort_keys=True)


@register_config
@dataclasses.dataclass(frozen=True)
class TransformerConfig(Config):
    """Reference: transformer.py:8-21."""

    model_size: int = 128
    dropout: float = 0.0
    num_layers: int = 1
    num_heads: int = 8
    vocab_size: Optional[int] = None
    # Additions (defaults preserve reference behavior):
    ffn_multiplier: int = 4
    max_positions: int = 10000  # positional table size (transformer.py:217)
    # Residual-norm placement. "post" (default) is the reference's
    # post-LN block: x = LN(x + sublayer(x)) (transformer.py:129-159).
    # "pre" is the modern pre-LN block (x = x + sublayer(LN(x)) with one
    # final stack LN): the backward flows through an identity residual
    # path instead of a product of LN Jacobians, which is what stops the
    # wide config's runaway backward explosion — forward healthy while
    # gradient norms grew 1e4 -> 2e8 -> overflow over ~150 steps under
    # post-LN, three attempts in a row. The wide training preset uses
    # "pre".
    norm_scheme: str = "post"
    # Sequence parallelism: constrain activations to shard the time axis
    # over the mesh's "model" axis between blocks (GSPMD inserts the
    # all-gathers around attention). No-op off-mesh.
    sequence_sharding: bool = False
    # Ring attention (ops/ring_attention.py): compute attention itself
    # sequence-parallel — K/V chunks rotate over the mesh's "model" axis via
    # ppermute, no device holds full K/V. Engages when a mesh with a >1
    # "model" axis is active; otherwise the single-device attention runs.
    # Intended for long-sequence configs together with sequence_sharding
    # (the model axis then carries time, not heads — do not combine with
    # tensor parallelism on the same axis).
    ring_attention: bool = False
    # Rematerialize each transformer layer in backward (jax.checkpoint):
    # trades recompute FLOPs for activation memory — the right trade for
    # long-sequence training where device memory is the constraint.
    remat: bool = False


@register_config
@dataclasses.dataclass(frozen=True)
class LSTMConfig(Config):
    """Legacy LSTM decoder config (reference: model.py:11-19)."""

    n_layers: int = 1
    hidden_dim: int = 128
    dropout: float = 0.0


@register_config
@dataclasses.dataclass(frozen=True)
class EncoderConfig(Config):
    """Reference: model.py:35-45."""

    transformer_config: TransformerConfig = dataclasses.field(
        default_factory=TransformerConfig
    )
    latent_dim: int = 64
    num_classes: int = 2
    input_dim: int = 293


@register_config
@dataclasses.dataclass(frozen=True)
class DecoderConfig(Config):
    """Reference: model.py:22-32; ``decoder_type`` selects the legacy LSTM
    variant (model.py:131-203) instead of the transformer decoder."""

    transformer_config: TransformerConfig = dataclasses.field(
        default_factory=TransformerConfig
    )
    latent_dim: int = 64
    num_classes: int = 2
    output_dim: int = 293
    decoder_type: str = "transformer"  # "transformer" | "lstm"
    lstm_config: Optional[LSTMConfig] = None
    # How the target class conditions the decoder:
    #   "initial"  — class embedding enters ONLY through the prepended
    #                conditioning state (reference: model.py:229-232);
    #   "per_step" — class embedding is ALSO added to every position's
    #                token embedding, so the class signal does not have to
    #                survive the whole sequence through attention to the
    #                conditioning position. Measured motivation: at L=2046
    #                initial-state conditioning loses the register axis to
    #                the latent's source information at every free-bits
    #                operating point, while the GAN family's per-step class
    #                input measured 1.6x better pitch fit than
    #                initial-state-only. Same
    #                parameter tree (reuses class_emb) — checkpoints are
    #                structurally identical; the sidecar config selects the
    #                behavior. Transformer decoder only.
    class_conditioning: str = "initial"  # "initial" | "per_step"


@register_config
@dataclasses.dataclass(frozen=True)
class ModelConfig(Config):
    """Reference: model.py:48-54."""

    encoder_config: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    decoder_config: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    # Compute dtype for activations; params stay float32.
    dtype: str = "bfloat16"
