"""Optimizer construction from the reference's CLI-style config.

Reference: trainer.py:14-35 (OptimizerConfig with "key1:value1,key2:value2"
param strings, used as ``clip_gradient:1.0`` in scripts/train-vae.sh:19) and
trainer.py:94-101 (gluon.Trainer construction).

MXNet's ``clip_gradient`` clips each gradient element to [-c, c]; optax's
``optax.clip`` matches that semantic. ``clip_global_norm`` is offered as an
extra.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import optax


@dataclasses.dataclass
class OptimizerConfig:
    optimizer: str = "adam"
    optimizer_params: str = ""
    learning_rate: float = 3e-4

    def params_to_dict(self) -> Dict[str, float]:
        """Parse "k1:v1,k2:v2"; pairs with != 1 delimiter are ignored
        (reference: trainer.py:23-35)."""
        out: Dict[str, float] = {}
        for key_val in self.optimizer_params.strip().split(","):
            parts = key_val.split(":")
            if len(parts) != 2:
                continue
            out[str(parts[0])] = float(parts[1])
        return out


def build_optimizer(config: OptimizerConfig) -> optax.GradientTransformation:
    extra = config.params_to_dict()
    transforms = []
    if "clip_gradient" in extra:
        # elementwise clip, MXNet clip_gradient semantics
        transforms.append(optax.clip(extra.pop("clip_gradient")))
    if "clip_global_norm" in extra:
        transforms.append(optax.clip_by_global_norm(extra.pop("clip_global_norm")))

    # Optional schedule via the same "k:v" extras:
    #   warmup_steps:N            linear warmup to the peak lr
    #   decay_steps:N             cosine decay to ~0 after warmup
    #   skip_nonfinite:K          reject updates whose RAW gradients
    #                             contain NaN/Inf (give up after K
    #                             consecutive) — optax.apply_if_finite
    #                             around the WHOLE chain, so the check
    #                             sees gradients before the elementwise
    #                             clip can launder an Inf into +/-1 and
    #                             before a NaN can poison Adam's moments.
    skip_nonfinite = int(extra.pop("skip_nonfinite", 0))
    lr = config.learning_rate
    warmup = int(extra.pop("warmup_steps", 0))
    decay = int(extra.pop("decay_steps", 0))
    if warmup and decay:
        lr = optax.warmup_cosine_decay_schedule(
            0.0, config.learning_rate, warmup, warmup + decay
        )
    elif warmup:
        lr = optax.linear_schedule(0.0, config.learning_rate, warmup)
    elif decay:
        lr = optax.cosine_decay_schedule(config.learning_rate, decay)
    name = config.optimizer.lower()
    wd = extra.pop("wd", extra.pop("weight_decay", 0.0))
    if name == "adam":
        core = optax.adam(
            lr,
            b1=extra.pop("beta1", 0.9),
            b2=extra.pop("beta2", 0.999),
            eps=extra.pop("epsilon", 1e-8),
        )
    elif name == "adamw":
        core = optax.adamw(
            lr,
            b1=extra.pop("beta1", 0.9),
            b2=extra.pop("beta2", 0.999),
            eps=extra.pop("epsilon", 1e-8),
            weight_decay=wd or 1e-2,
        )
        wd = 0.0
    elif name == "sgd":
        core = optax.sgd(lr, momentum=extra.pop("momentum", 0.0))
    elif name == "rmsprop":
        core = optax.rmsprop(lr, decay=extra.pop("gamma1", 0.9),
                             eps=extra.pop("epsilon", 1e-8))
    else:
        raise ValueError(f"unsupported optimizer {config.optimizer!r}")
    if wd:
        # MXNet `wd` semantics: L2 added to the GRADIENT before the update
        # rule, so the decay is scaled by the learning rate like any other
        # gradient term (param -= lr * (grad + wd * param) for sgd).
        # Appending the decay AFTER the core would bypass the lr and decay
        # ~1/lr times too strongly. (Decoupled adamw-style decay is the
        # separate `--optimizer adamw` path.)
        transforms.append(optax.add_decayed_weights(wd))
    transforms.append(core)
    chain = optax.chain(*transforms)
    if skip_nonfinite:
        # Note: wraps opt_state in ApplyIfFiniteState — checkpoints taken
        # with this knob restore only under the same knob (the config
        # travels with the run dir, so resume is consistent by
        # construction).
        chain = optax.apply_if_finite(
            chain, max_consecutive_errors=skip_nonfinite)
    return chain
