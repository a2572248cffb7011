"""Shared utilities: directories, piano-roll visualization, logging helpers.

Reference: VarAutoEncoder/utils.py:1-71. Checkpoint scanning/save/load moved
to training/checkpoint.py (with the §8.11 regex fix); pickle helpers are
replaced by JSON bookkeeping there.
"""

from __future__ import annotations

import os
import pprint
from typing import Optional


CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPILE_CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def pin_local_cpu() -> None:
    """Pin JAX's default device to a LOCAL CPU device (the CLIs' --cpu),
    so un-sharded computations (param init, eval, sampling) stay on the
    host even where an accelerator is present. Must be a local device: in
    multi-process runs jax.devices("cpu")[0] belongs to process 0.
    """
    import jax

    jax.config.update("jax_default_device",
                      jax.local_devices(backend="cpu")[0])


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives: exactly
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else one fixed directory in
    the checkout (a fixed path, because the path is part of the cache
    key)."""
    return os.environ.get(COMPILE_CACHE_ENV) or os.path.join(
        CHECKOUT_ROOT, ".jax_cache")


def configure_jax_cache(min_compile_secs: float = 1.0) -> str:
    """Enable the persistent XLA compilation cache at compile_cache_dir()
    and return that directory. JAX reads ``$JAX_COMPILATION_CACHE_DIR``
    itself, so when it is set no directory is set here. Shared by every
    CLI and benchmark entry point."""
    import jax

    cache_dir = compile_cache_dir()
    if COMPILE_CACHE_ENV not in os.environ:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return cache_dir


import numpy as np

from .midi.codec import Melody
from .midi.vocab import (
    is_note_off,
    is_note_on,
    is_timeshift,
    token_pitch,
    token_tick_delay,
)


def create_directory_if_not_present(directory: str) -> None:
    """Reference: utils.py:47-49."""
    if directory and not os.path.exists(directory):
        os.makedirs(directory)


def melody_to_piano_roll(
    melody: Melody, ticks_per_column: int = 30, max_columns: int = 2048
) -> np.ndarray:
    """[128, T] binary piano roll from a tokenized melody.

    Working replacement for the reference's stale ``visualize_melody``
    (utils.py:52-61, written against a removed Note API). Note-on starts a
    pitch, note-off ends it, time-shift advances the clock.
    """
    roll = np.zeros((128, max_columns), dtype=np.float32)
    active: dict[int, int] = {}
    t = 0
    for token in np.asarray(melody.tokens).tolist():
        col = min(t // ticks_per_column, max_columns - 1)
        if is_timeshift(token):
            t += token_tick_delay(token)
        elif is_note_on(token):
            pitch = token_pitch(token)
            # The tokenizer's velocity quirk turns written note-offs into
            # note-ON tokens, so a repeated note-on doubles as the off for
            # the previous note at this pitch.
            start = active.pop(pitch, None)
            if start is not None:
                roll[pitch, start : col + 1] = 1.0
            else:
                active[pitch] = col
        elif is_note_off(token):
            pitch = token_pitch(token)
            start = active.pop(pitch, None)
            if start is not None:
                roll[pitch, start : col + 1] = 1.0
    last_col = min(t // ticks_per_column, max_columns - 1)
    for pitch, start in active.items():  # notes never turned off
        roll[pitch, start : last_col + 1] = 1.0
    used = max(int(np.max(np.nonzero(roll)[1])) + 1, 1) if roll.any() else 1
    return roll[:, :used]


def visualize_melody(melody: Melody, path: Optional[str] = None) -> np.ndarray:
    """Render a piano roll; saves to ``path`` (or shows) via matplotlib.

    Reference: utils.py:52-61.
    """
    roll = melody_to_piano_roll(melody)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 4))
        ax.imshow(roll[::-1], cmap="gray_r", aspect="auto",
                  interpolation="nearest")
        ax.set_xlabel("time (30-tick bins)")
        ax.set_ylabel("MIDI pitch")
        if path:
            fig.savefig(path, bbox_inches="tight", dpi=120)
        else:
            plt.show()
        plt.close(fig)
    except ImportError:
        pass
    return roll


def log_config(config) -> None:
    """Reference: utils.py:64-66."""
    pprint.pprint("Using configuration: ")
    pprint.pprint(config)


def log_model_variables(params) -> None:
    """Parameter-tree summary (reference: utils.py:69-71)."""
    import jax

    print("Model variables: ")
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    total = 0
    for path, leaf in flat:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        print(f"  {name}: {tuple(leaf.shape)}")
        total += leaf.size
    print(f"Total parameters: {total:,}")
