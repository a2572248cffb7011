"""Minimal end-to-end style transfer with the library API.

Loads the shipped pretrained checkpoint, tokenizes one MIDI file, transfers
it into every style class on device, and writes the results as MIDI.

    python examples/style_transfer.py \
        [input.mid] [model_dir] [out_dir]

Defaults: the first bundled corpus file, models/guitar_bass, /tmp/mst-example.
"""

import glob
import os
import sys

# Runnable from a plain checkout (no pip install): the repo root is the
# example's parent directory.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from musicstyletransfer_tpu.inference.decode import style_transfer_all_classes
from musicstyletransfer_tpu.inference.sampler import load_inference_model
from musicstyletransfer_tpu.midi.codec import (
    EventBasedMIDIReader,
    MelodyWriter,
    melody_from_ids,
)
from musicstyletransfer_tpu.midi.vocab import PAD_ID, SOS_ID
from musicstyletransfer_tpu.utils import configure_jax_cache


def main() -> None:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    corpus = sorted(
        glob.glob(os.path.join(repo, "work/data/guitar_bass/*/*.mid")))
    if len(sys.argv) > 1:
        midi_in = sys.argv[1]
    elif corpus:
        midi_in = corpus[0]
    else:
        raise SystemExit(
            "No bundled corpus found — pass an input MIDI file:\n"
            "  python examples/style_transfer.py input.mid [model_dir] "
            "[out_dir]"
        )
    model_dir = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        repo, "models", "guitar_bass"
    )
    out_dir = sys.argv[3] if len(sys.argv) > 3 else "/tmp/mst-example"
    os.makedirs(out_dir, exist_ok=True)
    configure_jax_cache()

    # 1. host: MIDI bytes -> event tokens (bit-identical to the reference)
    melody = EventBasedMIDIReader().read_file(midi_in)[0]
    L = 64
    chunk = melody.tokens[:L]
    tokens = np.full((1, L + 1), PAD_ID, np.int32)
    tokens[0, 0] = SOS_ID
    tokens[0, 1 : len(chunk) + 1] = chunk

    # 2. device: encode + decode into EVERY class, one fused jitted call
    model, params = load_inference_model(model_dir, checkpoint=-1)
    num_classes = model.config.encoder_config.num_classes
    seqs, scores = style_transfer_all_classes(
        model,
        params,
        jnp.asarray(tokens),
        jnp.asarray([len(chunk) + 1], jnp.int32),
        max_len=2 * (L + 1),
        num_classes=num_classes,
        rng=jax.random.key(0),
        temperature=1.0,
        top_p=0.95,
    )

    # 3. host: tokens -> MIDI files
    writer = MelodyWriter()
    base = os.path.splitext(os.path.basename(midi_in))[0]
    for c in range(num_classes):
        out = melody_from_ids(np.asarray(seqs)[c, 0], bpm=melody.bpm,
                              resolution=melody.resolution)
        path = os.path.join(out_dir, f"{base}.class-{c}.mid")
        writer.write_to_file(path, out)
        print(f"class {c}: {len(out)} events, score "
              f"{float(scores[c, 0]):.2f} -> {path}")


if __name__ == "__main__":
    main()
