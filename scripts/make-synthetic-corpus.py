"""Generate a multi-thousand-file synthetic MIDI corpus for the scaled
end-to-end run.

Two style classes with genuinely different statistics, so a class-
conditional VAE has signal to separate and the transfer-stats JS metric
has distinct pitch-class profiles to measure:

- ``lead``: pentatonic runs in a high register, short time shifts, long
  phrases (melodic noodling);
- ``bass``: root-fifth-octave patterns in a low register, long shifts,
  sparser (rhythm-section lines).

Every file round-trips through the project's own writer, so the corpus is
bit-exact with the tokenizer's SMF expectations.

Usage: python scripts/make-synthetic-corpus.py OUT_DIR [files_per_class]
       [length_mult]

``length_mult`` scales every melody's note count (default 1): the
long-sequence run (train-vae-long.sh, L=2046) needs files long enough to
fill multi-thousand-token chunks, where the default lengths suit L=512.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from musicstyletransfer_tpu.midi.codec import Melody, MelodyWriter  # noqa: E402
from musicstyletransfer_tpu.midi.vocab import (  # noqa: E402
    note_off_id,
    note_on_id,
    timeshift_id,
)

PENTATONIC = [0, 3, 5, 7, 10]

_LENGTH_MULT = 1


def lead_melody(rng: np.random.Generator) -> Melody:
    n_notes = int(rng.integers(150, 450)) * _LENGTH_MULT
    root = int(rng.integers(57, 69))  # A3..G#4 region
    degree = 0
    toks = []
    for _ in range(n_notes):
        degree = int(np.clip(degree + rng.integers(-2, 3), 0, 14))
        pitch = root + 12 * (degree // 5) + PENTATONIC[degree % 5]
        pitch = int(np.clip(pitch, 0, 127))
        dur = int(rng.choice([60, 90, 120, 180], p=[0.4, 0.3, 0.2, 0.1]))
        toks.append(note_on_id(pitch))
        toks.append(timeshift_id(dur))
        toks.append(note_off_id(pitch))
        if rng.random() < 0.15:  # phrase gap
            toks.append(timeshift_id(int(rng.choice([120, 240]))))
    return Melody(tokens=np.asarray(toks, np.int32))


def bass_melody(rng: np.random.Generator) -> Melody:
    n_notes = int(rng.integers(80, 250)) * _LENGTH_MULT
    root = int(rng.integers(28, 41))  # E1..F2 region
    toks = []
    pattern = [0, 7, 0, 12]  # root - fifth - root - octave
    i = 0
    for _ in range(n_notes):
        pitch = int(np.clip(root + pattern[i % 4], 0, 127))
        i += 1
        dur = int(rng.choice([240, 360, 480], p=[0.5, 0.3, 0.2]))
        toks.append(note_on_id(pitch))
        toks.append(timeshift_id(dur))
        toks.append(note_off_id(pitch))
        if rng.random() < 0.08:
            root = int(np.clip(root + rng.choice([-5, -2, 2, 5]), 28, 45))
    return Melody(tokens=np.asarray(toks, np.int32))


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/mst-synth-corpus"
    per_class = int(sys.argv[2]) if len(sys.argv) > 2 else 2000
    global _LENGTH_MULT
    if len(sys.argv) > 3:
        _LENGTH_MULT = int(sys.argv[3])
    writer = MelodyWriter()
    rng = np.random.default_rng(0)
    total_tokens = 0
    for cls, gen in (("lead", lead_melody), ("bass", bass_melody)):
        d = os.path.join(out_dir, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            m = gen(rng)
            total_tokens += len(m.tokens)
            writer.write_to_file(os.path.join(d, f"{cls}-{i:05d}.mid"), m)
    print(f"wrote {2 * per_class} files, {total_tokens} tokens -> {out_dir}")


if __name__ == "__main__":
    main()
