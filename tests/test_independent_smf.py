"""Cross-validate the production SMF parser + tokenizer against the
independent event walker (tests/independent_smf.py) over every bundled MIDI
file: the 37-file guitar_bass corpus AND the 73 per-track split files.

smf.py, the C++ twin, and the checked-in goldens share one author and one
reading of the reference; this walker was written separately from the SMF
spec, so a shared misreading of running status / varints / tick accounting
would fail here."""

import glob
import os

import numpy as np
import pytest

from musicstyletransfer_tpu.midi.codec import EventBasedMIDIReader, tokenize_track
from musicstyletransfer_tpu.midi import smf

from tests import independent_smf

SPLITS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "work", "data", "splits")


def _all_midi_files(corpus_path):
    files = sorted(glob.glob(os.path.join(corpus_path, "*", "*.mid")))
    if os.path.isdir(SPLITS):
        files += sorted(glob.glob(os.path.join(SPLITS, "*.mid")))
    assert len(files) >= 37, f"expected the bundled corpus, found {len(files)}"
    return files


class TestIndependentWalker:
    def test_full_corpus_token_streams_identical(self, corpus_path):
        files = _all_midi_files(corpus_path)
        checked_tracks = 0
        for path in files:
            mf = smf.read_midifile(path)
            ours = [tokenize_track(t).tolist() for t in mf.tracks]
            theirs, bpm, resolution = independent_smf.walk_file(path)
            assert len(ours) == len(theirs), path
            for ti, (a, b) in enumerate(zip(ours, theirs)):
                assert a == b, f"{path} track {ti}: first diff at " \
                    f"{next(i for i, (x, y) in enumerate(zip(a, b)) if x != y) if a[:len(b)] != b[:len(a)] else min(len(a), len(b))}"
                checked_tracks += 1
            # file-level metadata must agree too (read_file asserts when no
            # track survives the >= 10 filter — reference midi_io.py:67)
            if any(len(t) >= 10 for t in theirs):
                reader_melodies = EventBasedMIDIReader().read_file(path)
                assert reader_melodies[0].resolution == resolution, path
                np.testing.assert_allclose(
                    reader_melodies[0].bpm, bpm, rtol=1e-12
                )
        assert checked_tracks > 100  # 37 corpus files + 73 splits, multi-track

    def test_reader_filter_matches_walker(self, corpus_path):
        """The >= 10-token track filter must keep the same tracks."""
        for path in _all_midi_files(corpus_path)[::7]:
            theirs, _, _ = independent_smf.walk_file(path)
            kept = [t for t in theirs if len(t) >= 10]
            if not kept:
                continue
            melodies = EventBasedMIDIReader().read_file(path)
            assert len(melodies) == len(kept), path
            for m, t in zip(melodies, kept):
                assert m.tokens.tolist() == t

    def test_walker_disagrees_on_mutated_bytes(self, tmp_path, corpus_path):
        """Sanity: the walker is actually sensitive — flipping a data byte
        changes its output (it isn't accidentally reading via our parser)."""
        src = _all_midi_files(corpus_path)[0]
        raw = bytearray(open(src, "rb").read())
        base, _, _ = independent_smf.walk_file(src)
        # find a note-on data byte via our parser's event offsets: brute
        # force — flip bytes until the walker's output changes.
        changed = False
        for off in range(30, min(len(raw), 400)):
            mut = bytearray(raw)
            mut[off] ^= 0x01
            p = tmp_path / "mut.mid"
            p.write_bytes(bytes(mut))
            try:
                toks, _, _ = independent_smf.walk_file(str(p))
            except (ValueError, IndexError, Exception):
                changed = True
                break
            if toks != base:
                changed = True
                break
        assert changed
