"""MIDI layer tests: vocabulary, SMF codec, tokenizer semantics.

The reference quirks asserted here are behavioral ground truth from
SURVEY.md §8.1 (reference: MIDIUtil/midi_io.py:70-93).
"""

import glob
import os

import numpy as np
import pytest

from musicstyletransfer_tpu.midi import smf, vocab
from musicstyletransfer_tpu.midi.codec import (
    EventBasedMIDIReader,
    Melody,
    MelodyWriter,
    melody_from_ids,
    tokenize_track,
)


class TestVocab:
    def test_id_space_matches_reference(self):
        # reference: MIDIUtil/defaults.py:44-58
        assert vocab.PAD_ID == 0 and vocab.SOS_ID == 1 and vocab.EOS_ID == 2
        assert vocab.NOTE_ON_EVENTS == (3, 130)
        assert vocab.NOTE_OFF_EVENTS == (131, 258)
        assert vocab.TIMESHIFT_EVENTS == (259, 292)
        assert vocab.NUM_BINS == 34
        assert vocab.NUM_EVENTS == 293

    def test_note_ids_roundtrip(self):
        for pitch in (0, 64, 127):
            assert vocab.token_pitch(vocab.note_on_id(pitch)) == pitch
            assert vocab.token_pitch(vocab.note_off_id(pitch)) == pitch

    def test_timeshift_binning(self):
        # bin = int(ticks / 30) (reference: Melody.py:124)
        assert vocab.timeshift_id(0) == 259
        assert vocab.timeshift_id(29) == 259
        assert vocab.timeshift_id(30) == 260
        assert vocab.timeshift_id(999) == 259 + 33
        with pytest.raises(ValueError):
            vocab.timeshift_id(1000)
        assert vocab.token_tick_delay(vocab.timeshift_id(95)) == 90

    def test_melody_from_ids_drops_specials(self):
        # reference: Melody.py:87-90
        m = melody_from_ids([0, 1, 2, 5, 300 - 8, 259])
        assert m.tokens.tolist() == [5, 292, 259]


class TestSmf:
    def test_varlen_roundtrip(self):
        for v in (0, 1, 127, 128, 0x3FFF, 0x4000, 0x0FFFFFFF):
            enc = smf._write_varlen(v)
            dec, pos = smf._read_varlen(enc, 0)
            assert dec == v and pos == len(enc)

    def test_write_read_roundtrip(self, tmp_path):
        track = [
            smf.SetTempo.from_bpm(120.0),
            smf.NoteOn(tick=0, pitch=60, velocity=100),
            smf.NoteOff(tick=480, pitch=60, velocity=64),
            smf.NoteOn(tick=10, pitch=64, velocity=0),  # vel-0 note-on preserved
            smf.EndOfTrack(tick=1),
        ]
        path = str(tmp_path / "t.mid")
        smf.write_midifile(path, smf.MidiFile(format=1, resolution=220, tracks=[track]))
        mf = smf.read_midifile(path)
        assert mf.resolution == 220
        evs = mf.tracks[0]
        assert isinstance(evs[0], smf.SetTempo) and abs(evs[0].bpm - 120.0) < 1e-6
        assert isinstance(evs[1], smf.NoteOn) and evs[1].velocity == 100
        assert isinstance(evs[2], smf.NoteOff) and evs[2].tick == 480
        # velocity-0 NoteOn must stay a NoteOn (python-midi semantics)
        assert isinstance(evs[3], smf.NoteOn) and evs[3].velocity == 0

    def test_running_status(self, tmp_path):
        # Hand-build a track using running status: two note-ons share a status byte.
        body = bytes(
            [0x00, 0x90, 60, 100,  # note on
             0x10, 62, 100,        # running status note on
             0x00, 0xFF, 0x2F, 0x00]
        )
        buf = (b"MThd" + (6).to_bytes(4, "big") + (1).to_bytes(2, "big")
               + (1).to_bytes(2, "big") + (220).to_bytes(2, "big")
               + b"MTrk" + len(body).to_bytes(4, "big") + body)
        mf = smf.parse_midifile(buf)
        ons = [e for e in mf.tracks[0] if isinstance(e, smf.NoteOn)]
        assert [(e.tick, e.pitch) for e in ons] == [(0, 60), (0x10, 62)]

    def test_bpm_conversion_matches_python_midi(self):
        st = smf.SetTempo.from_bpm(117.0)
        assert st.mpqn == int(6e7 / 117.0)
        assert st.bpm == float(6e7) / st.mpqn


class TestTokenizer:
    def _track(self, events):
        return events

    def test_velocity_classification_quirk(self):
        # velocity>0 -> note-ON token even for a NoteOff status byte
        # (reference: midi_io.py:85-89).
        track = [
            smf.NoteOn(tick=0, pitch=60, velocity=100),
            smf.NoteOff(tick=0, pitch=60, velocity=64),  # vel>0 => ON token!
            smf.NoteOn(tick=0, pitch=62, velocity=0),    # vel==0 => OFF token
        ]
        toks = tokenize_track(track).tolist()
        assert toks == [
            vocab.note_on_id(60),
            vocab.note_on_id(60),
            vocab.note_off_id(62),
        ]

    def test_timeshift_simple(self):
        track = [
            smf.NoteOn(tick=0, pitch=60, velocity=100),
            smf.NoteOn(tick=450, pitch=62, velocity=100),
        ]
        toks = tokenize_track(track).tolist()
        assert toks == [
            vocab.note_on_id(60),
            vocab.timeshift_id(450),
            vocab.note_on_id(62),
        ]

    def test_timeshift_drops_ticks_over_1000(self):
        # SURVEY.md §8.1: a 2500-tick gap emits 500,500,500.
        track = [
            smf.NoteOn(tick=0, pitch=60, velocity=100),
            smf.NoteOn(tick=2500, pitch=62, velocity=100),
        ]
        toks = tokenize_track(track).tolist()
        assert toks == [
            vocab.note_on_id(60),
            vocab.timeshift_id(500),
            vocab.timeshift_id(500),
            vocab.timeshift_id(500),
            vocab.note_on_id(62),
        ]

    def test_timeshift_exact_multiple_emits_zero_shifts(self):
        # 2000-tick gap: two zero-shift tokens (500+500... actually 0,0).
        track = [
            smf.NoteOn(tick=0, pitch=60, velocity=100),
            smf.NoteOn(tick=2000, pitch=62, velocity=100),
        ]
        toks = tokenize_track(track).tolist()
        assert toks == [
            vocab.note_on_id(60),
            vocab.timeshift_id(0),
            vocab.timeshift_id(0),
            vocab.note_on_id(62),
        ]

    def test_non_note_events_defer_delta(self):
        # Only note events advance prev_t: gaps spanned by other events
        # accumulate into the next note's delta (reference: midi_io.py:74-91).
        track = [
            smf.NoteOn(tick=0, pitch=60, velocity=100),
            smf.OtherEvent(tick=300, status=0xB0, data=bytes([7, 100])),
            smf.NoteOn(tick=300, pitch=62, velocity=100),
        ]
        toks = tokenize_track(track).tolist()
        assert toks == [
            vocab.note_on_id(60),
            vocab.timeshift_id(600),
            vocab.note_on_id(62),
        ]


class TestReaderWriter:
    def test_corpus_tokenizes(self, corpus_path):
        reader = EventBasedMIDIReader()
        files = sorted(glob.glob(os.path.join(corpus_path, "*", "*.mid")))
        assert len(files) == 37  # 29 guitar + 8 bass
        total = 0
        for f in files:
            melodies = reader.read_file(f)
            assert len(melodies) >= 1
            for m in melodies:
                assert len(m) >= 10
                assert np.all(m.tokens >= vocab.FEATURE_OFFSET)
                assert np.all(m.tokens < vocab.NUM_EVENTS)
                total += len(m)
        assert total > 1000

    def test_write_then_tokenize_stable(self, tmp_path):
        # A melody whose deltas are exact bin multiples < 1000 must survive
        # tokens -> MIDI -> tokens unchanged.
        tokens = [
            vocab.note_on_id(60),
            vocab.timeshift_id(450),
            vocab.note_off_id(60),
            vocab.timeshift_id(90),
            vocab.note_on_id(64),
            vocab.timeshift_id(960),
            vocab.note_off_id(64),
        ]
        m = Melody(tokens=np.array(tokens))
        path = str(tmp_path / "rt.mid")
        MelodyWriter().write_to_file(path, m)
        mf = smf.read_midifile(path)
        retoks = tokenize_track(mf.tracks[0]).tolist()
        # note-off velocity 64 re-tokenizes as note-ON (reference quirk) —
        # compare against what the reference itself would produce:
        expected = [
            vocab.note_on_id(60),
            vocab.timeshift_id(450),
            vocab.note_on_id(60),   # written note-off has vel 64 => ON token
            vocab.timeshift_id(90),
            vocab.note_on_id(64),
            vocab.timeshift_id(960),
            vocab.note_on_id(64),
        ]
        assert retoks == expected

    def test_corpus_golden_checksums(self, corpus_path):
        # Regression pin of the full-corpus tokenization (first track per
        # file, like the reference Loader at data.py:35). If this changes,
        # bit-identity with the reference tokenizer has been broken.
        import hashlib

        reader = EventBasedMIDIReader()
        files = sorted(glob.glob(os.path.join(corpus_path, "*", "*.mid")))
        h = hashlib.sha256()
        n_tokens = 0
        for f in files:
            toks = reader.read_file(f)[0].tokens
            n_tokens += len(toks)
            h.update(os.path.basename(f).encode())
            h.update(toks.astype("<i4").tobytes())
        golden_path = os.path.join(os.path.dirname(__file__), "goldens",
                                   "corpus_tokens.sha256")
        got = f"{n_tokens} {h.hexdigest()}"
        if not os.path.exists(golden_path):
            os.makedirs(os.path.dirname(golden_path), exist_ok=True)
            with open(golden_path, "w") as fh:
                fh.write(got + "\n")
            pytest.skip("golden created on first run")
        with open(golden_path) as fh:
            want = fh.read().strip()
        assert got == want


class TestSmfPropertyRoundTrip:
    def test_random_tracks_roundtrip(self):
        """Property: arbitrary well-formed event sequences survive
        write -> parse exactly (ticks, pitches, velocities, tempo)."""
        rng = np.random.default_rng(7)
        for trial in range(25):
            track = [smf.SetTempo.from_bpm(float(rng.integers(40, 240)))]
            for _ in range(rng.integers(1, 60)):
                tick = int(rng.integers(0, 5000))
                pitch = int(rng.integers(0, 128))
                if rng.random() < 0.5:
                    track.append(smf.NoteOn(tick=tick, pitch=pitch,
                                            velocity=int(rng.integers(0, 128))))
                else:
                    track.append(smf.NoteOff(tick=tick, pitch=pitch,
                                             velocity=int(rng.integers(0, 128))))
            track.append(smf.EndOfTrack(tick=1))
            buf = smf.dump_midifile(
                smf.MidiFile(format=1, resolution=int(rng.integers(24, 960)),
                             tracks=[track])
            )
            back = smf.parse_midifile(buf)
            orig_events = [e for e in track if not isinstance(e, smf.EndOfTrack)]
            read_events = [e for e in back.tracks[0]
                           if not isinstance(e, smf.EndOfTrack)]
            assert len(orig_events) == len(read_events), trial
            for a, b in zip(orig_events, read_events):
                assert type(a) is type(b)
                assert a.tick == b.tick
                if isinstance(a, (smf.NoteOn, smf.NoteOff)):
                    assert (a.pitch, a.velocity) == (b.pitch, b.velocity)
                if isinstance(a, smf.SetTempo):
                    assert a.mpqn == b.mpqn

    def test_parser_never_crashes_on_garbage_bytes(self):
        """Byte-level fuzz: random and mutated buffers must raise SmfError
        (or parse), never IndexError/struct.error/infinite loops."""
        import glob

        from musicstyletransfer_tpu.midi import smf

        rng = np.random.default_rng(123)
        buffers = [rng.bytes(n) for n in (0, 1, 13, 14, 64, 300)]
        # plausible-looking garbage: real header, corrupted body
        corpus = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "work", "data", "guitar_bass")
        real = sorted(glob.glob(os.path.join(corpus, "*", "*.mid")))
        if real:
            base = bytearray(open(real[0], "rb").read())
            for _ in range(40):
                mut = bytearray(base)
                for off in rng.integers(0, len(mut), size=8):
                    mut[off] = int(rng.integers(0, 256))
                buffers.append(bytes(mut))
        parsed = 0
        for buf in buffers:
            try:
                smf.parse_midifile(buf)
                parsed += 1
            except smf.SmfError:
                pass
        # some mutations still parse — that's fine; the point is no other
        # exception type and no hang
        assert parsed >= 0

    def test_tokenizer_handles_random_files(self):
        """Tokenization of arbitrary well-formed files never crashes and
        emits only valid ids."""
        from musicstyletransfer_tpu.midi.codec import tokenize_track

        rng = np.random.default_rng(11)
        for _ in range(25):
            track = []
            for _ in range(rng.integers(1, 80)):
                track.append(
                    smf.NoteOn(tick=int(rng.integers(0, 4000)),
                               pitch=int(rng.integers(0, 128)),
                               velocity=int(rng.integers(0, 128)))
                )
            toks = tokenize_track(track)
            if len(toks):
                assert toks.min() >= vocab.FEATURE_OFFSET
                assert toks.max() < vocab.NUM_EVENTS

    def test_native_matches_python_on_random_files(self, tmp_path):
        native = pytest.importorskip("musicstyletransfer_tpu.midi.native")
        if not native.available():
            pytest.skip("no native lib")
        from musicstyletransfer_tpu.midi.codec import EventBasedMIDIReader

        py, nat = EventBasedMIDIReader(), native.NativeMIDIReader()
        rng = np.random.default_rng(13)
        for trial in range(10):
            track = [smf.SetTempo.from_bpm(120.0)]
            for _ in range(40):
                track.append(
                    smf.NoteOn(tick=int(rng.integers(0, 3000)),
                               pitch=int(rng.integers(0, 128)),
                               velocity=int(rng.integers(0, 128)))
                )
            p = str(tmp_path / f"r{trial}.mid")
            smf.write_midifile(
                p, smf.MidiFile(format=1, resolution=220, tracks=[track])
            )
            a, b = py.read_file(p), nat.read_file(p)
            for ma, mb in zip(a, b):
                np.testing.assert_array_equal(ma.tokens, mb.tokens)
