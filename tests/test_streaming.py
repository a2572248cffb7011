"""Continuous-batching streaming engine tests (inference/streaming.py).

Correctness rests on two pins:

1. the ragged per-row decode step (models/transformer.py::step_ragged)
   equals the scalar-position step both when rows share a position and
   when each row sits at its OWN position (assembled from per-row runs);
2. the engine end-to-end: a greedily decoded request through the slot
   machinery emits exactly the tokens of the batch path's greedy
   ``sample_sequences`` at the same budget, and requests admitted
   mid-flight (staggered) still match their individual batch-path runs.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.midi import smf
from musicstyletransfer_tpu.midi.codec import Melody, MelodyWriter
from musicstyletransfer_tpu.midi.vocab import PAD_ID, SOS_ID, note_on_id, timeshift_id
from musicstyletransfer_tpu.models import init_params, make_model
from tests.test_model import tiny_config


@pytest.fixture(scope="module")
def model_folder(tmp_path_factory):
    from musicstyletransfer_tpu.training import (
        OptimizerConfig,
        build_optimizer,
        create_train_state,
        save_checkpoint,
    )

    folder = str(tmp_path_factory.mktemp("stream-model"))
    cfg = tiny_config(vocab=293, classes=2, latent=8, size=16, heads=2,
                      layers=2)
    cfg.save(os.path.join(folder, "config"))
    model = make_model(cfg)
    params = init_params(model, jax.random.key(0), max_seq_len=8)
    tx = build_optimizer(OptimizerConfig("adam", "", 1e-3))
    save_checkpoint(folder, 1, create_train_state(params, tx, jax.random.key(0)))
    return folder


def _midi_bytes(pitches):
    tokens = []
    for p in pitches:
        tokens += [note_on_id(p), timeshift_id(120)]
    melody = Melody(tokens=np.asarray(tokens, np.int32))
    return smf.dump_midifile(MelodyWriter().to_midifile(melody))


class TestRaggedStep:
    def test_uniform_positions_match_scalar_step(self):
        """All rows at the same t: step_ragged == step, bitwise."""
        cfg = tiny_config()
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=6)
        B, T = 4, 8
        cache = model.decode_prefill(params, jnp.zeros((B, 8), jnp.float32),
                                     jnp.zeros((B,), jnp.int32), T)
        toks = jnp.asarray([1, 3, 5, 7], jnp.int32)
        for t in (1, 2, 3):
            logits_s, cache_s = model.decode_step(params, toks, cache, jnp.asarray(t))
            logits_r, cache_r = model.decode_step_ragged(
                params, toks, cache, jnp.full((B,), t, jnp.int32))
            np.testing.assert_array_equal(np.asarray(logits_s),
                                          np.asarray(logits_r))
            for (ks, vs), (kr, vr) in zip(cache_s, cache_r):
                np.testing.assert_array_equal(np.asarray(ks), np.asarray(kr))
                np.testing.assert_array_equal(np.asarray(vs), np.asarray(vr))
            cache = cache_s

    def test_staggered_positions_match_per_row_runs(self):
        """Rows at DIFFERENT positions: one ragged call equals each row
        advanced independently through the scalar step at its own t."""
        cfg = tiny_config()
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=6)
        T = 8
        rows_t = [1, 3, 2, 4]
        B = len(rows_t)
        rng = np.random.default_rng(0)

        # Build each row's cache individually: prefill + (t-1) scalar steps.
        row_caches, row_logits = [], []
        for r, t_r in enumerate(rows_t):
            cache = model.decode_prefill(
                params, jnp.full((1, 8), 0.1 * r, jnp.float32),
                jnp.zeros((1,), jnp.int32), T)
            for t in range(1, t_r):
                tok = jnp.asarray([int(rng.integers(1, 9))], jnp.int32)
                _, cache = model.decode_step(params, tok, cache, jnp.asarray(t))
            tok = jnp.asarray([r + 1], jnp.int32)
            logits, cache = model.decode_step(params, tok, cache, jnp.asarray(t_r))
            row_caches.append(cache)
            row_logits.append(np.asarray(logits)[0])

        # Assemble the pre-step caches into one batch and take ONE ragged
        # step at per-row positions.
        rng = np.random.default_rng(0)
        batch_cache = []
        pre_caches = []
        for r, t_r in enumerate(rows_t):
            cache = model.decode_prefill(
                params, jnp.full((1, 8), 0.1 * r, jnp.float32),
                jnp.zeros((1,), jnp.int32), T)
            for t in range(1, t_r):
                tok = jnp.asarray([int(rng.integers(1, 9))], jnp.int32)
                _, cache = model.decode_step(params, tok, cache, jnp.asarray(t))
            pre_caches.append(cache)
        n_layers = len(pre_caches[0])
        for li in range(n_layers):
            k = jnp.concatenate([pc[li][0] for pc in pre_caches], axis=0)
            v = jnp.concatenate([pc[li][1] for pc in pre_caches], axis=0)
            batch_cache.append((k, v))
        toks = jnp.asarray([r + 1 for r in range(B)], jnp.int32)
        t_vec = jnp.asarray(rows_t, jnp.int32)
        logits_r, cache_r = model.decode_step_ragged(
            params, toks, tuple(batch_cache), t_vec)
        logits_r = np.asarray(logits_r)
        for r in range(B):
            np.testing.assert_allclose(logits_r[r], row_logits[r],
                                       rtol=1e-6, atol=1e-6)
            for li in range(n_layers):
                np.testing.assert_allclose(
                    np.asarray(cache_r[li][0])[r],
                    np.asarray(row_caches[r][li][0])[0],
                    rtol=1e-6, atol=1e-6,
                )


class TestEngineEquivalence:
    def test_greedy_matches_batch_path(self, model_folder):
        """One request through the slot machinery == sample_sequences
        greedy at the same budget, token for token."""
        from musicstyletransfer_tpu.inference.decode import sample_sequences
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=4, max_seq_len=8,
            segment_steps=4, admit_size=4, greedy=True,
        )
        midi = _midi_bytes((60, 64, 67))
        result = eng.submit_midi(midi)
        toks = eng._tokens_from_midi(midi)
        m = len(toks)
        budget = min(2 * (m + 1), eng.t_gen)

        tokens = np.full((1, eng.max_seq_len + 1), PAD_ID, np.int32)
        tokens[0, 0] = SOS_ID
        tokens[0, 1 : m + 1] = toks
        seq_lens = jnp.asarray([m + 1], jnp.int32)
        for c in range(eng.num_classes):
            ref_seqs, _ = sample_sequences(
                eng.model, eng.params, jnp.asarray(tokens), seq_lens,
                jnp.full((1,), c, jnp.int32), budget, jax.random.key(0),
                greedy=True,
            )
            ref = np.asarray(ref_seqs)[0]  # [budget], SOS at 0
            got = result.tokens_by_class[c]
            # Engine result is the post-detokenize melody id stream; rebuild
            # the raw row comparison from the reference by stripping
            # specials the same way melody_from_ids does.
            from musicstyletransfer_tpu.midi.codec import melody_from_ids

            ref_melody = melody_from_ids(ref)
            np.testing.assert_array_equal(got, ref_melody.tokens)

    def test_staggered_admissions_match_batch_path(self, model_folder):
        """Requests admitted on DIFFERENT cycles (slots mid-flight) each
        still reproduce their individual batch-path greedy decode."""
        from musicstyletransfer_tpu.inference.decode import sample_sequences
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )
        from musicstyletransfer_tpu.midi.codec import melody_from_ids

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=8, max_seq_len=8,
            segment_steps=2, admit_size=4, greedy=True,
        )
        reqs = [(60, 64), (55, 59, 62, 65), (70,)]
        midis = [_midi_bytes(p) for p in reqs]
        results = {}
        events = {}

        def cb_for(i):
            def cb(r):
                results[i] = r
                events[i].set()
            return cb

        # Admit request 0, advance a couple of cycles, then admit 1 and 2:
        # slots now sit at different positions.
        for i in range(len(midis)):
            events[i] = threading.Event()
        eng.enqueue(midis[0], cb_for(0))
        eng._cycle(block=False)
        eng._cycle(block=False)
        eng.enqueue(midis[1], cb_for(1))
        eng.enqueue(midis[2], cb_for(2))
        for _ in range(100):
            eng._cycle(block=False)
            if all(e.is_set() for e in events.values()):
                break
        assert all(e.is_set() for e in events.values())

        for i, midi in enumerate(midis):
            toks = eng._tokens_from_midi(midi)
            m = len(toks)
            budget = min(2 * (m + 1), eng.t_gen)
            tokens = np.full((1, eng.max_seq_len + 1), PAD_ID, np.int32)
            tokens[0, 0] = SOS_ID
            tokens[0, 1 : m + 1] = toks
            seq_lens = jnp.asarray([m + 1], jnp.int32)
            for c in range(eng.num_classes):
                ref_seqs, _ = sample_sequences(
                    eng.model, eng.params, jnp.asarray(tokens), seq_lens,
                    jnp.full((1,), c, jnp.int32), budget, jax.random.key(0),
                    greedy=True,
                )
                ref_melody = melody_from_ids(np.asarray(ref_seqs)[0])
                np.testing.assert_array_equal(
                    results[i].tokens_by_class[c], ref_melody.tokens,
                    err_msg=f"request {i} class {c}",
                )


class TestStreamingMesh:
    def test_mesh_engine_matches_single_device(self, model_folder):
        """Pure-DP mesh: the sharded engine emits token-identical greedy
        transfers, and the slot axis STAYS distributed after donated
        cycles (GSPMD propagation, not a silent fallback to replication)."""
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )
        from musicstyletransfer_tpu.parallel.mesh import make_mesh

        reqs = [_midi_bytes((40 + i, 45 + i, 50 + i)) for i in range(3)]

        def run(mesh):
            eng = StreamingTransferEngine(
                model_folder, checkpoint=-1, slots=8, max_seq_len=8,
                segment_steps=4, admit_size=4, greedy=True, mesh=mesh,
                harvest_delay_s=0.0,
            )
            return eng, [eng.submit_midi(r) for r in reqs]

        _, single = run(None)
        mesh = make_mesh(jax.devices()[:4], tp=1)
        eng, sharded = run(mesh)
        for i, (a, b) in enumerate(zip(single, sharded)):
            assert set(a.tokens_by_class) == set(b.tokens_by_class)
            for c in a.tokens_by_class:
                np.testing.assert_array_equal(
                    a.tokens_by_class[c], b.tokens_by_class[c],
                    err_msg=f"request {i} class {c}",
                )
        shd = eng._state.seqs.sharding
        assert len(shd.device_set) == 4
        assert not shd.is_fully_replicated

    def test_mesh_tp2_engine_matches_single_device(self, model_folder):
        """tp=2 mesh (data=2 x model=2): params genuinely TP-sharded, the
        donated cycle program runs under GSPMD, and greedy transfers match
        the single-device engine token-for-token (the tiny model's logit
        gaps dwarf the psum reduction-order noise TP introduces)."""
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )
        from musicstyletransfer_tpu.parallel.mesh import AXIS_MODEL, make_mesh

        reqs = [_midi_bytes((42 + i, 47 + i)) for i in range(2)]

        def run(mesh):
            eng = StreamingTransferEngine(
                model_folder, checkpoint=-1, slots=8, max_seq_len=8,
                segment_steps=4, admit_size=4, greedy=True, mesh=mesh,
                harvest_delay_s=0.0,
            )
            return eng, [eng.submit_midi(r) for r in reqs]

        _, single = run(None)
        mesh = make_mesh(jax.devices()[:4], tp=2)
        eng, sharded = run(mesh)
        # The TP rules actually engaged: some param leaf is sharded over
        # the model axis (not a silent all-replicated fallback).
        def _spec_axes(sharding):
            axes = []
            for entry in tuple(getattr(sharding, "spec", ())):
                if entry is None:
                    continue
                axes.extend(entry if isinstance(entry, tuple) else (entry,))
            return axes

        leaves = jax.tree.leaves(eng.params)
        assert any(
            isinstance(x, jax.Array)
            and not x.sharding.is_fully_replicated
            and AXIS_MODEL in _spec_axes(x.sharding)
            for x in leaves
        ), "no param leaf carries the model axis"
        for i, (a, b) in enumerate(zip(single, sharded)):
            assert set(a.tokens_by_class) == set(b.tokens_by_class)
            for c in a.tokens_by_class:
                np.testing.assert_array_equal(
                    a.tokens_by_class[c], b.tokens_by_class[c],
                    err_msg=f"request {i} class {c}",
                )

    def test_mesh_slot_divisibility_checked(self, model_folder):
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )
        from musicstyletransfer_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(jax.devices()[:4], tp=1)
        with pytest.raises(ValueError, match="divide evenly"):
            StreamingTransferEngine(
                model_folder, checkpoint=-1, slots=6, max_seq_len=8,
                admit_size=2, mesh=mesh,
            )

    def test_mesh_without_data_axis_rejected(self, model_folder):
        """A mesh lacking the data axis must fail AT CONSTRUCTION with a
        descriptive error, not later as an opaque device_put failure
        inside the engine loop."""
        from jax.sharding import Mesh

        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
        with pytest.raises(ValueError, match="data"):
            StreamingTransferEngine(
                model_folder, checkpoint=-1, slots=8, max_seq_len=8,
                admit_size=2, mesh=mesh,
            )


class TestEngineServing:
    def test_threaded_loop_serves_concurrent_requests(self, model_folder):
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=8, max_seq_len=8,
            segment_steps=4, admit_size=8,
        )
        eng.start()
        try:
            n = 6
            done = threading.Event()
            out = []

            def cb(r):
                out.append(r)
                if len(out) >= n:
                    done.set()

            for i in range(n):
                eng.enqueue(_midi_bytes((50 + i, 60 + i)), cb)
            assert done.wait(timeout=120)
        finally:
            eng.stop()
        assert len(out) == n
        for r in out:
            assert not isinstance(r, Exception)
            assert set(r.midi_by_class) == {0, 1}
            for midi in r.midi_by_class.values():
                assert smf.parse_midifile(midi).resolution > 0
        snap = eng.stats.snapshot()
        assert snap["requests_served"] == n
        assert snap["latency_p50_ms"] > 0

    def test_default_admit_size_is_full_width(self, model_folder):
        """admit_size defaults to slots (full-width admission): the round-5
        overload curve measured narrow admission as the overload
        bottleneck, so the shipped default admits into every
        free slot per cycle. Explicit values still win."""
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=6, max_seq_len=8,
            segment_steps=4,
        )
        assert eng.admit_size == 6
        eng2 = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=6, max_seq_len=8,
            segment_steps=4, admit_size=2,
        )
        assert eng2.admit_size == 2

    def test_bounded_queue_sheds_with_overloaded_error(self, model_folder):
        """max_queue: past the bound, enqueue sheds — the callback fires
        immediately with EngineOverloaded, the request never queues, and
        the shed is counted. Queued (pre-bound) requests still serve."""
        from musicstyletransfer_tpu.inference.streaming import (
            EngineOverloaded,
            StreamingTransferEngine,
        )

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=4, max_seq_len=8,
            segment_steps=4, admit_size=4, max_queue=2,
        )
        # Engine NOT started: the queue cannot drain, so the bound is hit
        # deterministically on the third enqueue.
        results = {}

        def cb_for(i):
            return lambda r: results.setdefault(i, r)

        for i in range(4):
            eng.enqueue(_midi_bytes((50 + i,)), cb_for(i))
        # Requests 2 and 3 were shed synchronously.
        assert isinstance(results[2], EngineOverloaded)
        assert isinstance(results[3], EngineOverloaded)
        assert eng._queue.qsize() == 2
        assert eng.stats.snapshot()["requests_shed"] == 2

        # The surviving queued requests serve once the engine runs.
        eng.start()
        try:
            deadline = time.time() + 120
            while len(results) < 4 and time.time() < deadline:
                time.sleep(0.05)
        finally:
            eng.stop()
        for i in (0, 1):
            assert not isinstance(results[i], Exception), results[i]
            assert set(results[i].midi_by_class) == {0, 1}
        snap = eng.stats.snapshot()
        assert snap["requests_served"] == 2
        assert snap["requests_shed"] == 2

    def test_unbounded_queue_never_sheds(self, model_folder):
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=4, max_seq_len=8,
            segment_steps=4, admit_size=4,
        )
        for i in range(8):
            eng.enqueue(_midi_bytes((50 + i,)), lambda r: None)
        assert eng._queue.qsize() == 8
        assert eng.stats.snapshot()["requests_shed"] == 0

    def test_failure_fails_requests_fast(self, model_folder):
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=4, max_seq_len=8,
            segment_steps=2, admit_size=4,
        )
        boom = RuntimeError("injected")

        def exploding(*a, **k):
            raise boom

        eng._dispatch = exploding
        got = []
        ev = threading.Event()

        def cb(r):
            got.append(r)
            ev.set()

        eng.enqueue(_midi_bytes((60,)), cb)
        with pytest.raises(RuntimeError):
            eng.submit_midi(_midi_bytes((62,)))
        assert ev.wait(timeout=10)
        assert any(isinstance(g, Exception) for g in got)
        # Engine state was reset; slots all free again.
        assert sorted(eng._free_slots) == list(range(4))
        assert not eng._unit_by_slot

    def test_budget_and_eos_semantics(self, model_folder):
        """Generated rows never exceed the per-request budget and PAD
        follows completion (slot rows stay clean for reuse)."""
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=4, max_seq_len=8,
            segment_steps=4, admit_size=4,
        )
        midi = _midi_bytes((60, 64))
        m = len(eng._tokens_from_midi(midi))
        budget = min(2 * (m + 1), eng.t_gen)
        r = eng.submit_midi(midi)
        for c, toks in r.tokens_by_class.items():
            # melody tokens exclude specials; at most budget-1 generated.
            assert len(toks) <= budget - 1

    def test_dispatcher_throttles_at_completion_bound(self, model_folder):
        """With a harvest delay forcing the readout round trip to lag
        (a slow device link), the dispatcher must stop issuing cycles once
        every unit is past its budget bound instead of free-running
        no-op dispatches while waiting for the copy to land."""
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=4, max_seq_len=8,
            segment_steps=4, admit_size=4, harvest_delay_s=0.05,
        )
        midi = _midi_bytes((60, 64))
        m = len(eng._tokens_from_midi(midi))
        budget = min(2 * (m + 1), eng.t_gen)
        r = eng.submit_midi(midi)
        assert set(r.midi_by_class) == {0, 1}
        # One admit cycle at index 1; every unit's max_done_cycle is then
        # 1 + ceil(budget / segment_steps); dispatching past it could not
        # change any readout.
        assert eng._cycle_idx <= 1 + -(-budget // eng.segment_steps)

    def test_harvest_delay_calibration(self, model_folder):
        """Auto mode measures the fetch round trip: on CPU (microsecond
        fetches) it must calibrate to ZERO allowance — any fixed remote-link
        allowance here would tax every request's latency for nothing —
        and an explicit value must be honored verbatim."""
        from musicstyletransfer_tpu.inference.streaming import (
            StreamingTransferEngine,
        )

        eng = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=4, max_seq_len=8,
            segment_steps=4, admit_size=4,
        )
        assert eng._harvest_delay is None  # calibrated lazily
        eng._ensure_state()
        assert eng._harvest_delay == 0.0

        eng2 = StreamingTransferEngine(
            model_folder, checkpoint=-1, slots=4, max_seq_len=8,
            segment_steps=4, admit_size=4, harvest_delay_s=0.042,
        )
        eng2._ensure_state()
        assert eng2._harvest_delay == 0.042
        # Explicit delay PINS: no adaptation controller attached.
        assert eng2._delay_ctl is None
        # Auto mode attaches one seeded with the calibrated value, and a
        # real served request must leave the delay adapted but sane
        # (on CPU every fetch lands instantly -> decay-only, stays ~0).
        assert eng._delay_ctl is not None
        eng.submit_midi(_midi_bytes((60, 64)))
        assert 0.0 <= eng._harvest_delay <= eng._delay_ctl.CAP

    def test_harvest_delay_controller_regimes(self):
        """The window-drift controller's three regimes: a genuinely
        unlanded copy (large block) RE-CALIBRATES to the observed trip in
        one observation; contention-band blocks (the noisy 5-20 ms fetch
        costs measured under load, scripts/harvest-ab.py) HOLD — a plain
        AIMD attack here ratcheted 69 -> 127 ms in the same-window A/B
        and was rejected; a streak of prompt fetches probes DOWN; the cap
        bounds pathological windows."""
        from musicstyletransfer_tpu.inference.streaming import (
            HarvestDelayController,
        )

        c = HarvestDelayController(0.028)
        # The link degrades: copies land 1.3 s after dispatch, harvests at
        # elapsed=30ms block the remaining 1.27 s. ONE such block is
        # indistinguishable from a lone host stall -> hold; the SECOND
        # consecutive recalibrates to the startup formula on the
        # observed trip.
        assert c.observe(1.27, 0.030) == pytest.approx(0.028)
        d = c.observe(1.27, 0.030)
        assert d == pytest.approx(1.1 * 1.3 + 0.003)
        # A lone large stall on a healthy window does NOT attack (the
        # v3 guard against the healthy-window upward spiral): one 60 ms
        # block at a 59 ms delay, then prompt fetches -> delay held.
        c_h = HarvestDelayController(0.059)
        c_h.observe(0.060, 0.065)
        c_h.observe(0.0001, 0.060)
        assert c_h.delay == pytest.approx(0.059)
        # Contention band (e.g. 15 ms blocks at a 69 ms delay): HOLD.
        c2 = HarvestDelayController(0.0695)
        for _ in range(100):
            c2.observe(0.015, 0.070)
        assert c2.delay == pytest.approx(0.0695)
        # Recovered window: prompt-fetch streaks probe down x0.9 per
        # STREAK harvests; from the degraded 1.43 s the delay walks back
        # under 30 ms within ~40 probes.
        for _ in range(c.STREAK * 40):
            d = c.observe(0.0001, c.delay)
        assert d < 0.030
        # A lone prompt fetch (streak broken by contention) holds.
        c3 = HarvestDelayController(0.0695)
        for i in range(100):
            c3.observe(0.0001 if i % 2 else 0.005, 0.070)
        assert c3.delay == pytest.approx(0.0695)
        # The promptness threshold scales with the delay: 20 ms
        # contention blocks ARE prompt against an 807 ms stale
        # allowance (the recorded worst case), so recovery proceeds.
        c4 = HarvestDelayController(0.807)
        for _ in range(c4.STREAK):
            c4.observe(0.020, 0.81)
        assert c4.delay == pytest.approx(0.807 * 0.85)
        # Cap: even absurd blocks cannot push past serving viability.
        c.observe(60.0, 0.030)
        c.observe(60.0, 0.030)
        assert c.delay == c.CAP
