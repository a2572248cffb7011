"""Slot-based continuous batching: iteration-level request admission.

The micro-batch service (inference/service.py) forms a whole batch, runs
the full fused transfer call, and only then admits new work — a request
arriving just after a batch starts waits out the entire previous cycle
(~a full decode budget) before its own begins. This engine replaces the
batch boundary with SLOTS: a fixed number of independent generation lanes
whose KV caches live in one set of donated device buffers, advanced
``segment_steps`` decode positions per dispatch. New requests are encoded
and spliced into free slots in the SAME dispatch, so admission granularity
is one segment (~a few ms of decode) instead of one batch.

This is vLLM-style continuous batching under jit: static
shapes everywhere (S slots, fixed cache length, fixed admit width), per-row
ragged positions (models/transformer.py::step_ragged) instead of dynamic
batch membership, and state that never leaves the device.

Dispatch economics (an early iteration of this engine was several times
slower than designed, entirely from per-cycle host<->device call
overhead):

- uploads and execute dispatches are ASYNC (cheap on the host); only a
  host FETCH of fresh results pays a device->host round trip. So the
  engine is built to never block on a fetch:
- ONE jitted program per cycle: admission (encode + cache splice) and the
  K-step decode scan are fused into one dispatch. All admission operands
  travel as a single packed int32 array; no-admit cycles reuse a cached
  device-resident placeholder (zero uploads). The PRNG key lives IN the
  donated device state and the temperature is uploaded once;
- each cycle's readout (done mask + token rows packed in one int16
  buffer — a dtype-narrowed copy, so it cannot alias the donated state
  the next cycle consumes) starts a device->host copy IMMEDIATELY via
  copy_to_host_async; the loop harvests the NEWEST readout whose copy has
  had ``harvest_delay_s`` to land, dropping older ones (a done flag stays
  set in every later readout until the slot is reused, so newer strictly
  dominates). The dispatcher thus free-runs at device/dispatch speed and
  the round trip costs latency (~one delay) but never throughput;
- harvesting a late readout needs an admission-epoch guard: a slot freed
  by cycle N's harvest can be re-admitted in cycle N+k, whose stale done
  flag from cycles <N+k must not complete the new unit
  (``_Unit.admit_cycle``). Symmetrically the dispatcher stops issuing
  cycles once every unit is past its budget-implied completion bound
  (``_Unit.max_done_cycle``) — further dispatches could not change any
  readout.

Semantics match the service path: each request is style-transferred into
EVERY target class (reference sampler.py:93-104 — the encoder also sees
the target class), deterministic encode (z = mu), per-sequence EOS stop,
generation budget 2x the input length (reference sampler.py:164). A
request completes when all of its per-class units do.

Trade-off: the engine is built to match the micro-batch service's
sustained throughput with a lower median request latency under open-loop
arrivals; its capacity scales with ``slots``. The batch service remains
the pick for closed-loop bulk transfers (directory mode), where latency
is irrelevant. (Not yet measured on the GPU: PERF.md.)

Multi-chip: pass ``mesh=`` (same API as ``StyleTransferService``) to run
the engine sharded — slots over the data axis (capacity then scales with
chips x slots-per-chip under the same host loop), params per the TP
rules. Token-identical to the single-device engine
(tests/test_streaming.py::TestStreamingMesh).
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..midi import smf
from ..midi.codec import MelodyWriter, melody_from_ids, tokenize_track
from ..midi.vocab import EOS_ID, PAD_ID, SOS_ID
from ..models.transformer import Cache
from ..models.vae import StyleVAE
from .decode import _filter_logits
from .sampler import load_inference_model
from .service import ServiceStats, TransferResult


class EngineOverloaded(RuntimeError):
    """Raised (via the request callback) when a bounded-queue engine sheds
    a request at admission. Shedding is the engine's overload policy: an
    open-loop offered rate above capacity otherwise grows the host queue
    (and every queued request's latency) without bound — the round-4
    saturation study measured exactly that tail. Callers get an immediate,
    cheap failure they can retry against another replica instead of a
    timeout."""


class HarvestDelayController:
    """Window-drift controller for the readout-harvest allowance.

    The startup calibration (``_ensure_state``) measures the fetch round
    trip ONCE, but a remote or contended device link can drift (it was
    built against a link whose trip swung from ~28 ms to ~1.3 s). A
    FIXED allowance mis-tunes in both directions after such a shift: too
    short and every harvest's ``np.asarray`` BLOCKS the dispatch loop
    (the engine degrades to synchronous per-cycle fetching); too long
    and every request pays the stale latency forever. The signal used is
    the time the harvest fetch actually blocked. Three regimes per
    observation, because under load that signal is NOISY — concurrent
    async readout copies contend and produce persistent 5-20 ms blocks
    even for landed copies (a plain AIMD attack on any block ratcheted
    the delay upward and was rejected):

    - block > max(50 ms, 50% of delay) for ``ATTACK`` CONSECUTIVE
      harvests: the window genuinely degraded — RE-CALIBRATE to the last
      observed trip (elapsed + block, the startup formula). Both guards
      exist because the block signal is noisy UP TO TENS OF MS on
      healthy windows (GIL/host stalls on already-landed copies): a
      controller attacking at max(10 ms, 0.3x) spiraled 59 -> 112 ms
      in an A/B — each spurious attack raises the delay,
      which raises every later readout's ``elapsed``, which raises the
      next recalibration target. Genuine degradations block hundreds of
      ms on EVERY harvest and pass both guards immediately;
    - block < max(2 ms, 5% of delay) — the copy landed well within the
      allowance — for ``STREAK`` consecutive harvests: the window may
      have recovered, probe DOWN x0.85. The threshold scales with the
      delay because a 20 ms contention block IS prompt against an 807 ms
      stale allowance (a startup calibration that caught a degraded
      moment would otherwise tax every later request);
    - anything between: contention noise — hold.

    Explicit ``harvest_delay_s`` (CLI ``--harvest-delay-ms``) pins the
    delay and disables adaptation.
    """

    CAP = 2.0  # s; past this the window is beyond serving viability
    STREAK = 10
    ATTACK = 2

    def __init__(self, initial: float):
        self.delay = float(initial)
        self._streak = 0
        self._attack = 0

    def observe(self, block_s: float, elapsed_s: float) -> float:
        """Update from one harvest: ``block_s`` is the measured fetch
        block, ``elapsed_s`` the readout's age since dispatch (their sum
        bounds the copy's true round trip). Returns the new delay."""
        if block_s > max(0.050, 0.5 * self.delay):
            self._streak = 0
            self._attack += 1
            if self._attack >= self.ATTACK:
                self.delay = min(self.CAP,
                                 1.1 * (elapsed_s + block_s) + 0.003)
                self._attack = 0
            return self.delay
        self._attack = 0
        if block_s < max(0.002, 0.05 * self.delay):
            self._streak += 1
            if self._streak >= self.STREAK:
                self.delay *= 0.85
                self._streak = 0
        else:
            self._streak = 0
        return self.delay


class SlotState(NamedTuple):
    """Device-resident engine state (donated through every dispatch)."""

    cache: Cache  # per-layer (k, v): [S, T_cache, H, hd]
    seqs: jax.Array  # [S, T_gen] int32; position 0 = SOS
    scores: jax.Array  # [S] f32 accumulated -log p
    t: jax.Array  # [S] int32 next cache position to write
    budget: jax.Array  # [S] int32 generation budget (max positions)
    done: jax.Array  # [S] bool
    occupied: jax.Array  # [S] bool
    classes: jax.Array  # [S] int32 target class per slot (per-step cond.)
    rng: jax.Array  # PRNG key threaded through cycles (never leaves device)


@functools.partial(jax.jit, static_argnums=(0,),
                   static_argnames=("slots", "t_gen", "t_cache", "seed"))
def _init_state(model: StyleVAE, params, slots: int, t_gen: int,
                t_cache: int, seed: int = 0) -> SlotState:
    dummy_z = jnp.zeros(
        (slots, model.config.encoder_config.latent_dim), jnp.float32
    )
    dummy_classes = jnp.zeros((slots,), jnp.int32)
    cache = model.decode_prefill(params, dummy_z, dummy_classes, t_cache)
    return SlotState(
        cache=cache,
        seqs=jnp.full((slots, t_gen), PAD_ID, jnp.int32).at[:, 0].set(SOS_ID),
        scores=jnp.zeros((slots,), jnp.float32),
        t=jnp.ones((slots,), jnp.int32),
        budget=jnp.zeros((slots,), jnp.int32),
        done=jnp.zeros((slots,), bool),
        occupied=jnp.zeros((slots,), bool),
        classes=jnp.zeros((slots,), jnp.int32),
        rng=jax.random.key(seed),
    )


def _admit_into(
    model: StyleVAE,
    params,
    state: SlotState,
    tokens: jax.Array,  # [A, L+1] SOS-prefixed
    seq_lens: jax.Array,  # [A]
    classes: jax.Array,  # [A] target class per unit
    slot_sel: jax.Array,  # [A, S] f32 one-hot; all-zero row = padding
    budgets: jax.Array,  # [A] int32
) -> SlotState:
    """Encode up to A new (request, class) units and splice them into the
    selected slots: write the conditioning state's position-0 K/V, reset the
    slot's token row / score / position / budget. ``slot_sel`` rows are
    one-hot over DISTINCT slots (host-guaranteed); padding rows are all-zero
    so they select and reset nothing. Traced inside ``_cycle_program``.
    """
    S = state.seqs.shape[0]
    mu, _ = model.encode(params, tokens, seq_lens, classes)
    # Position-0 K/V of each unit's conditioning state, via a 1-position
    # prefill on a scratch cache (same math as the batch path's prefill).
    small = model.decode_prefill(params, mu, classes, 1)
    written = jnp.sum(slot_sel, axis=0) > 0.0  # [S]

    new_cache = []
    for (ck, cv), (sk, sv) in zip(state.cache, small):
        # One-hot matmul scatter (collision-free by contract): exact — each
        # written slot row is 1.0 x one source row, f32 accumulation.
        def splice(big, small_kv):
            A = small_kv.shape[0]
            flat = small_kv[:, 0].reshape(A, -1).astype(jnp.float32)
            rows = jnp.dot(slot_sel.T, flat,
                           preferred_element_type=jnp.float32)
            rows = rows.reshape((S,) + big.shape[2:]).astype(big.dtype)
            row0 = jnp.where(written[:, None, None], rows, big[:, 0])
            return big.at[:, 0].set(row0)

        new_cache.append((splice(ck, sk), splice(cv, sv)))

    sos_row = jnp.full_like(state.seqs[0], PAD_ID).at[0].set(SOS_ID)
    new_budget = jnp.dot(
        slot_sel.T, budgets.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)
    new_classes = jnp.dot(
        slot_sel.T, classes.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)
    return SlotState(
        cache=tuple(new_cache),
        seqs=jnp.where(written[:, None], sos_row[None, :], state.seqs),
        scores=jnp.where(written, 0.0, state.scores),
        t=jnp.where(written, 1, state.t),
        budget=jnp.where(written, new_budget, state.budget),
        done=jnp.where(written, False, state.done),
        occupied=state.occupied | written,
        classes=jnp.where(written, new_classes, state.classes),
        rng=state.rng,
    )


@functools.partial(
    jax.jit, static_argnums=(0,), donate_argnums=(2,),
    static_argnames=("segment_steps", "top_k", "top_p", "greedy", "admit"),
)
def _cycle_program(
    model: StyleVAE,
    params,
    state: SlotState,
    admission: jax.Array,  # [A, L+5] packed int32 (see below)
    temperature: jax.Array,
    segment_steps: int,
    top_k: int = 0,
    top_p: float = 0.0,
    greedy: bool = False,
    admit: bool = True,
) -> Tuple[SlotState, jax.Array]:
    """One engine cycle in ONE dispatch: (optionally) admit new units, then
    advance every live slot ``segment_steps`` decode positions.

    ``admission`` packs every admission operand into ONE int32 array so an
    admit cycle costs a single host->device transfer (columns: SOS-prefixed
    tokens [0:L+1], then seq_len, class, budget, slot index; slot index -1
    marks a padding row — its one-hot is all-zero so it splices nothing).
    Done/empty slots still ride the batched math (static shapes) but their
    writes are masked out. Returns (state, readout) where readout packs the
    done mask (column 0) and the token rows into one int16 [S, 1+T_gen]
    buffer — a dtype-NARROWED copy, guaranteed distinct from the donated
    state buffers, so the host can fetch cycle N's readout after
    dispatching cycle N+1. ``admit=False`` compiles a second variant with
    the encoder sliced out for idle-admission cycles.
    """
    S, T_gen = state.seqs.shape
    if admit:
        L1 = admission.shape[1] - 4  # L+1 token columns
        slot_sel = jax.nn.one_hot(  # -1 (padding) -> all-zero row
            admission[:, L1 + 3], S, dtype=jnp.float32
        )
        state = _admit_into(
            model, params, state,
            tokens=admission[:, :L1],
            seq_lens=admission[:, L1],
            classes=admission[:, L1 + 1],
            slot_sel=slot_sel,
            budgets=admission[:, L1 + 2],
        )
    positions = jnp.arange(T_gen)

    def body(st: SlotState, key):
        active = st.occupied & ~st.done
        last = jnp.take_along_axis(st.seqs, (st.t - 1)[:, None], axis=1)[:, 0]
        logits, cache = model.decode_step_ragged(params, last, st.cache,
                                                 st.t, st.classes)
        filtered = _filter_logits(logits / temperature, top_k, top_p)
        if greedy:
            nxt = jnp.argmax(filtered, axis=-1).astype(jnp.int32)
        else:
            nxt = jax.random.categorical(key, filtered).astype(jnp.int32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        tok_logp = jnp.take_along_axis(logp, nxt[:, None], axis=-1)[:, 0]
        scores = st.scores + jnp.where(active, -tok_logp, 0.0)
        write = active[:, None] & (positions[None, :] == st.t[:, None])
        seqs = jnp.where(write, nxt[:, None], st.seqs)
        done = st.done | (
            active & ((nxt == EOS_ID) | (st.t + 1 >= st.budget))
        )
        t = jnp.where(active, st.t + 1, st.t)
        return SlotState(cache, seqs, scores, t, st.budget, done,
                         st.occupied, st.classes, st.rng), None

    keys = jax.random.split(state.rng, segment_steps + 1)
    state = state._replace(rng=keys[0])
    state, _ = jax.lax.scan(body, state, keys[1:])
    readout = jnp.concatenate(
        [state.done.astype(jnp.int16)[:, None], state.seqs.astype(jnp.int16)],
        axis=1,
    )
    return state, readout


@dataclasses.dataclass
class _Unit:
    """One (request, target-class) generation lane."""

    request: "_Request"
    target_class: int
    admit_cycle: int  # first cycle this unit advanced in (harvest guard)
    # Upper bound on the cycle whose readout must show this unit done (the
    # budget exhausts then even without EOS): the dispatcher stops issuing
    # cycles once every unit is past its bound — further dispatches could
    # not change any readout.
    max_done_cycle: int = 0


@dataclasses.dataclass
class _Request:
    tokens: np.ndarray
    callback: Callable
    t0: float
    results_tokens: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict
    )
    pending_units: int = 0


class StreamingTransferEngine:
    """Continuous-batching style-transfer engine (see module docstring).

    Programmatic use::

        eng = StreamingTransferEngine(model_folder, checkpoint=-1)
        eng.start()
        eng.enqueue(midi_bytes, callback)   # callback(TransferResult)
        ...
        eng.stop()

    ``submit_midi`` is the blocking single-request convenience path.
    Construction mirrors ``StyleTransferService`` so the serve CLI can pick
    either engine behind the same flags.
    """

    def __init__(
        self,
        model_folder: str,
        checkpoint: Optional[int] = -1,
        *,
        slots: int = 128,
        max_seq_len: int = 64,
        segment_steps: int = 32,
        admit_size: Optional[int] = None,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 0.0,
        greedy: bool = False,
        seed: int = 0,
        harvest_delay_s: Optional[float] = None,
        mesh=None,
        max_queue: int = 0,
    ):
        """``mesh``: optional jax.sharding.Mesh — run the engine sharded:
        slots ride the data axis (each chip owns ``slots/dp`` independent
        lanes of the SAME donated cycle program; GSPMD propagates the
        sharding through the scan), params are placed once per the TP
        rules (replicated at tp=1), and per-cycle uploads (admission pack,
        temperature) are replicated. Same API as
        ``StyleTransferService(mesh=...)``. None = single-device.

        ``max_queue``: bound on the host request queue (0 = unbounded,
        the historical behavior). When the bound is reached, ``enqueue``
        SHEDS the request: the callback fires immediately with an
        ``EngineOverloaded`` exception and the request never occupies
        queue or slot resources. The bound is approximate under
        concurrent enqueuers (qsize races the engine thread by design —
        an exact bound would serialize admission against the hot loop).

        ``admit_size``: max units admitted per cycle — a STATIC compiled
        shape (the packed admission array is [admit_size, L+5]).
        Default None = ``slots``, i.e. full-width admission: an overload
        curve measured narrow admission as THE overload bottleneck (at
        1.2-1.5x offered load admit=16 left the engine admission-limited
        while admit=slots=128 kept up), and at low load the width is
        latency-neutral (padding rows splice nothing; the wider upload is
        ~35 KB, async). Narrower values remain available for hosts where the
        admission pack's O(admit_size) host work matters."""
        self.model, self.params = load_inference_model(
            model_folder, checkpoint, max_seq_len
        )
        dc = self.model.config.decoder_config
        if getattr(dc, "decoder_type", "transformer") == "lstm":
            raise ValueError(
                "streaming engine requires the transformer decoder "
                "(per-slot ragged KV positions); use StyleTransferService "
                "for the LSTM decoder"
            )
        self.num_classes = dc.num_classes
        self.slots = int(slots)
        self.max_seq_len = int(max_seq_len)
        self.segment_steps = int(segment_steps)
        self.admit_size = int(admit_size) if admit_size else self.slots
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.greedy = bool(greedy)
        if self.slots < self.num_classes or self.admit_size < self.num_classes:
            raise ValueError(
                f"slots ({self.slots}) and admit_size ({self.admit_size}) "
                f"must each cover one request's {self.num_classes} "
                f"per-class units"
            )
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import AXIS_DATA

            if AXIS_DATA not in mesh.shape:
                # Fail at construction with a clear message: a mesh without
                # a data axis would default dp=1 here and only surface much
                # later as an opaque device_put error inside the engine
                # loop (routed through _fail_all).
                raise ValueError(
                    f"streaming engine mesh must have a {AXIS_DATA!r} axis "
                    f"(slots ride it); got axes {tuple(mesh.shape)}"
                )
            dp = mesh.shape[AXIS_DATA]
            if self.slots % dp != 0:
                raise ValueError(
                    f"slots ({self.slots}) must divide evenly over the "
                    f"mesh's data axis ({dp})"
                )
            from .sharded import prepare_params

            self.params = prepare_params(self.params, mesh)
        # Budget/positions mirror decode_sampled: seqs rows hold up to
        # 2*(L+1) positions (SOS + generated), the cache one extra for the
        # conditioning state at position 0.
        self.t_gen = 2 * (self.max_seq_len + 1)
        self.t_cache = self.t_gen + 1
        # The per-step PRNG key lives inside the device state (SlotState.rng)
        # so drawing it costs no per-cycle transfer or host dispatch.
        self._seed = int(seed)
        self._writer = MelodyWriter()
        self.max_queue = int(max_queue)
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.stats = ServiceStats()
        self._device = jax.config.jax_default_device
        self._unit_by_slot: Dict[int, _Unit] = {}
        self._free_slots: List[int] = list(range(self.slots))
        self._state: Optional[SlotState] = None
        self._cycle_idx = 0
        # In-flight readouts, oldest first: (cycle_idx, packed int16
        # [S, 1+T_gen] device array, dispatch wall time). Each dispatch
        # starts an ASYNC device->host copy of its readout; the loop
        # harvests the NEWEST entry whose copy has had ``_harvest_delay``
        # seconds to land (older entries are strictly dominated — a done
        # flag stays set in every later readout until the slot is reused,
        # and its token row no longer changes). The list self-bounds at
        # ~cycle_rate x delay entries because every pass drops all entries
        # at-or-before the harvested one.
        self._pending: List[Tuple[int, jax.Array, float]] = []
        # None = auto: _ensure_state calibrates by timing one real fetch
        # round trip (a platform heuristic would wrongly tax a locally
        # attached device, where fetches are near-free, with a remote
        # link's allowance).
        self._harvest_delay: Optional[float] = (
            None if harvest_delay_s is None else float(harvest_delay_s)
        )
        # Auto mode adapts the allowance to window drift (attached after
        # calibration); an explicit harvest_delay_s pins it.
        self._delay_ctl: Optional[HarvestDelayController] = None
        # One-time device constants, uploaded lazily by _ensure_state (in
        # the engine thread's device context): the no-admit placeholder
        # admission array and the temperature scalar. Caching them makes a
        # no-admit cycle upload NOTHING.
        self._empty_admission_dev: Optional[jax.Array] = None
        self._temp_dev: Optional[jax.Array] = None

    # -- request preparation (same semantics as the batch service) -------

    def _tokens_from_midi(self, midi_bytes: bytes) -> np.ndarray:
        mf = smf.parse_midifile(midi_bytes)
        for track in mf.tracks:
            toks = tokenize_track(track)
            if len(toks):
                return toks[: self.max_seq_len]
        raise ValueError("no note events in MIDI request")

    # -- public API -------------------------------------------------------

    def enqueue(self, midi_bytes: bytes, callback: Callable) -> None:
        """Queue a request; ``callback(TransferResult)`` fires when every
        target class has been generated. On a failed cycle the callback
        receives the Exception (same contract as the service). With
        ``max_queue`` set and the queue full, the request is shed: the
        callback fires synchronously with ``EngineOverloaded``."""
        if self.max_queue > 0 and self._queue.qsize() >= self.max_queue:
            self.stats.record_shed()
            callback(EngineOverloaded(
                f"request queue at bound ({self.max_queue}); shedding"))
            return
        self._queue.put(
            (self._tokens_from_midi(midi_bytes), callback, time.perf_counter())
        )

    def submit_midi(self, midi_bytes: bytes) -> TransferResult:
        """Blocking single-request convenience path (engine must be
        running, or this call drives the loop inline when it is not)."""
        box: List = []
        ev = threading.Event()

        def cb(result):
            box.append(result)
            ev.set()

        self.enqueue(midi_bytes, cb)
        if not self.is_serving():
            self._drive_until(ev)
        ev.wait(timeout=300)
        if not box:
            raise TimeoutError("streaming transfer did not complete")
        if isinstance(box[0], Exception):
            raise box[0]
        return box[0]

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def is_serving(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- engine cycle ------------------------------------------------------

    def _ensure_state(self) -> None:
        if self._state is None:
            self._state = _init_state(
                self.model, self.params, slots=self.slots, t_gen=self.t_gen,
                t_cache=self.t_cache, seed=self._seed,
            )
            if self.mesh is not None:
                # Shard the slot axis once; every later cycle's donated
                # in/out buffers inherit these shardings via GSPMD
                # propagation (pinned by tests/test_streaming.py).
                from ..parallel.mesh import batch_sharding, replicated

                bs, st = batch_sharding(self.mesh), self._state
                self._state = SlotState(
                    cache=jax.device_put(st.cache, bs),
                    seqs=jax.device_put(st.seqs, bs),
                    scores=jax.device_put(st.scores, bs),
                    t=jax.device_put(st.t, bs),
                    budget=jax.device_put(st.budget, bs),
                    done=jax.device_put(st.done, bs),
                    occupied=jax.device_put(st.occupied, bs),
                    classes=jax.device_put(st.classes, bs),
                    rng=jax.device_put(st.rng, replicated(self.mesh)),
                )
            if self._harvest_delay is None:
                # Calibrate the readout allowance from MEASURED fetch
                # round trips: the first fetch absorbs _init_state's
                # compile+execute; each subsequent fetch of a different
                # (still unfetched) leaf of the same finished program
                # times a pure device->host trip. Median of three — a
                # single sample can catch a hiccup and tax every later
                # harvest. Tens of ms over a remote link, microseconds
                # locally attached — where any fixed allowance would cost
                # every request latency for nothing.
                np.asarray(self._state.done)
                trips = []
                for leaf in (self._state.t, self._state.budget,
                             self._state.scores):
                    t0 = time.perf_counter()
                    np.asarray(leaf)
                    trips.append(time.perf_counter() - t0)
                rt = float(np.median(trips))
                self._harvest_delay = (
                    0.0 if rt < 1e-3 else min(0.25, 1.1 * rt + 0.003)
                )
                self._delay_ctl = HarvestDelayController(self._harvest_delay)
        if self._empty_admission_dev is None:
            self._empty_admission_dev = self._put(self._pack_admission([]))
            self._temp_dev = self._put(
                np.asarray(self.temperature, np.float32)
            )

    def _put(self, host_arr: np.ndarray) -> jax.Array:
        """Upload one host array: replicated over the mesh when sharded
        (admission operands are small and every shard's program reads
        them), plain device transfer otherwise."""
        if self.mesh is None:
            return jnp.asarray(host_arr)
        from ..parallel.mesh import replicated

        return jax.device_put(host_arr, replicated(self.mesh))

    def _collect_arrivals(self, block: bool) -> List[Tuple]:
        """Pop queued requests that fit the free slots / admit width."""
        arrivals: List[Tuple] = []
        budget_slots = len(self._free_slots)
        budget_units = self.admit_size
        while (budget_slots >= self.num_classes
               and budget_units >= self.num_classes):
            try:
                item = self._queue.get(
                    timeout=0.05 if (block and not arrivals) else 0.0
                )
            except queue.Empty:
                break
            arrivals.append(item)
            budget_slots -= self.num_classes
            budget_units -= self.num_classes
        return arrivals

    def _pack_admission(self, rows: List[Tuple]) -> np.ndarray:
        """Build the packed admission array (layout: _cycle_program's
        docstring). ``rows`` is a list of (tokens, seq_len, class, budget,
        slot) to fill from row 0; remaining rows are padding (slot index
        -1 -> all-zero one-hot -> splices nothing)."""
        A, L = self.admit_size, self.max_seq_len
        packed = np.full((A, L + 5), PAD_ID, np.int32)
        packed[:, 0] = SOS_ID
        packed[:, L + 1] = 1  # seq_len (SOS only)
        packed[:, L + 2] = 0  # class
        packed[:, L + 3] = 0  # budget
        packed[:, L + 4] = -1  # slot: padding rows select nothing
        for r, (toks, seq_len, cls, budget, slot) in enumerate(rows):
            packed[r, 1:seq_len] = toks[: seq_len - 1]
            packed[r, L + 1] = seq_len
            packed[r, L + 2] = cls
            packed[r, L + 3] = budget
            packed[r, L + 4] = slot
        return packed

    def _register(self, arrivals: List[Tuple]) -> np.ndarray:
        """Claim slots for the arrivals and build the packed admission
        array. Every unit is registered into ``_unit_by_slot`` BEFORE any
        device work happens, so a dispatch that raises still fails these
        requests through ``_fail_all`` (their callbacks always fire)."""
        L = self.max_seq_len
        rows: List[Tuple] = []
        for toks, callback, t0 in arrivals:
            req = _Request(tokens=toks, callback=callback, t0=t0,
                           pending_units=self.num_classes)
            m = min(len(toks), L)
            for c in range(self.num_classes):
                slot = self._free_slots.pop()
                # Budget: 2x the input length (reference sampler.py:164),
                # bounded by the row size; counts positions incl. SOS.
                budget = min(2 * (m + 1), self.t_gen)
                self._unit_by_slot[slot] = _Unit(
                    req, c, self._cycle_idx,
                    max_done_cycle=self._cycle_idx
                    + -(-budget // self.segment_steps),
                )
                rows.append((toks, m + 1, c, budget, slot))
        return self._pack_admission(rows)

    def _dispatch(self, admission: Optional[np.ndarray]) -> None:
        """Dispatch ONE fused cycle (admissions + segment_steps decode).
        ``admission`` is the packed array from ``_register`` (or None for
        a no-admit cycle, which reuses the cached device placeholder and
        uploads nothing). The readout's device->host copy starts
        immediately (async); ``_harvest_ready`` picks it up once the round
        trip has had time to land."""
        admit = admission is not None
        admission_dev = (
            self._put(admission) if admit else self._empty_admission_dev
        )
        state, readout = _cycle_program(
            self.model, self.params, self._state, admission_dev,
            self._temp_dev,
            segment_steps=self.segment_steps,
            top_k=self.top_k, top_p=self.top_p, greedy=self.greedy,
            admit=admit,
        )
        self._state = state
        try:
            readout.copy_to_host_async()
        except Exception:  # pragma: no cover - backends without async copy
            pass  # np.asarray at harvest will block instead
        self._pending.append((self._cycle_idx, readout, time.perf_counter()))

    def _needs_decode(self) -> bool:
        """True while some unit's budget could still be advancing — past
        every unit's ``max_done_cycle`` further dispatches are no-ops."""
        return any(
            u.max_done_cycle > self._cycle_idx
            for u in self._unit_by_slot.values()
        )

    def _harvest_ready(self) -> bool:
        """Harvest the newest pending readout whose async copy has had
        ``_harvest_delay`` seconds to land; drop the (dominated) older
        ones. Returns True when a harvest happened."""
        if not self._pending:
            return False
        now = time.perf_counter()
        ready = -1
        for i in range(len(self._pending) - 1, -1, -1):
            if now - self._pending[i][2] >= self._harvest_delay:
                ready = i
                break
        if ready < 0:
            return False
        cycle_idx, readout, t_dispatch = self._pending[ready]
        del self._pending[: ready + 1]
        self._harvest(cycle_idx, readout, t_dispatch)
        return True

    def _harvest(self, cycle_idx: int, readout_dev,
                 t_dispatch: Optional[float] = None) -> None:
        """Fetch one cycle's packed readout (ONE device->host round trip: done
        mask in column 0, token rows after); release finished slots; fire
        callbacks for finished requests. Skips slots admitted AFTER
        ``cycle_idx`` — their done flag in this readout belongs to the
        slot's previous occupant."""
        t_fetch = time.perf_counter()
        readout = np.asarray(readout_dev)
        if self._delay_ctl is not None and t_dispatch is not None:
            now = time.perf_counter()
            self._harvest_delay = self._delay_ctl.observe(
                now - t_fetch, t_fetch - t_dispatch
            )
        done = readout[:, 0].astype(bool)
        finished = [
            s for s, u in list(self._unit_by_slot.items())
            if done[s] and u.admit_cycle <= cycle_idx
        ]
        if not finished:
            self.stats.record_batch(
                fill=len(self._unit_by_slot),
                queue_depth_after=self._queue.qsize(), latencies_ms=[],
                served=0,
            )
            return
        seqs = readout[:, 1:].astype(np.int32)
        now = time.perf_counter()
        latencies: List[float] = []
        for s in finished:
            unit = self._unit_by_slot.pop(s)
            self._free_slots.append(s)
            unit.request.results_tokens[unit.target_class] = seqs[s]
            unit.request.pending_units -= 1
            if unit.request.pending_units == 0:
                req = unit.request
                latencies.append((now - req.t0) * 1e3)
                try:
                    req.callback(self._result_of(req))
                except Exception:
                    import logging

                    self.stats.record_error()
                    logging.getLogger(__name__).exception(
                        "streaming result callback raised"
                    )
        self.stats.record_batch(
            fill=len(self._unit_by_slot) + len(finished),
            queue_depth_after=self._queue.qsize(), latencies_ms=latencies,
            served=len(latencies),
        )

    def _result_of(self, req: _Request) -> TransferResult:
        midi_by_class, tokens_by_class = {}, {}
        for c, row in req.results_tokens.items():
            melody = melody_from_ids(row)
            tokens_by_class[c] = melody.tokens
            midi_by_class[c] = smf.dump_midifile(
                self._writer.to_midifile(melody)
            )
        return TransferResult(midi_by_class, tokens_by_class)

    def _cycle(self, block: bool) -> bool:
        """One host pass: harvest any landed readout FIRST (frees slots for
        this pass's admissions), then collect arrivals and dispatch the
        next fused cycle. The dispatcher free-runs at dispatch speed
        (dispatches and uploads are async;
        only fetches pay the round trip) until every unit is past its
        completion bound, then idles waiting for the last readout's copy
        to land. Returns True when any work happened; blocks briefly for
        arrivals only when nothing at all is in flight."""
        self._ensure_state()
        harvested = self._harvest_ready()
        idle = not self._unit_by_slot and not self._pending
        arrivals = self._collect_arrivals(block=block and idle)
        if arrivals or self._needs_decode():
            self._cycle_idx += 1
            admission = self._register(arrivals) if arrivals else None
            self._dispatch(admission)
            return True
        if harvested:
            return True
        if self._pending:
            # Decode is ahead of the harvest round trip: nothing to
            # dispatch, the newest readout's copy hasn't landed yet.
            time.sleep(0.001)
        return False

    def _fail_all(self, exc: Exception) -> None:
        """Cycle failure: fail every in-flight and queued request fast
        (service contract), reset the engine state. Each request's callback
        fires ONCE even when several of its per-class units are in
        flight."""
        failed = {id(u.request): u.request for u in self._unit_by_slot.values()}
        for req in failed.values():
            req.pending_units = -1  # mark failed
            try:
                req.callback(exc)
            except Exception:
                pass
        self._unit_by_slot.clear()
        self._free_slots = list(range(self.slots))
        self._state = None
        self._pending.clear()
        while True:
            try:
                _, callback, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            try:
                callback(exc)
            except Exception:
                pass

    def _drive_until(self, ev: threading.Event) -> None:
        """Inline driver for the blocking path when no loop thread runs."""
        while not ev.is_set():
            try:
                worked = self._cycle(block=True)
            except Exception as exc:
                self._fail_all(exc)  # sets ev via the request's callback
                return
            if not worked:
                time.sleep(0.001)

    def _loop(self) -> None:
        import logging

        while self._running:
            try:
                if self._device is not None:
                    with jax.default_device(self._device):
                        worked = self._cycle(block=True)
                else:
                    worked = self._cycle(block=True)
                if not worked:
                    continue
            except Exception as exc:
                self.stats.record_error()
                logging.getLogger(__name__).exception(
                    "streaming cycle failed; engine state reset"
                )
                self._fail_all(exc)
        # Drain on stop: harvest the NEWEST in-flight readout (it covers
        # everything older) so requests that finished in the final cycles
        # still fire their callbacks before the thread exits. np.asarray
        # blocks for the copy if it hasn't landed yet — that's fine here.
        if self._pending:
            cycle_idx, readout, _ = self._pending[-1]
            self._pending.clear()
            try:
                self._harvest(cycle_idx, readout)
            except Exception as exc:
                self._fail_all(exc)
