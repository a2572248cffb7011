"""Training loop: epochs, periodic logging, checkpoint-driven early stop,
in-training sampling (reference: VarAutoEncoder/trainer.py:38-270).

Differences from the reference, by design:

- the hot loop is ONE jitted XLA program per batch (train_step.py) instead
  of eager per-op dispatch;
- batches keep static shapes; host->device transfer is pre-sharded over the
  mesh's data axis when a mesh is given;
- optimizer state is checkpointed and restored;
- TensorBoard scalars go through tensorboardX (logdir configurable; the
  reference hardcodes /tmp/out, trainer.py:84).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.dataset import Batch, Dataset, RawBatch
from ..models.vae import StyleVAE
from . import checkpoint as ckpt
from .metrics import MetricAccumulator
from .optimizer import OptimizerConfig, build_optimizer
from .train_step import (
    LossConfig,
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    shard_train_state,
)


@dataclasses.dataclass
class TrainConfig:
    """Reference: trainer.py:38-57 (TrainConfig)."""

    batch_size: int = 1
    sampling_frequency: int = 1000
    checkpoint_frequency: int = 5000
    num_checkpoints_not_improved: int = 10
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    kl_loss_weight: float = 1.0
    kl_anneal_steps: int = 0  # linear KL warmup (0 = constant)
    free_bits: float = 0.0  # per-dim KL floor (posterior-collapse guard)
    label_smoothing: float = 0.0
    negative_label_downscaling: bool = False  # GAN leftover, kept for parity
    verbose: bool = False
    logdir: str = "/tmp/out"
    log_every: int = 50  # reference: trainer.py:139
    seed: int = 0
    # When set, a jax.profiler trace of steps [profile_start, profile_stop)
    # is written here (the reference has no profiling at all — SURVEY.md §5.1).
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_stop: int = 20
    # Host->device input prefetch depth (0 disables; data/prefetch.py).
    prefetch: int = 2
    # Per-parameter gradient-norm TB scalars (reference: trainer.py:257-270).
    log_param_grad_norms: bool = False
    # Gradient accumulation: apply the optimizer every k steps
    # (optax.MultiSteps); effective batch = k * batch_size.
    grad_accum_steps: int = 1
    # PRNG implementation for training randomness (dropout masks, z
    # sampling). "rbg" draws with XLA's RngBitGenerator, which is much
    # cheaper per dropout mask than threefry's hash rounds. Use
    # "threefry2x32" for cross-platform bit-reproducibility.
    rng_impl: str = "rbg"
    # Retain only the newest N params.* checkpoints (0 = keep all, the
    # reference's behavior).
    keep_checkpoints: int = 0
    # Per-checkpoint generation-health probe: style-transfer this many
    # rows (taken once from the validation set, else the train set) into
    # every class and record termination rate + mean generated length as
    # TB scalars (gen_*). Teacher-forced CE provably misses decode
    # collapse — a wide-config run's final checkpoint read CE 1.51 while
    # every generated sequence was empty — so the trainer measures the
    # decode surface directly.
    # 0 disables; single-process, mesh-free runs only. Library default is
    # off (tests and embedders opt in); cli.main defaults it to 8 so real
    # training runs always track decode health.
    gen_health_rows: int = 0
    # Train steps fused into ONE dispatched program via lax.scan
    # (train_step.run_multi). Semantically identical to sequential steps;
    # the win is host dispatch amortization for configs whose step is
    # shorter than the host's per-step dispatch cost.
    # Log/checkpoint/sampling ticks snap to dispatch boundaries (crossing
    # checks, exact when the frequency is a multiple). 1 = off.
    # Ignored (with a note) in multi-process mode, where the global-array
    # assembly is per-batch.
    steps_per_dispatch: int = 1


class _NullWriter:
    def add_scalar(self, *a, **k) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    def __init__(
        self,
        config: TrainConfig,
        model: StyleVAE,
        params,
        sampler=None,
        mesh=None,
        dist=None,
    ):
        """``dist``: a parallel.distributed.ProcessInfo for multi-process
        runs (mesh then spans processes; fit() consumes a
        ProcessShardedDataset, assembles global batches, checkpoints on the
        primary process only, and skips in-training sampling)."""
        self.config = config
        self.model = model
        self.sampler = sampler
        self.mesh = mesh
        self.dist = dist
        if dist is not None:
            assert mesh is not None, "distributed training requires a mesh"
            if config.prefetch:
                # Prefetch device_puts to the default device / global
                # sharding, neither of which is right for per-process
                # slices; global assembly happens in _step instead.
                config = dataclasses.replace(config, prefetch=0)
                self.config = config
            if sampler is not None and config.sampling_frequency > 0:
                print("Distributed run: in-training sampling disabled "
                      "(per-process decode of global arrays is unsupported)")
                self.sampler = None

        self.tx = build_optimizer(config.optimizer)
        if config.grad_accum_steps > 1:
            import optax

            self.tx = optax.MultiSteps(
                self.tx, every_k_schedule=config.grad_accum_steps
            ).gradient_transformation()
        loss_cfg = LossConfig(
            kl_weight=config.kl_loss_weight,
            label_smoothing=config.label_smoothing,
            kl_anneal_steps=config.kl_anneal_steps,
            free_bits=config.free_bits,
        )
        self.train_step = make_train_step(
            model, self.tx, loss_cfg, mesh=mesh,
            per_param_grad_norms=config.log_param_grad_norms,
        )
        self.eval_step = make_eval_step(model, loss_cfg)
        self.state = create_train_state(
            params, self.tx, jax.random.key(config.seed, impl=config.rng_impl)
        )
        if mesh is not None:
            self.state = shard_train_state(self.state, mesh)
        # On-device (sum, count) metric accumulators; fetched to host only
        # at log/checkpoint boundaries so the hot loop never syncs.
        self._metric_acc = None
        self._health_batch = None
        self._health_classes = 0
        self.progress = ckpt.TrainingProgress()
        self._batches_at_start = 0
        self._last_log = None
        self._last_ckpt_batches = 0
        self._stop_requested = False
        self._profiling = False
        self._writer = None
        # One long-lived async checkpointer: saves overlap training instead
        # of blocking the device at every checkpoint tick.
        self._checkpointer = None

    @property
    def checkpointer(self):
        if self._checkpointer is None:
            self._checkpointer = ckpt.AsyncCheckpointer()
        return self._checkpointer

    @property
    def writer(self):
        if self._writer is None:
            os.makedirs(self.config.logdir, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(logdir=self.config.logdir,
                                             flush_secs=5)
            except ImportError:
                # tensorboardX is an optional extra; training proceeds with
                # stdout logging only.
                print("tensorboardX not installed; TensorBoard scalars "
                      "disabled (pip install musicstyletransfer-tpu[logging])")
                self._writer = _NullWriter()
        return self._writer

    # ------------------------------------------------------------------

    def fit(
        self,
        dataset: Dataset,
        model_folder: str,
        epochs: int,
        validation_dataset: Optional[Dataset] = None,
    ) -> None:
        start_time = time.time()
        os.makedirs(model_folder, exist_ok=True)
        self._load_latest_checkpoint(model_folder)
        # updates/sec must count only THIS run's batches (after a resume,
        # progress.n_batches includes prior runs' work).
        self._batches_at_start = self.progress.n_batches
        self._last_log = None

        cfg = self.config
        self._health_batch = None
        self._health_classes = 0
        if (cfg.gen_health_rows > 0 and self.dist is None
                and self.mesh is None):
            src = validation_dataset if validation_dataset is not None \
                else dataset
            try:
                self._health_classes = src.num_classes()
                self._health_batch = self._make_health_batch(
                    src, cfg.gen_health_rows)
            except Exception as e:  # probe is best-effort, never fatal
                print(f"generation-health probe disabled: {e}")
        if cfg.prefetch > 0:
            from ..data.prefetch import PrefetchingDataset
            from ..parallel.mesh import batch_sharding

            # Multi-step dispatch stacks N host batches and uploads once
            # (train_step.run_multi), so per-batch device placement in the
            # prefetcher would bounce every array device->host->device;
            # place=False keeps staged batches on the host (preparation
            # still overlaps compute).
            multi = cfg.steps_per_dispatch > 1
            sharding = (
                batch_sharding(self.mesh)
                if self.mesh is not None and not multi else None
            )
            dataset = PrefetchingDataset(dataset, cfg.prefetch, sharding,
                                         place=not multi)
        self._stop_requested = False
        restore_handlers = self._install_signal_handlers()
        try:
            self._fit_loop(dataset, model_folder, epochs, validation_dataset,
                           start_time)
        finally:
            restore_handlers()
            if self._profiling:
                # Training ended inside the profile window (early stop,
                # exception): finalize the trace rather than leak it.
                jax.profiler.stop_trace()
                self._profiling = False
                print(f"Profiler trace written to {cfg.profile_dir}")
            # Async saves must be durable before fit returns (and before any
            # subsequent resume reads the folder).
            if self._checkpointer is not None:
                self._checkpointer.wait_until_finished()

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT request a graceful stop: finish the current batch,
        write a final checkpoint, return from fit (preemption-safe training;
        in multi-process runs deliver the signal to EVERY process or the
        fleet hangs at the next collective). No-op off the main thread."""
        import signal

        previous = {}

        def restore():
            for sig, handler in previous.items():
                signal.signal(sig, handler)

        def _request_stop(signum, frame):
            print(f"Signal {signum}: checkpointing and stopping after "
                  "this batch.")
            self._stop_requested = True
            # Re-arm the ORIGINAL handlers so a second signal can still
            # force-interrupt (e.g. Ctrl-C twice when the stop path itself
            # hangs on a validation pass or a fleet-mate's collective).
            restore()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not the main thread
                break

        return restore

    def _fit_loop(
        self, dataset, model_folder, epochs, validation_dataset, start_time
    ) -> None:
        cfg = self.config
        # Batch count at the last durable checkpoint: a completed run must
        # never end checkpoint-less (the reference only saves on frequency
        # ticks, so short runs left nothing for the sampler to load).
        self._last_ckpt_batches = self.progress.n_batches
        n_per = max(1, cfg.steps_per_dispatch)
        if n_per > 1 and self.dist is not None:
            print("steps_per_dispatch ignored in multi-process mode "
                  "(global-array assembly is per-batch)")
            n_per = 1
        group: list = []
        for epoch in range(epochs):
            for batch in dataset:
                group.append(batch)
                if len(group) < n_per:
                    continue
                if self._run_group(group, epoch, model_folder,
                                   validation_dataset, start_time, dataset):
                    return
                group = []
            # Epoch-end remainder (< n_per batches): single-step dispatches
            # — a scan over a different length would be a fresh compile.
            for b in group:
                if self._run_group([b], epoch, model_folder,
                                   validation_dataset, start_time, dataset):
                    return
            group = []
        # Normal completion: persist any work since the last checkpoint tick
        # so every finished run is loadable by the sampler/eval CLIs.
        if self.progress.n_batches != self._last_ckpt_batches:
            self._checkpoint(model_folder, validation_dataset)
            print(f"Final checkpoint {self.progress.n_checkpoints} written.")

    # ------------------------------------------------------------------

    def _run_group(self, group, epoch, model_folder, validation_dataset,
                   start_time, dataset) -> bool:
        """Dispatch one group of batches (one program when len > 1) and
        run the periodic ticks. Tick checks are CROSSING checks —
        ``nb // f > (nb - n) // f`` — which reduce to the single-step
        ``nb % f == 0`` at n=1 and fire once per crossed boundary
        otherwise. Returns True when training should stop."""
        cfg = self.config
        n = len(group)
        prev = self.progress.n_batches
        if cfg.profile_dir is not None:
            # Snapped to dispatch boundaries: a running trace stops at the
            # first boundary AT OR AFTER profile_stop (a window narrower
            # than one group still terminates — at the next group), and
            # the trace starts before the group that covers profile_start.
            if self._profiling and prev >= cfg.profile_stop:
                jax.profiler.stop_trace()
                self._profiling = False
                print(f"Profiler trace written to {cfg.profile_dir}")
            if prev <= cfg.profile_start < prev + n and not self._profiling:
                jax.profiler.start_trace(cfg.profile_dir)
                self._profiling = True
        if n == 1:
            self._step(group[0])
        else:
            self._multi_step(group)
        self.progress.n_batches += n
        nb = self.progress.n_batches

        if self._stop_requested:
            self._checkpoint(model_folder, validation_dataset)
            print("Stopped on signal; checkpoint "
                  f"{self.progress.n_checkpoints} written.")
            return True

        if nb // cfg.log_every > prev // cfg.log_every:
            self._periodic_log(epoch, start_time)

        if nb // cfg.checkpoint_frequency > prev // cfg.checkpoint_frequency:
            self._checkpoint(model_folder, validation_dataset)
            if (
                self.progress.num_checkpoints_not_improved
                == cfg.num_checkpoints_not_improved
            ):
                print("Maximum checkpoints not improved reached. "
                      "Stopping training.")
                return True

        if (
            self.sampler is not None
            and cfg.sampling_frequency > 0
            and nb // cfg.sampling_frequency > prev // cfg.sampling_frequency
        ):
            batch = group[-1]
            self.sampler.update_parameters(self.state.params)
            self.sampler.process_batch(
                batch.to_batch() if isinstance(batch, RawBatch) else batch,
                os.path.join(model_folder, f"samples/step-{nb}"),
                dataset.num_classes(),
            )
        return False

    def _multi_step(self, group) -> None:
        """Stack the group's host batches along a leading step axis and run
        them as ONE dispatched scan program (train_step.run_multi)."""
        if isinstance(group[0], RawBatch):
            arrays = (
                np.stack([np.asarray(b.chunks) for b in group]),
                np.stack([np.asarray(b.classes) for b in group]),
            )
        else:
            arrays = (
                np.stack([np.asarray(b.tokens) for b in group]),
                np.stack([np.asarray(b.seq_lens) for b in group]),
                np.stack([np.asarray(b.classes) for b in group]),
                np.stack([np.asarray(b.labels) for b in group]),
            )
        self.state, self._metric_acc = self.train_step.multi(
            self.state, self._metric_acc, *arrays
        )

    def _step_inputs(self, batch):
        if isinstance(batch, RawBatch):
            # Device-layout path: ship raw chunks; SOS/EOS/seq_lens happen
            # inside the jitted step.
            arrays = (batch.chunks, batch.classes)
        else:
            arrays = (batch.tokens, batch.seq_lens, batch.classes,
                      batch.labels)
        if self.dist is not None:
            # batch holds THIS process's slice; assemble global jax.Arrays
            # sharded over the mesh's data axis.
            from ..parallel.distributed import make_global_batch

            return make_global_batch(
                arrays, self.mesh, batch.batch_size * self.dist.count
            )
        return tuple(jnp.asarray(a) for a in arrays)

    def _step(self, batch) -> None:
        self.state, self._metric_acc = self.train_step(
            self.state, self._metric_acc, *self._step_inputs(batch)
        )

    def _drain_metrics(self) -> dict:
        """Fetch + reset the on-device accumulators (one host sync)."""
        if self._metric_acc is None:
            return {}
        host = jax.device_get(self._metric_acc)
        self._metric_acc = None
        acc = MetricAccumulator()
        acc.update(host)
        return acc.get()

    def _eval_pass(self, validation_dataset: Dataset) -> float:
        # Distributed: every process iterates the FULL validation set (pass
        # it unwrapped), slices its rows, and assembles global arrays; the
        # global n_valid stays known on every process.
        dist_slice = None
        if self.dist is not None:
            from ..parallel.distributed import _slice_batch

            def dist_slice(batch):
                rows = batch.batch_size // self.dist.count
                lo = self.dist.index * rows
                return _slice_batch(batch, lo, lo + rows)

        acc = MetricAccumulator()
        for batch in validation_dataset:
            n_valid = batch.num_valid
            if dist_slice is not None:
                batch = dist_slice(batch)
            metrics = self.eval_step(
                self.state.params,
                *self._step_inputs(batch),
                jnp.asarray(n_valid, jnp.int32),
            )
            acc.update(jax.device_get(metrics))
        vals = acc.get()
        self._write_scalars({f"validation_{k}": v for k, v in vals.items()})
        print(
            "Validation: "
            + " ".join(f"{k}={v:.3f}" for k, v in sorted(vals.items()))
        )
        # Improvement metric. The reference tracks validation TOTAL loss
        # (its objective is stationary). Under KL annealing the total's
        # beta rises across checkpoints, so early low-beta checkpoints
        # would win forever — measured on the round-4 wide run, where
        # "best" ckpt 2 (total 9.67) evaluates at acc 0.209 / CE 2.20
        # downstream while ckpt 14 reads acc 0.427 / CE 1.50. Track the
        # beta-independent reconstruction CE when annealing is active.
        if self.config.kl_anneal_steps > 0:
            return vals["ce_loss"]
        return vals["total_loss"]

    def _checkpoint(self, model_folder: str, validation_dataset) -> None:
        self._last_ckpt_batches = self.progress.n_batches
        self.progress.n_checkpoints += 1
        print(f"\nCheckpoint {self.progress.n_checkpoints} reached.")
        # Multi-process: save_checkpoint is a COLLECTIVE — sharded leaves
        # are all-gathered and the primary writes one ordinary checkpoint,
        # which makes TP-across-processes states checkpoint correctly.
        # Only the primary writes the JSON bookkeeping and prunes.
        ckpt.save_checkpoint(model_folder, self.progress.n_checkpoints,
                             self.state, checkpointer=self.checkpointer)
        if self.dist is None or self.dist.is_primary:
            self.progress.save(model_folder)
            if self.config.keep_checkpoints > 0:
                # +1: the newest save may still be in flight (uncommitted),
                # so keep one extra durable predecessor.
                ckpt.prune_checkpoints(model_folder,
                                       self.config.keep_checkpoints + 1)
        self._metric_acc = None  # reset running metrics (trainer.py:210)

        if self._health_batch is not None:
            vals = self._generation_health()
            self._write_scalars(vals)
            print("Generation health: "
                  + " ".join(f"{k}={v:.3f}" for k, v in sorted(vals.items())))

        # skip_nonfinite observability: apply_if_finite wraps the opt
        # state; surface the cumulative rejected-update count so a run
        # that is silently skipping batches is visible in the log.
        opt_state = getattr(self.state, "opt_state", None)
        if hasattr(opt_state, "total_notfinite"):
            skipped = int(jax.device_get(opt_state.total_notfinite))
            if skipped:
                print(f"Non-finite gradient updates skipped: {skipped}")
            self._write_scalars({"nonfinite_updates_skipped": skipped})

        if validation_dataset is None:
            return
        loss = self._eval_pass(validation_dataset)
        if loss < self.progress.best_reconstruction_loss:
            print(
                f"Loss improved from {self.progress.best_reconstruction_loss} "
                f"to {loss}."
            )
            self.progress.best_reconstruction_loss = loss
            self.progress.num_checkpoints_not_improved = 0
        else:
            self.progress.num_checkpoints_not_improved += 1
            print(
                f"Loss did not improve. "
                f"{self.progress.num_checkpoints_not_improved} out of "
                f"{self.config.num_checkpoints_not_improved} unsuccessful "
                f"checkpoints"
            )
            print(f"Best loss thus far: {self.progress.best_reconstruction_loss}")
        if self.dist is None or self.dist.is_primary:
            self.progress.save(model_folder)

    @staticmethod
    def _make_health_batch(src, rows: int):
        """First ``rows`` rows of ``src``'s first batch, as device arrays.
        Fixed for the whole run so the decode program compiles once and
        per-checkpoint numbers are comparable."""
        b = next(iter(src))
        if isinstance(b, RawBatch):
            b = b.to_batch()
        n = min(rows, int(b.tokens.shape[0]))
        return (jnp.asarray(b.tokens[:n]), jnp.asarray(b.seq_lens[:n]))

    def _generation_health(self) -> dict:
        """Sample the decode surface with the CURRENT params: transfer the
        fixed health rows into every class and summarize termination and
        length. gen_min_class_termination catches one class's generator
        dying while the other stays alive (the round-4 wide run's failure
        mode), which the pooled rate averages away."""
        from ..inference.decode import style_transfer_all_classes
        from ..midi.vocab import EOS_ID, PAD_ID

        tokens, seq_lens = self._health_batch
        seqs, _ = style_transfer_all_classes(
            self.model, self.state.params, tokens, seq_lens,
            max_len=2 * int(tokens.shape[1]),
            num_classes=self._health_classes,
            # Fixed key: checkpoint-over-checkpoint deltas measure the
            # params, not sampling noise.
            rng=jax.random.key(self.config.seed),
        )
        seqs = np.asarray(seqs)  # [C, B, T']
        terminated = (seqs == EOS_ID).any(axis=-1)
        lengths = (seqs != PAD_ID).sum(axis=-1) - 1  # minus SOS
        return {
            "gen_termination_rate": float(terminated.mean()),
            "gen_min_class_termination": float(terminated.mean(axis=1).min()),
            "gen_mean_len": float(lengths.mean()),
        }

    def _load_latest_checkpoint(self, model_folder: str) -> None:
        """Resume from the NEWEST checkpoint that actually restores.

        Recovery semantics (round 4, fault-injection tested in
        tests/test_distributed.py): a kill -9 mid-run can leave the newest
        params.N truncated or uncommitted (saves commit by atomic rename,
        so usually it simply never appears — but a shared-filesystem crash
        can still surface a corrupt directory). The resume walks indices
        NEWEST-FIRST and falls back to the previous durable checkpoint on
        a restore error; only when every checkpoint fails does training
        start from scratch (the reference swallows all restore errors and
        always restarts from scratch, trainer.py:192-194)."""
        print(f"Looking into folder {model_folder} for a valid training.")
        try:
            indices = ckpt.checkpoint_indices(model_folder)
        except FileNotFoundError:
            indices = []
        latest = None
        restored = False
        if not indices:
            print("No checkpoint was found. Starting training from scratch")
        for idx in reversed(indices):
            print(f"Checkpoint {idx} found. Resuming training.")
            try:
                self.state = ckpt.restore_checkpoint(
                    model_folder, idx, self.state
                )
                restored, latest = True, idx
                break
            except Exception as exc:
                # Crash-resume semantics: a corrupt/incompatible checkpoint
                # falls back to the PREVIOUS one — but say why.
                print(f"Checkpoint {idx} could not be restored ({exc}); "
                      "trying the previous checkpoint"
                      if idx != indices[0] else
                      f"Checkpoint {idx} could not be restored ({exc}); "
                      "starting training from scratch")
        if restored:
            if self.mesh is not None and not ckpt._multiprocess():
                # Single-process mesh: the restore produced host arrays;
                # place them. Multi-process restore is collective and
                # already returned globally-sharded arrays (device_get of
                # a non-addressable shard would throw here).
                self.state = shard_train_state(self.state, self.mesh)
            try:
                self.progress = ckpt.TrainingProgress.load(model_folder)
            except FileNotFoundError:
                pass
            if self.progress.n_checkpoints > latest:
                # Crash window of async checkpointing: bookkeeping was
                # written for a checkpoint that never committed. Roll the
                # counters back to the restored (durable) one.
                print(f"Bookkeeping ({self.progress.n_checkpoints}) is "
                      f"ahead of the last durable checkpoint ({latest}); "
                      "reconciling.")
                self.progress.n_checkpoints = latest
                self.progress.n_batches = int(self.state.step)
        if self.dist is not None:
            # All processes must agree on the resume point, or the global
            # arrays would silently mix restored and fresh shards.
            from ..parallel.distributed import assert_in_sync

            assert_in_sync(self.mesh, float(int(self.state.step)),
                           "the resumed training step")

    # ------------------------------------------------------------------

    def _write_scalars(self, scalars) -> None:
        for name, val in scalars.items():
            self.writer.add_scalar(name, val, global_step=self.progress.n_batches)

    def _periodic_log(self, epoch: int, start_time: float) -> None:
        vals = self._drain_metrics()
        self._write_scalars(vals)
        now = time.time()
        ups = (self.progress.n_batches - self._batches_at_start) / max(
            now - start_time, 1e-9
        )
        # Cumulative updates/sec matches the reference's print
        # (trainer.py:250-254) but is dragged far below the real rate by
        # the one-time XLA compile, so also report the rate over
        # the window since the previous log line.
        window = ""
        if self._last_log is not None:
            prev_batches, prev_time = self._last_log
            wups = (self.progress.n_batches - prev_batches) / max(
                now - prev_time, 1e-9
            )
            window = f" (window: {wups:.1f})"
        self._last_log = (self.progress.n_batches, now)
        # Per-param grad norms go to TensorBoard only (reference prints just
        # the main metric line, trainer.py:250-254).
        line = " ".join(
            f"{k}={v:.3f}" for k, v in sorted(vals.items())
            if not k.startswith("grad_norm/")
        )
        print(
            f"Epoch [{epoch}] Batch [{self.progress.n_batches}] "
            f"updates/sec: {ups:.2f}{window} {line}"
        )
