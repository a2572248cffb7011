"""Adversarial trainer for the class-conditional sequence GAN.

Reconstructs the reference's absent GAN training loop from its surviving
artifacts (scripts/train.sh flag surface; loss.py:27-80 BCE — see
models/gan.py's module docstring). The structure mirrors the VAE
trainer (training/trainer.py): the discriminator and generator updates are
each ONE jitted XLA program with donated state and on-device (sum, count)
metric accumulation, so the hot loop never syncs with the host; metrics
are fetched only at log boundaries.

Loss layout: the discriminator judges every timestep (models/gan.py), and
its BCE sees each sample's real and fake per-step predictions CONCATENATED
along the time axis with labels [1]*L + [0]*L. That makes the reference's
negative-label downweighting (loss.py:50-80, per-sample over non-batch
axes) meaningful here: with balanced real:fake it is exactly neutral, and
it rebalances automatically if the ratio is ever changed — whereas applied
to an all-fake sample it would zero the loss. The generator's own update
uses the non-saturating objective BCE(D(fake), 1) without smoothing.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..models.gan import (
    GANConfig,
    generate_tokens,
    init_gan_params,
    make_discriminator,
    make_generator,
)
from .checkpoint import (
    get_latest_checkpoint_index,
    restore_checkpoint,
    save_checkpoint,
)
from .loss import binary_cross_entropy
from .optimizer import OptimizerConfig, build_optimizer
from .train_step import TrainState, create_train_state


GAN_METRIC_KEYS = ("d_loss", "d_acc_real", "d_acc_fake", "g_loss", "d_r1")


def init_gan_metric_acc():
    """Fresh on-device accumulators with the FULL key set. Seeding every
    key keeps the acc pytree structure constant across D and G steps, so
    each jitted step compiles exactly once (an empty-dict start would
    retrace as keys appear; same idiom as train_step.init_metric_acc)."""
    # Distinct arrays per leaf: the steps donate the accumulator, and
    # donation rejects the same buffer appearing twice in one call.
    return {
        k: (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))
        for k in GAN_METRIC_KEYS
    }


@dataclasses.dataclass(frozen=True)
class GANTrainConfig:
    """Knobs from the reference's scripts/train.sh:6-21."""

    discriminator_update_steps: int = 5   # D updates per G update
    g_learning_rate: float = 5e-5
    d_learning_rate: float = 5e-5
    label_smoothing: float = 0.0
    negative_label_downweighting: bool = False
    # R1 gradient penalty (Mescheder et al. 2018): gamma/2 * E_real
    # ||grad_x D(x)||^2. DEFAULT ON at the measured-best 0.1: the
    # unregularized run measurably self-destructs (note-on fraction
    # collapsed to 0.032 by 14k steps on guitar_bass) while gamma=0.1
    # keeps output dense AND class separation sharp. The reference
    # train.sh surface has no such knob — but its GAN module is absent
    # from the reference repo, so there is no behavior to be faithful to;
    # PARITY.md documents the divergence and ``--parity-gan`` (cli/gan.py)
    # restores the bare surface. The penalty is well-defined here because
    # D consumes continuous token DISTRIBUTIONS (one-hot for real), not
    # ids.
    r1_gamma: float = 0.1
    checkpoint_frequency: int = 5000
    sampling_frequency: int = 1000
    num_samples: int = 8
    temperature: float = 1.0
    logdir: Optional[str] = None
    log_every: int = 50
    seed: int = 0


def make_gan_steps(config: GANConfig, train_config: GANTrainConfig,
                   mesh=None):
    """Build (d_step, g_step), each jitted with donated state.

    d_step(d_state, acc, g_params, real_tokens, classes) -> (d_state, acc)
    g_step(g_state, acc, d_params, classes) -> (g_state, acc)

    ``acc`` is an on-device {name: (sum, count)} dict accumulated across
    steps; pass {} to start a fresh accumulation period.

    With ``mesh``, batch inputs are sharded over the mesh's "data" axis and
    both models run data-parallel (params replicated — no TP rule matches
    the LSTM parameter names — gradient psums inserted by XLA). Shard the
    states first with ``training.shard_train_state(state, mesh)``.
    """
    gen = make_generator(config)
    disc = make_discriminator(config)
    gc = config.generator_config
    V = config.discriminator_config.input_dim

    def _fake_dists(g_params, classes, key):
        """Differentiable soft generated sequences [B, L, V]."""
        noise_key, roll_key = jax.random.split(key)
        noise = jax.random.normal(
            noise_key, (classes.shape[0], gc.max_seq_len, gc.noise_dim),
            jnp.float32,
        )
        logits, _ = gen(
            g_params, noise, classes, roll_key, hard=False,
            temperature=train_config.temperature,
        )
        # Same temperature as the rollout's own soft feedback and as
        # inference sampling — the discriminator must judge the
        # distribution the generator actually emits.
        return jax.nn.softmax(logits / train_config.temperature)

    def _accumulate(acc, metrics):
        # Union of keys: a G-step must not drop the accumulated D sums
        # (and vice versa) — the two steps contribute disjoint metrics.
        out = dict(acc)
        for k, (s, c) in metrics.items():
            prev = out.get(k, (0.0, 0.0))
            out[k] = (prev[0] + s, prev[1] + c)
        return out

    def d_step_fn(d_state, acc, g_params, real_tokens, classes):
        key = jax.random.fold_in(d_state.rng, d_state.step)
        fake = jax.lax.stop_gradient(_fake_dists(g_params, classes, key))
        real = jax.nn.one_hot(real_tokens, V, dtype=jnp.float32)

        def loss_fn(d_params):
            if train_config.r1_gamma > 0.0:
                # One forward yields both the per-step predictions and
                # (via has_aux) the input-gradient for the R1 penalty —
                # the per-timestep head makes this the patch-GAN R1
                # convention: grad of the SUMMED logits per sample.
                def d_sum_real(x):
                    p = disc(d_params, x, classes)
                    return jnp.sum(p), p

                gin, pred_real = jax.grad(d_sum_real, has_aux=True)(real)
                r1 = jnp.mean(jnp.sum(
                    jnp.square(gin.astype(jnp.float32)), axis=(1, 2)
                ))
            else:
                pred_real = disc(d_params, real, classes)
                r1 = jnp.asarray(0.0, jnp.float32)
            pred_fake = disc(d_params, fake, classes)
            pred = jnp.concatenate([pred_real, pred_fake], axis=1)
            label = jnp.concatenate(
                [jnp.ones_like(pred_real), jnp.zeros_like(pred_fake)], axis=1
            )
            loss = jnp.mean(binary_cross_entropy(
                pred, label,
                label_smoothing=train_config.label_smoothing,
                negative_label_downweighting=(
                    train_config.negative_label_downweighting
                ),
            ))
            loss = loss + 0.5 * train_config.r1_gamma * r1
            return loss, (pred_real, pred_fake, r1)

        (loss, (pr, pf, r1)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(d_state.params)
        updates, opt_state = d_tx.update(grads, d_state.opt_state,
                                         d_state.params)
        params = optax.apply_updates(d_state.params, updates)
        n = jnp.asarray(1.0, jnp.float32)
        metrics = {
            "d_loss": (loss, n),
            "d_acc_real": (jnp.mean(pr > 0.0), n),
            "d_acc_fake": (jnp.mean(pf < 0.0), n),
            "d_r1": (r1, n),
        }
        new_state = d_state.replace(
            step=d_state.step + 1, params=params, opt_state=opt_state
        )
        return new_state, _accumulate(acc, metrics)

    def g_step_fn(g_state, acc, d_params, classes):
        key = jax.random.fold_in(g_state.rng, g_state.step)

        def loss_fn(g_params):
            fake = _fake_dists(g_params, classes, key)
            pred = disc(d_params, fake, classes)
            # Non-saturating generator objective: maximize log D(fake).
            return jnp.mean(binary_cross_entropy(
                pred, jnp.ones_like(pred),
                negative_label_downweighting=False,
            ))

        loss, grads = jax.value_and_grad(loss_fn)(g_state.params)
        updates, opt_state = g_tx.update(grads, g_state.opt_state,
                                         g_state.params)
        params = optax.apply_updates(g_state.params, updates)
        metrics = {"g_loss": (loss, jnp.asarray(1.0, jnp.float32))}
        new_state = g_state.replace(
            step=g_state.step + 1, params=params, opt_state=opt_state
        )
        return new_state, _accumulate(acc, metrics)

    g_tx = build_optimizer(
        OptimizerConfig("adam", "", train_config.g_learning_rate)
    )
    d_tx = build_optimizer(
        OptimizerConfig("adam", "", train_config.d_learning_rate)
    )
    d_jit = jax.jit(d_step_fn, donate_argnums=(0, 1))
    g_jit = jax.jit(g_step_fn, donate_argnums=(0, 1))
    if mesh is None:
        return d_jit, g_jit, g_tx, d_tx

    from ..parallel.mesh import batch_sharding, use_mesh

    data_sh = batch_sharding(mesh)

    def _shard(x):
        if isinstance(x, jax.Array) and x.sharding == data_sh:
            return x
        return jax.device_put(x, data_sh)

    def d_step(d_state, acc, g_params, real_tokens, classes):
        with use_mesh(mesh):
            return d_jit(d_state, acc, g_params, _shard(real_tokens),
                         _shard(classes))

    def g_step(g_state, acc, d_params, classes):
        with use_mesh(mesh):
            return g_jit(g_state, acc, d_params, _shard(classes))

    return d_step, g_step, g_tx, d_tx


class GANTrainer:
    """Epoch loop alternating D and G updates (D : G = discriminator_update_steps : 1)."""

    def __init__(
        self,
        config: GANConfig,
        train_config: GANTrainConfig,
        out_samples: Optional[str] = None,
        mesh=None,
    ) -> None:
        self.config = config
        self.train_config = train_config
        self.out_samples = out_samples
        self.mesh = mesh
        self.gen = make_generator(config)
        self.disc = make_discriminator(config)
        self.d_step, self.g_step, self._g_tx, self._d_tx = make_gan_steps(
            config, train_config, mesh=mesh
        )
        self._writer = None
        if train_config.logdir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                print("tensorboardX not installed; GAN scalars print only")
            else:
                try:
                    self._writer = SummaryWriter(logdir=train_config.logdir)
                except Exception as exc:
                    print(f"TensorBoard writer failed for "
                          f"{train_config.logdir!r} ({exc}); "
                          "GAN scalars print only")

    # -- checkpoint layout: {folder}/generator/params.N + {folder}/discriminator/params.N

    def _save(self, folder: str, index: int, g_state, d_state) -> None:
        save_checkpoint(os.path.join(folder, "generator"), index, g_state)
        save_checkpoint(os.path.join(folder, "discriminator"), index, d_state)

    def _try_resume(self, folder: str, g_state, d_state):
        gen_folder = os.path.join(folder, "generator")
        if not os.path.isdir(gen_folder):
            return g_state, d_state, 0
        idx = get_latest_checkpoint_index(gen_folder)
        if idx < 0:
            return g_state, d_state, 0
        # Atomic: restore BOTH into temporaries so a half-readable pair
        # (e.g. corrupt discriminator checkpoint) falls back to the
        # original fresh states — never a trained G against a fresh D.
        try:
            g_restored = restore_checkpoint(gen_folder, idx, g_state)
            d_restored = restore_checkpoint(
                os.path.join(folder, "discriminator"), idx, d_state
            )
            print(f"resumed GAN from checkpoint {idx}")
            return g_restored, d_restored, idx
        except Exception as e:  # corrupt checkpoint: train from scratch
            print(f"GAN resume failed ({e}); training from scratch")
            return g_state, d_state, 0

    def fit(self, dataset, model_folder: str, epochs: int) -> Dict[str, float]:
        cfg = self.train_config
        os.makedirs(model_folder, exist_ok=True)
        self.config.save(os.path.join(model_folder, "config"))

        rng = jax.random.key(cfg.seed)
        init_rng, g_rng, d_rng = jax.random.split(rng, 3)
        g_params, d_params = init_gan_params(self.config, init_rng)
        g_state = create_train_state(g_params, self._g_tx, g_rng)
        d_state = create_train_state(d_params, self._d_tx, d_rng)
        multiprocess = False
        if self.mesh is not None:
            from . import checkpoint as ckpt_mod
            from .train_step import shard_train_state

            multiprocess = ckpt_mod._multiprocess()
            if multiprocess:
                # Multi-process mesh: shard BEFORE resuming — the
                # collective restore needs a globally-sharded template to
                # return globally-sharded arrays (the VAE Trainer shards
                # in __init__ for the same reason; resuming first would
                # hand restore a per-process template and leave fresh
                # inits unsharded entirely).
                g_state = shard_train_state(g_state, self.mesh)
                d_state = shard_train_state(d_state, self.mesh)
        g_state, d_state, ckpt_idx = self._try_resume(
            model_folder, g_state, d_state
        )
        if self.mesh is not None and not multiprocess:
            from .train_step import shard_train_state

            # Single-process mesh: restore (or init) produced host /
            # single-device arrays; place them now.
            g_state = shard_train_state(g_state, self.mesh)
            d_state = shard_train_state(d_state, self.mesh)

        acc: Dict[str, Tuple[jax.Array, jax.Array]] = init_gan_metric_acc()
        n_batches = 0
        since_log = 0
        last: Dict[str, float] = {}
        t0 = time.time()
        for epoch in range(epochs):
            for batch in dataset:
                tokens = jnp.asarray(batch.tokens[:, 1:])  # drop SOS: raw ids
                classes = jnp.asarray(batch.classes)
                d_state, acc = self.d_step(
                    d_state, acc, g_state.params, tokens, classes
                )
                if n_batches % cfg.discriminator_update_steps == 0:
                    g_state, acc = self.g_step(
                        g_state, acc, d_state.params, classes
                    )
                n_batches += 1
                since_log += 1
                if n_batches % cfg.log_every == 0:
                    last.update(self._log(acc, epoch, n_batches, t0))
                    acc = init_gan_metric_acc()
                    since_log = 0
                if (cfg.checkpoint_frequency > 0
                        and n_batches % cfg.checkpoint_frequency == 0):
                    ckpt_idx += 1
                    self._save(model_folder, ckpt_idx, g_state, d_state)
                if (self.out_samples and cfg.sampling_frequency > 0
                        and n_batches % cfg.sampling_frequency == 0):
                    self.sample_to_midi(
                        g_state.params,
                        os.path.join(self.out_samples, f"step-{n_batches}"),
                    )
        ckpt_idx += 1
        self._save(model_folder, ckpt_idx, g_state, d_state)
        if since_log:
            # Flush the trailing window so the returned metrics reflect
            # the final model, not the last full log_every boundary.
            # (update, not replace: a short trailing window may lack a
            # G update; keep the freshest value per metric.)
            last.update(self._log(acc, epochs - 1, n_batches, t0))
        self.g_state, self.d_state = g_state, d_state
        return last

    def _log(self, acc, epoch: int, n_batches: int, t0: float):
        vals = {
            k: float(s) / float(c)
            for k, (s, c) in acc.items() if float(c) > 0
        }
        line = " ".join(f"{k}={v:.4f}" for k, v in sorted(vals.items()))
        rate = n_batches / max(time.time() - t0, 1e-9)
        print(f"[gan] epoch {epoch} batch {n_batches} {line} "
              f"({rate:.1f} updates/s)")
        if self._writer is not None:
            for k, v in vals.items():
                self._writer.add_scalar(f"gan/{k}", v, global_step=n_batches)
        return vals

    def generate_class_rows(self, g_params) -> Dict[int, list]:
        """num_samples truncated token rows per class id."""
        from ..midi.vocab import EOS_ID, PAD_ID

        cfg = self.train_config
        rows: Dict[int, list] = {}
        for c in range(self.config.generator_config.num_classes):
            classes = jnp.full((cfg.num_samples,), c, jnp.int32)
            tokens = np.asarray(generate_tokens(
                self.gen, g_params, classes,
                jax.random.key(cfg.seed + 1000 + c),
                temperature=cfg.temperature,
            ))
            out = []
            for i in range(cfg.num_samples):
                row = tokens[i]
                # Truncate at the first terminator the generator emits.
                # Real training sequences are PAD-terminated (EOS lives
                # only in the VAE's label layout), so a trained generator
                # signals the end with PAD; EOS is honored too.
                stop = np.flatnonzero((row == EOS_ID) | (row == PAD_ID))
                if stop.size:
                    row = row[: stop[0]]
                out.append(row)
            rows[c] = out
        return rows

    def sample_to_midi(self, g_params, out_dir: str) -> list:
        """Write num_samples generated MIDIs per class: gan-out-{i}.class-{c}.mid
        (the VAE sampler's file-naming scheme, reference sampler.py:102)."""
        from ..midi.codec import MelodyWriter, melody_from_ids

        os.makedirs(out_dir, exist_ok=True)
        writer = MelodyWriter()
        paths = []
        for c, rows in self.generate_class_rows(g_params).items():
            for i, row in enumerate(rows):
                melody = melody_from_ids(row)
                path = os.path.join(out_dir, f"gan-out-{i}.class-{c}.mid")
                writer.write_to_file(path, melody)
                paths.append(path)
        return paths
