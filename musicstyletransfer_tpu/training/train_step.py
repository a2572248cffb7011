"""The fused jitted train step: forward + loss + grad + optimizer update.

Replaces the reference's eager per-op hot loop (trainer.py:155-179, which
runs un-hybridized MXNet with Python prints inside attention) with ONE
XLA-compiled program per step. Under a mesh, the batch is sharded over the
"data" axis and gradients are reduced by XLA-inserted psums (SURVEY.md §5.8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from ..models.vae import StyleVAE
from ..parallel.mesh import batch_sharding, param_shardings, replicated
from .loss import vae_loss
from .metrics import step_metrics


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jax.Array
    params: Any
    opt_state: Any
    rng: jax.Array

    def replace(self, **changes: Any) -> "TrainState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    kl_weight: float = 1.0
    label_smoothing: float = 0.0
    normalize: str = "valid"
    # Linear KL warmup over this many steps (0 = constant kl_weight).
    kl_anneal_steps: int = 0
    # Per-dimension KL floor (posterior-collapse mitigation; 0 disables).
    free_bits: float = 0.0

    def kl_weight_at(self, step):
        if self.kl_anneal_steps <= 0:
            return self.kl_weight
        frac = jnp.minimum(step.astype(jnp.float32) / self.kl_anneal_steps, 1.0)
        return self.kl_weight * frac


def create_train_state(
    params: Any, tx: optax.GradientTransformation, rng: jax.Array
) -> TrainState:
    # Copy params: the train step donates its input state (buffer reuse),
    # which would delete the caller's arrays out from under any other
    # holder (e.g. a sampler sharing weights, or a second Trainer).
    params = jax.tree.map(lambda x: jnp.array(x, copy=True), params)
    return TrainState(
        step=jnp.asarray(0, jnp.int32),
        params=params,
        opt_state=tx.init(params),
        rng=rng,
    )


METRIC_KEYS = ("ppl", "acc", "top5_acc", "ce_loss", "kl_loss", "total_loss",
               "grad_norm")


def init_metric_acc() -> Dict[str, Tuple[jax.Array, jax.Array]]:
    """Fresh on-device metric accumulators: {name: (sum, count)}."""
    return {
        k: (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))
        for k in METRIC_KEYS
    }


def make_train_step(
    model: StyleVAE,
    tx: optax.GradientTransformation,
    loss_config: LossConfig,
    mesh: Optional[Mesh] = None,
    per_param_grad_norms: bool = False,
) -> Callable:
    """Build the jitted train step.

    Returns step(state, metric_acc, *inputs) -> (state, metric_acc') where
    ``inputs`` is either the host layout (tokens, seq_lens, classes, labels)
    or the device layout (chunks, classes) — with the latter, the
    SOS/EOS/seq_lens tensorization runs INSIDE the jitted program
    (``device_layout_chunks``), fusing into the step and shipping half the
    bytes to the device. metric_acc is a dict of on-device (sum, count)
    scalars ACCUMULATED across steps. Passing ``None`` starts from zeros
    (per-step metrics). Keeping accumulation inside the jitted program
    means the hot loop never syncs with the host — metrics are fetched
    only at log boundaries (the reference syncs per step via .asscalar(),
    trainer.py:181-186).
    """

    def step_fn(
        state: TrainState,
        metric_acc: Dict[str, Tuple[jax.Array, jax.Array]],
        tokens: jax.Array,
        seq_lens: jax.Array,
        classes: jax.Array,
        labels: jax.Array,
    ) -> Tuple[TrainState, Dict[str, Tuple[jax.Array, jax.Array]]]:
        step_rng = jax.random.fold_in(state.rng, state.step)

        def loss_fn(params):
            logits, mu, logvar = model(params, tokens, seq_lens, classes,
                                       rng=step_rng)
            total, scalars = vae_loss(
                logits,
                labels,
                mu,
                logvar,
                kl_weight=loss_config.kl_weight_at(state.step),
                label_smoothing=loss_config.label_smoothing,
                normalize=loss_config.normalize,
                free_bits=loss_config.free_bits,
            )
            return total, (logits, scalars)

        (_, (logits, scalars)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        metrics = step_metrics(logits, labels, scalars)
        metrics["grad_norm"] = (optax.global_norm(grads), jnp.asarray(1, jnp.int32))
        if per_param_grad_norms:
            # Per-parameter gradient norms (reference: trainer.py:257-270).
            flat = jax.tree_util.tree_flatten_with_path(grads)[0]
            for path, g in flat:
                name = "grad_norm/" + "/".join(
                    str(getattr(k, "key", k)) for k in path
                )
                metrics[name] = (
                    jnp.sqrt(jnp.sum(jnp.square(g.astype(jnp.float32)))),
                    jnp.asarray(1, jnp.int32),
                )
        keys = metrics.keys()
        new_acc = {
            k: (
                (metric_acc[k][0] if k in metric_acc else 0.0)
                + metrics[k][0].astype(jnp.float32),
                (metric_acc[k][1] if k in metric_acc else 0.0)
                + metrics[k][1].astype(jnp.float32),
            )
            for k in keys
        }
        new_state = state.replace(
            step=state.step + 1, params=params, opt_state=opt_state
        )
        return new_state, new_acc

    def raw_step_fn(state, metric_acc, chunks, classes):
        from ..data.dataset import device_layout_chunks

        tokens, seq_lens, labels = device_layout_chunks(chunks)
        return step_fn(state, metric_acc, tokens, seq_lens, classes, labels)

    def _scan_of(body_fn):
        """N steps per dispatch: lax.scan over a leading step axis.

        Semantically identical to N sequential single-step calls (the
        per-step RNG folds on state.step, which increments inside the
        scan), but the host issues ONE program instead of N — the fix for
        small configs whose step is limited by host dispatch rather than
        device time. The metric accumulator rides the scan carry, so it
        must be key-complete (run_multi seeds it)."""

        def scanned(state, metric_acc, *stacked):
            def body(carry, xs):
                return body_fn(*carry, *xs), None

            (state, metric_acc), _ = jax.lax.scan(
                body, (state, metric_acc), stacked
            )
            return state, metric_acc

        return scanned

    jitted = jax.jit(step_fn, donate_argnums=(0, 1))
    jitted_raw = jax.jit(raw_step_fn, donate_argnums=(0, 1))
    jitted_scan = jax.jit(_scan_of(step_fn), donate_argnums=(0, 1))
    jitted_scan_raw = jax.jit(_scan_of(raw_step_fn), donate_argnums=(0, 1))
    data_sh = batch_sharding(mesh) if mesh is not None else None

    acc_keys_cache: list = []  # lazily-learned full metric keyset

    def _seed_acc(state, metric_acc, inputs):
        """Key-complete accumulator: missing keys get fresh zero pairs.

        The full keyset is learned once via eval_shape on the single-step
        function (abstract, no compile). Seeding up front means the jitted
        program only ever sees ONE accumulator structure — an empty-dict
        start would otherwise compile the step twice (empty then full).
        Distinct zero arrays per key: the steps donate
        the accumulator, and donation rejects one buffer appearing twice."""
        if not acc_keys_cache:
            shapes = tuple(
                jax.ShapeDtypeStruct(x.shape, x.dtype) for x in inputs
            )
            body = step_fn if len(inputs) == 4 else raw_step_fn
            if mesh is not None:
                # Sharding constraints inside the model (sequence
                # parallelism) resolve axis names against the ambient mesh
                # even under abstract evaluation.
                from ..parallel.mesh import use_mesh

                with use_mesh(mesh):
                    _, acc_shapes = jax.eval_shape(
                        body, state, metric_acc, *shapes
                    )
            else:
                _, acc_shapes = jax.eval_shape(
                    body, state, metric_acc, *shapes
                )
            acc_keys_cache.append(tuple(acc_shapes.keys()))
        return {
            k: metric_acc.get(
                k, (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))
            )
            for k in acc_keys_cache[0]
        }

    def run(state, metric_acc, *inputs):
        fn = jitted if len(inputs) == 4 else jitted_raw
        metric_acc = _seed_acc(state, metric_acc or {}, inputs)
        if data_sh is not None:
            # Pre-partition the host->device transfer over the data axis.
            # Inputs already carrying the right sharding (multi-process
            # global arrays assembled by the caller) pass through untouched.
            inputs = tuple(
                x if isinstance(x, jax.Array) and x.sharding == data_sh
                else jax.device_put(x, data_sh)
                for x in inputs
            )
        if mesh is not None:
            # Expose the mesh to trace-time sharding constraints
            # (e.g. sequence parallelism in TransformerStack).
            from ..parallel.mesh import use_mesh

            with use_mesh(mesh):
                return fn(state, metric_acc, *inputs)
        return fn(state, metric_acc, *inputs)

    # --- multi-step dispatch (steps_per_dispatch > 1) -------------------
    stacked_sh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.mesh import AXIS_DATA

        # [N, batch, ...]: step axis unsharded, batch over "data".
        stacked_sh = NamedSharding(mesh, PartitionSpec(None, AXIS_DATA))

    def run_multi(state, metric_acc, *stacked):
        """Run stacked.shape[0] steps as ONE dispatched program.

        ``stacked`` carries the same layouts as ``run`` with a leading
        step axis. The scan carry needs a key-complete accumulator
        (_seed_acc) — after which semantics match N sequential ``run``
        calls exactly (per-step RNG folds on the incrementing
        state.step)."""
        slices = tuple(
            jax.ShapeDtypeStruct(x.shape[1:], x.dtype) for x in stacked
        )
        metric_acc = _seed_acc(state, metric_acc or {}, slices)
        fn = jitted_scan if len(stacked) == 4 else jitted_scan_raw
        if stacked_sh is not None:
            stacked = tuple(
                x if isinstance(x, jax.Array) and x.sharding == stacked_sh
                else jax.device_put(x, stacked_sh)
                for x in stacked
            )
        if mesh is not None:
            from ..parallel.mesh import use_mesh

            with use_mesh(mesh):
                return fn(state, metric_acc, *stacked)
        return fn(state, metric_acc, *stacked)

    # Expose the underlying jitted stages so perf tooling (scripts/
    # mfu-sweep.py) can .lower().compile().cost_analysis() the exact
    # program the trainer runs.
    run.jitted = jitted
    run.jitted_raw = jitted_raw
    run.multi = run_multi
    return run


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Place a TrainState onto a mesh: params (and the matching adam
    moments) follow the tensor-parallel rules; scalars are replicated.
    Works for meshes spanning multiple processes (every process holds the
    same deterministic init, so per-process shard placement is valid)."""
    from ..parallel.distributed import global_device_put

    p_sh = param_shardings(state.params, mesh)
    repl = replicated(mesh)

    def put(tree, shardings):
        return jax.tree.map(global_device_put, tree, shardings)

    def shard_opt(opt_state):
        def _one(node):
            if (
                jax.tree_util.tree_structure(node)
                == jax.tree_util.tree_structure(state.params)
            ):
                return put(node, p_sh)
            return jax.tree.map(lambda x: global_device_put(x, repl), node)

        # optax states are tuples/namedtuples whose fields are either
        # param-shaped trees (mu, nu) or scalars (count).
        return jax.tree.map(
            _one,
            opt_state,
            is_leaf=lambda n: jax.tree_util.tree_structure(n)
            == jax.tree_util.tree_structure(state.params),
        )

    # PRNG keys (extended dtypes) can't round-trip through numpy; move the
    # raw key data instead (re-wrapped with the same impl).
    rng_data = global_device_put(jax.random.key_data(state.rng), repl)
    return TrainState(
        step=global_device_put(state.step, repl),
        params=put(state.params, p_sh),
        opt_state=shard_opt(state.opt_state),
        rng=jax.random.wrap_key_data(
            rng_data, impl=jax.random.key_impl(state.rng)
        ),
    )


def make_eval_step(model: StyleVAE, loss_config: LossConfig) -> Callable:
    """Deterministic evaluation step (z = mu, no dropout), row-maskable.

    The reference's validation pass re-runs the training forward including
    z-sampling and dropout (trainer.py:155-179 with is_train=False); here
    evaluation is deterministic — a documented divergence.

    ``n_valid`` masks wrap-padded duplicate rows (the final partial batch
    wraps to the start for static shapes) out of EVERY metric, so the
    early-stopping loss is invariant to batch size. Loss metrics are
    accumulated per ROW (sum over valid rows, count = n_valid), not per
    batch, which also weights uneven batches correctly.
    """
    from ..midi.vocab import PAD_ID
    from .loss import kl_divergence, masked_cross_entropy

    def eval_fn(params, tokens, seq_lens, classes, labels, n_valid):
        logits, mu, logvar = model(params, tokens, seq_lens, classes)
        return _eval_metrics(logits, mu, logvar, labels, n_valid)

    def raw_eval_fn(params, chunks, classes, n_valid):
        from ..data.dataset import device_layout_chunks

        tokens, seq_lens, labels = device_layout_chunks(chunks)
        return eval_fn(params, tokens, seq_lens, classes, labels, n_valid)

    def _eval_metrics(logits, mu, logvar, labels, n_valid):
        B = labels.shape[0]
        row_mask = jnp.arange(B) < n_valid
        labels = jnp.where(row_mask[:, None], labels, PAD_ID)
        ce = masked_cross_entropy(
            logits, labels, loss_config.label_smoothing, loss_config.normalize
        )  # [B]; wrap rows are all-PAD now -> 0
        kl = kl_divergence(mu, logvar)  # [B]
        rm = row_mask.astype(jnp.float32)
        n = jnp.sum(rm)
        metrics = step_metrics(logits, labels, {})
        metrics["ce_loss"] = (jnp.sum(ce * rm), n)
        metrics["kl_loss"] = (jnp.sum(kl * rm), n)
        metrics["total_loss"] = (
            jnp.sum((ce + loss_config.kl_weight * kl) * rm), n
        )
        return metrics

    jitted = jax.jit(eval_fn)
    jitted_raw = jax.jit(raw_eval_fn)

    def run(params, *inputs):
        # (tokens, seq_lens, classes, labels, n_valid) host layout, or
        # (chunks, classes, n_valid) device layout.
        return (jitted if len(inputs) == 5 else jitted_raw)(params, *inputs)

    return run
