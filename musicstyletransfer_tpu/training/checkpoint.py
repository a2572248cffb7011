"""Checkpoint/resume: numpy ``.npz`` array state + JSON manifest and sidecar.

Reference semantics (trainer.py:188-233, utils.py:15-44): checkpoints live
in ``{model_folder}/params.{n}`` with a separate training-bookkeeping file;
resume scans for the latest index. Improvements over the reference:

- optimizer state IS checkpointed (the reference loses it on resume);
- the latest-checkpoint regex captures all digits (the reference's
  ``params.(\\d)+`` captures one — SURVEY.md §8.11 — so resume after >= 10
  checkpoints picked the wrong file);
- bookkeeping is JSON, not pickle.

On-disk layout of ``params.{n}/``: ``arrays.npz`` holds every array leaf
under its tree path (``params/encoder/token_emb/embedding``,
``opt_state/1/0/mu/...``, ``step``, ``rng``); ``manifest.json`` records the
format, the step and the PRNG implementation of the stored key. A save
writes into a temporary sibling directory and commits it with one
``os.rename``, so an interrupted save never leaves a partial ``params.N``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, Optional

import jax
import numpy as np

from .train_step import TrainState

_CKPT_RE = re.compile(r"^params\.(\d+)$")
TRAIN_STATE_FILE = "train_state.json"
ARRAYS_FILE = "arrays.npz"
MANIFEST_FILE = "manifest.json"
FORMAT = "mst-npz-1"


@dataclasses.dataclass
class TrainingProgress:
    """Bookkeeping across checkpoints (reference TrainingState, trainer.py:60-65)."""

    n_checkpoints: int = 0
    n_batches: int = 0
    num_checkpoints_not_improved: int = 0
    best_reconstruction_loss: float = float("inf")

    def save(self, model_folder: str) -> None:
        with open(os.path.join(model_folder, TRAIN_STATE_FILE), "w") as fh:
            json.dump(dataclasses.asdict(self), fh)

    @classmethod
    def load(cls, model_folder: str) -> "TrainingProgress":
        with open(os.path.join(model_folder, TRAIN_STATE_FILE)) as fh:
            return cls(**json.load(fh))


def checkpoint_indices(model_folder: str):
    """Sorted params.N indices present in the folder (may be empty)."""
    return sorted(
        int(m.group(1))
        for m in (_CKPT_RE.match(n) for n in os.listdir(model_folder))
        if m
    )


def get_latest_checkpoint_index(model_folder: str) -> int:
    """Largest N among params.N entries (reference: utils.py:15-25, fixed)."""
    indices = checkpoint_indices(model_folder)
    if not indices:
        raise ValueError(f"No checkpoints found in {model_folder}")
    return indices[-1]


def checkpoint_path(model_folder: str, index: int) -> str:
    return os.path.abspath(os.path.join(model_folder, f"params.{index}"))


class AsyncCheckpointer:
    """Runs checkpoint writes on a host thread, at most one in flight.

    ``save_checkpoint`` takes the device->host snapshot on the caller's
    thread (so the train step may donate the state right after) and hands
    only the disk write to this thread. ``wait_until_finished`` joins the
    write in flight and re-raises its error, if any."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, write: Callable[[], None]) -> None:
        self.wait_until_finished()

        def run() -> None:
            try:
                write()
            except BaseException as e:  # re-raised by wait_until_finished
                self._error = e

        self._thread = threading.Thread(target=run, name="mst-ckpt-write",
                                        daemon=True)
        self._thread.start()

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def _key_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _path_str(path) -> str:
    return "/".join(_key_name(k) for k in path)


def _flatten(tree, prefix: str) -> Dict[str, Any]:
    """{"prefix/a/b": leaf} for every leaf of ``tree``."""
    return {
        f"{prefix}/{_path_str(path)}" if path else prefix: leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _multiprocess() -> bool:
    return jax.process_count() > 1


def _barrier(name: str) -> None:
    if _multiprocess():
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def _gather_to_host(tree, fetch: bool = True):
    """Fetch every leaf to the host, replicating sharded ones first.

    COLLECTIVE when a leaf spans several processes: every process must
    call this with the same tree. The ``out_shardings``-only jitted
    identity compiles to XLA all-gathers; afterwards each leaf is fully
    replicated, so a plain host fetch is legal on every process. Host
    memory stays bounded: ``fetch=False`` (non-primary processes) takes
    part in the collectives and materializes NOTHING on the host, and the
    fetching primary pulls one leaf at a time (device_get syncs per leaf,
    so replicated device buffers are freed as the walk advances rather
    than all held at once)."""
    def one(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            x = _replicate_fn(x.sharding.mesh)(x)
        return np.asarray(jax.device_get(x)) if fetch else None

    return jax.tree.map(one, tree)


@functools.lru_cache(maxsize=8)
def _replicate_fn(mesh):
    """One cached jitted all-gather identity per mesh: jit caching is
    keyed on function identity, so building a fresh lambda per leaf per
    save would re-lower and recompile the same program dozens of times
    every checkpoint tick."""
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.jit(
        lambda a: a, out_shardings=NamedSharding(mesh, PartitionSpec())
    )


def _write(path: str, arrays: Dict[str, np.ndarray], manifest: dict) -> None:
    """Write one checkpoint directory and commit it by atomic rename."""
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, ARRAYS_FILE), "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    manifest = dict(manifest, keys={
        k: [list(v.shape), str(v.dtype)] for k, v in arrays.items()
    })
    with open(os.path.join(tmp, MANIFEST_FILE), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def write_state(path: str, step, params, opt_state, rng_data: np.ndarray,
                rng_impl: str) -> None:
    """Write host trees as one checkpoint directory at ``path``."""
    arrays = {"step": np.asarray(step), "rng": np.asarray(rng_data)}
    arrays.update(_flatten(params, "params"))
    arrays.update(_flatten(opt_state, "opt_state"))
    _write(path, {k: np.asarray(v) for k, v in arrays.items()},
           {"format": FORMAT, "step": int(np.asarray(step)),
            "rng_impl": rng_impl})


def save_checkpoint(
    model_folder: str,
    index: int,
    state: TrainState,
    checkpointer: Optional[AsyncCheckpointer] = None,
) -> None:
    """Write params.{index}. With a caller-owned ``checkpointer`` the save is
    ASYNC: this returns once the device->host snapshot is taken (safe even
    though the train step donates the state), while the disk write
    proceeds on the checkpointer's host thread — checkpoint ticks no
    longer stall the device. Call ``checkpointer.wait_until_finished()``
    before relying on the files (the Trainer does this on exit and before
    any restore). Without one, the save blocks until durable.

    Multi-process runs: this is a COLLECTIVE — every process must call it
    with its (sharded) state. Leaves that span processes are all-gathered
    one at a time (_gather_to_host) and materialized on the PRIMARY only,
    which writes one ordinary checkpoint; the bytes on disk are the full
    global arrays, so any process count and any mesh layout (including
    single-process inference) can restore it. A synchronous save returns
    on every process only once the checkpoint is durable."""
    path = checkpoint_path(model_folder, index)
    if checkpointer is not None:
        checkpointer.wait_until_finished()  # at most one save in flight
    primary = jax.process_index() == 0
    step = np.asarray(jax.device_get(state.step))
    params = _gather_to_host(state.params, fetch=primary)
    opt_state = _gather_to_host(state.opt_state, fetch=primary)
    rng_data = _gather_to_host(jax.random.key_data(state.rng), fetch=primary)
    rng_impl = str(jax.random.key_impl(state.rng))
    if primary:
        write = functools.partial(write_state, path, step, params, opt_state,
                                  rng_data, rng_impl)
        if checkpointer is None:
            write()
        else:
            checkpointer.submit(write)
    if checkpointer is None:
        # Synchronous semantics: every process returns only once the
        # checkpoint is durable (a non-primary might restore it next).
        _barrier(f"mst-ckpt-durable-{index}")


def _read(model_folder: str, index: int):
    path = checkpoint_path(model_folder, index)
    with open(os.path.join(path, MANIFEST_FILE)) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format "
                         f"{manifest.get('format')!r}")
    with np.load(os.path.join(path, ARRAYS_FILE)) as npz:
        arrays = {k: npz[k] for k in npz.files}
    return manifest, arrays


def _fill(template, prefix: str, arrays: Dict[str, np.ndarray], where: str):
    """Host tree shaped like ``template`` with leaves read from ``arrays``."""
    leaves_with_path, treedef = jax.tree_util.tree_flatten_with_path(template)
    want = {f"{prefix}/{_path_str(p)}" for p, _ in leaves_with_path}
    have = {k for k in arrays if k.startswith(prefix + "/")}
    if want != have:
        missing, extra = sorted(want - have), sorted(have - want)
        raise ValueError(
            f"{where}: {prefix} structure mismatch (missing {missing[:5]}, "
            f"unexpected {extra[:5]})"
        )
    leaves = []
    for p, t in leaves_with_path:
        a = arrays[f"{prefix}/{_path_str(p)}"]
        if tuple(a.shape) != tuple(np.shape(t)):
            raise ValueError(f"{where}: {prefix}/{_path_str(p)} has shape "
                             f"{a.shape}, template {np.shape(t)}")
        leaves.append(a)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _place(host_tree, template_tree):
    """Put host leaves on the template leaves' shardings (every process
    places its own shards from the full host value)."""
    from ..parallel.distributed import global_device_put

    return jax.tree.map(
        lambda h, t: global_device_put(h, t.sharding)
        if isinstance(t, jax.Array) else h,
        host_tree, template_tree,
    )


def restore_checkpoint(
    model_folder: str, index: int, template: TrainState
) -> TrainState:
    """Restore params.{index} into the template's structure and layout.

    Every process reads the full arrays from the (shared) model folder and
    places its own shards per the template's shardings, so a checkpoint
    resumes under any mesh and any process count. The PRNG key is rebuilt
    with the implementation recorded at save time, so runs saved under
    another default impl keep resuming with THEIR impl."""
    where = checkpoint_path(model_folder, index)
    manifest, arrays = _read(model_folder, index)
    params = _fill(template.params, "params", arrays, where)
    opt_state = _fill(template.opt_state, "opt_state", arrays, where)
    return TrainState(
        step=jax.numpy.asarray(arrays["step"]),
        params=_place(params, template.params),
        opt_state=_place(opt_state, template.opt_state),
        rng=jax.random.wrap_key_data(
            jax.numpy.asarray(arrays["rng"]), impl=manifest["rng_impl"]
        ),
    )


def restore_params(model_folder: str, index: int, params_template):
    """Restore only model parameters as host arrays (inference path,
    reference sampler.py:32-37)."""
    where = checkpoint_path(model_folder, index)
    _, arrays = _read(model_folder, index)
    return _fill(params_template, "params", arrays, where)


def prune_checkpoints(model_folder: str, keep: int) -> None:
    """Delete all but the ``keep`` newest params.N directories (0 keeps
    everything — the reference's behavior; it never prunes)."""
    if keep <= 0:
        return
    indices = checkpoint_indices(model_folder)
    for idx in indices[:-keep]:
        shutil.rmtree(checkpoint_path(model_folder, idx), ignore_errors=True)


def try_latest(model_folder: str) -> Optional[int]:
    try:
        return get_latest_checkpoint_index(model_folder)
    except (ValueError, FileNotFoundError):
        return None
