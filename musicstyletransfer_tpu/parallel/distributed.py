"""Multi-process (multi-host) readiness: guarded jax.distributed init,
process-sharded data loading, and global-array assembly.

The reference has nothing distributed (SURVEY.md §2/§5.8). Single-process
multi-device training is covered by mesh.py (GSPMD); this module adds the
multi-process layer for several GPU processes or CPU fleets: every process
runs the same program, `jax.distributed.initialize` wires the coordination
service, each process feeds its slice of every global batch, and XLA's
collectives span processes transparently. Process identity is resolved
PER MESH (from the mesh's devices), so a mesh over a subset of the
processes' devices works too.

Validated by a real 2-process CPU test (tests/test_distributed.py): gloo
collectives, 2 processes x 2 virtual CPU devices, DP training step matching
the single-process trajectory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import jax
import numpy as np

from .mesh import batch_sharding


def gpu_local_device_ids(process_id: int, gpus_per_host: int) -> list:
    """The one local card that process ``process_id`` owns, when processes
    are numbered host by host with one process per card: its local rank
    ``process_id % gpus_per_host``."""
    if gpus_per_host < 1:
        raise ValueError(f"gpus_per_host must be >= 1, got {gpus_per_host}")
    return [process_id % gpus_per_host]


def initialize_distributed(
    coordinator: str,
    num_processes: int,
    process_id: int,
    cpu_collectives: str = "gloo",
    num_cpu_devices: Optional[int] = None,
    gpus_per_host: Optional[int] = None,
) -> None:
    """Guarded `jax.distributed.initialize` for multi-process runs.

    Must run before any JAX backend is touched. CPU fleets (tests, dev;
    ``num_cpu_devices`` given) also select the cross-process CPU
    collectives implementation and the per-process virtual device count.
    Otherwise each process owns one GPU of its host alone
    (``local_device_ids``, see gpu_local_device_ids): a JAX process
    reserves most of a card's memory, so two processes must never open the
    same card. ``gpus_per_host`` None assumes a single host, every process
    on it (``gpus_per_host = num_processes``); multi-host runs pass the
    number of processes (cards) per host.
    """
    kwargs = {}
    if num_cpu_devices is not None:
        jax.config.update("jax_num_cpu_devices", num_cpu_devices)
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
    else:
        kwargs["local_device_ids"] = gpu_local_device_ids(
            process_id, gpus_per_host or num_processes)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """Process identity RELATIVE TO A MESH (see module docstring)."""

    index: int
    count: int

    @property
    def is_primary(self) -> bool:
        return self.index == 0


def is_addressable(device) -> bool:
    """Is this device local to the current process? (There is no public
    Device.addressable; a device is local iff its process_index equals its
    client's.)"""
    return device.process_index == device.client.process_index()


def mesh_process_info(mesh) -> ProcessInfo:
    """Which of the mesh's participating processes is this one?"""
    devices = list(mesh.devices.flat)
    procs = sorted({d.process_index for d in devices})
    local = {d.process_index for d in devices if is_addressable(d)}
    if not local:
        raise ValueError("mesh has no addressable devices in this process")
    if len(local) != 1:
        raise ValueError(f"ambiguous local process ids {local}")
    return ProcessInfo(index=procs.index(next(iter(local))), count=len(procs))


def sharding_is_fully_addressable(sharding) -> bool:
    return all(is_addressable(d) for d in sharding.device_set)


def host_to_global(x: Any, sharding) -> jax.Array:
    """`device_put` that also works when ``sharding`` spans devices of OTHER
    processes (plain device_put refuses non-addressable shardings): every
    process places its own shards and assembles the global jax.Array.

    ``x`` must hold the full GLOBAL value (identical on every process) —
    fine for replicated scalars/params and for deterministic init.
    """
    x = np.asarray(jax.device_get(x))
    idx_map = sharding.addressable_devices_indices_map(x.shape)
    shards = [jax.device_put(x[idx], d) for d, idx in idx_map.items()]
    return jax.make_array_from_single_device_arrays(x.shape, sharding, shards)


def global_device_put(x: Any, sharding) -> jax.Array:
    """device_put with a multi-process fallback (see host_to_global)."""
    if sharding_is_fully_addressable(sharding):
        return jax.device_put(x, sharding)
    return host_to_global(x, sharding)


def make_global_batch(local: Any, mesh, global_batch: int) -> Any:
    """Assemble per-process batch slices into global jax.Arrays sharded over
    the mesh's data axis.

    ``local`` is a pytree of host arrays holding THIS process's rows — the
    contiguous slice [index * k, (index + 1) * k) of the global batch in
    mesh-device order, k = global_batch / process count. Shard placement
    follows ``sharding.addressable_devices_indices_map``, which handles
    replication across the model axis (tp > 1: several devices hold the
    same data block). Uses `make_array_from_single_device_arrays` directly
    so that the layout follows the MESH's processes, not the default
    backend's.
    """
    sharding = batch_sharding(mesh)

    def one(x):
        x = np.asarray(x)
        global_shape = (global_batch,) + x.shape[1:]
        idx_map = sharding.addressable_devices_indices_map(global_shape)
        row_slices = {
            d: (idx[0].start or 0, idx[0].stop if idx[0].stop is not None
                else global_batch)
            for d, idx in idx_map.items()
        }
        lo = min(s for s, _ in row_slices.values())
        hi = max(e for _, e in row_slices.values())
        if hi - lo != x.shape[0]:
            raise ValueError(
                f"local rows {x.shape[0]} do not cover this process's "
                f"global slice [{lo}, {hi})"
            )
        shards = [
            jax.device_put(x[s - lo : e - lo], d)
            for d, (s, e) in row_slices.items()
        ]
        return jax.make_array_from_single_device_arrays(
            global_shape, sharding, shards
        )

    return jax.tree.map(one, local)


def assert_in_sync(mesh, value: float, what: str) -> None:
    """Verify every participating process computed the same ``value`` (a
    real cross-process collective — catches e.g. a resume where only the
    primary found a checkpoint because model_folder is not shared)."""
    import jax.numpy as jnp

    from .mesh import AXIS_DATA

    info = mesh_process_info(mesh)
    if info.count == 1:
        return
    data_size = int(mesh.shape[AXIS_DATA])
    rows = data_size // info.count
    if rows == 0 or data_size % info.count:
        return  # degenerate mesh: cannot build a per-process row block
    g = make_global_batch(
        np.full((rows,), value, np.float32), mesh, data_size
    )
    spread = float(jnp.max(g) - jnp.min(g))
    if spread != 0.0:
        raise RuntimeError(
            f"processes disagree on {what} (spread {spread}); in "
            "multi-process runs model_folder (and the corpus) must be "
            "shared storage visible to every process"
        )


class ProcessShardedDataset:
    """Each process iterates the SAME deterministic batch stream (same
    dataset seed on every process) and keeps only its slice of each batch.

    Presents the Dataset surface; yielded batches have
    batch_size / process_count rows (global batch stays ``batch_size``).
    """

    def __init__(self, dataset, info: ProcessInfo):
        if dataset.batch_size % info.count != 0:
            raise ValueError(
                f"global batch {dataset.batch_size} not divisible by "
                f"{info.count} processes"
            )
        self._dataset = dataset
        self._info = info
        self._rows = dataset.batch_size // info.count

    def num_classes(self) -> int:
        return self._dataset.num_classes()

    def num_tokens(self) -> int:
        return self._dataset.num_tokens()

    @property
    def batch_size(self) -> int:
        return self._dataset.batch_size

    @property
    def local_batch_size(self) -> int:
        return self._rows

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def __iter__(self):
        lo = self._info.index * self._rows
        hi = lo + self._rows
        for batch in self._dataset:
            yield _slice_batch(batch, lo, hi)


def _slice_batch(batch, lo: int, hi: int):
    import dataclasses as dc

    fields = {}
    for f in dc.fields(batch):
        v = getattr(batch, f.name)
        if f.name == "n_valid":
            # valid rows inside THIS slice
            nv = batch.num_valid
            fields[f.name] = int(np.clip(nv - lo, 0, hi - lo))
        else:
            fields[f.name] = v[lo:hi]
    return type(batch)(**fields)
