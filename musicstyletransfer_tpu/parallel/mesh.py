"""Device mesh + sharding rules (jax.sharding / pjit).

The reference has no distribution of any kind (SURVEY.md §2: single
mx.Context, main.py:124). The JAX equivalent is a single-program
``jax.jit`` over a 2D ``Mesh``:

- axis "data":  batch (data parallelism); gradient psum is inserted by XLA.
- axis "model": tensor parallelism over attention heads / FFN hidden dim.

Collectives are inserted by XLA's GSPMD partitioner — never hand-rolled.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_DATA = "data"
AXIS_MODEL = "model"

# Current-mesh registry: model code (e.g. the sequence-sharding constraint
# in TransformerStack) needs a concrete Mesh to build NamedShardings at
# trace time; the train step sets it while tracing.
import contextlib as _contextlib
import threading as _threading

_MESH_TLS = _threading.local()


@_contextlib.contextmanager
def use_mesh(mesh: "Mesh"):
    prev = getattr(_MESH_TLS, "mesh", None)
    _MESH_TLS.mesh = mesh
    try:
        yield mesh
    finally:
        _MESH_TLS.mesh = prev


def current_mesh():
    return getattr(_MESH_TLS, "mesh", None)


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    tp: int = 1,
) -> Mesh:
    """Build a (data, model) mesh over ``devices`` with ``tp``-way tensor
    parallelism; the rest of the devices form the data axis."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    assert n % tp == 0, f"{n} devices not divisible by tp={tp}"
    arr = np.asarray(devices).reshape(n // tp, tp)
    return Mesh(arr, (AXIS_DATA, AXIS_MODEL))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis batch sharding over the data axis."""
    return NamedSharding(mesh, P(AXIS_DATA))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# Tensor-parallel partition rules, matched against "/"-joined param paths.
# Column-parallel projections shard the output dim; row-parallel shard the
# input dim (Megatron-style pairing keeps the activations' collective count
# at one psum per block).
_TP_RULES = (
    (re.compile(r"(w_q|w_k|w_v|ff1)/kernel$"), P(None, AXIS_MODEL)),
    (re.compile(r"(w_q|w_k|w_v|ff1)/bias$"), P(AXIS_MODEL)),
    (re.compile(r"(w_o|ff2)/kernel$"), P(AXIS_MODEL, None)),
    # w_o/ff2 bias, embeddings, layernorms, latent/output heads: replicated.
)


def param_spec(path: str) -> P:
    for pattern, spec in _TP_RULES:
        if pattern.search(path):
            return spec
    return P()


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """NamedSharding pytree for a parameter pytree (TP rules + replication)."""

    def _path_str(path) -> str:
        return "/".join(
            getattr(k, "key", getattr(k, "idx", None)).__str__() for k in path
        )

    def _one(path, leaf):
        spec = param_spec(_path_str(path))
        # Don't shard dims that do not divide evenly (e.g. tiny test configs).
        for axis_idx, axis_name in enumerate(spec):
            if axis_name is None:
                continue
            size = mesh.shape[axis_name]
            if axis_idx >= leaf.ndim or leaf.shape[axis_idx] % size != 0:
                return NamedSharding(mesh, P())
        return NamedSharding(mesh, spec)

    return jax.tree_util.tree_map_with_path(_one, params)


def shard_params(params: Any, mesh: Mesh) -> Any:
    """Place a parameter pytree onto the mesh per the TP rules."""
    return jax.device_put(params, param_shardings(params, mesh))


def shard_batch(batch_arrays: Any, mesh: Mesh) -> Any:
    """Place batch arrays (leading batch axis) onto the data axis."""
    return jax.device_put(batch_arrays, batch_sharding(mesh))


def unchecked_shard_map():
    """``shard_map`` with the replication checker OFF, version-portable.

    Manual collectives inside the mapped body (ppermute rings) trip the
    checker, whose kwarg was renamed check_rep ->
    check_vma across jax versions; this is the one place that smooths
    both over (used by ops/ring_attention.py and parallel/pipeline.py).
    """
    import functools
    import inspect

    try:  # jax >= 0.4.35 exposes shard_map at the top level
        from jax import shard_map as raw
    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map as raw

    kw = ("check_vma"
          if "check_vma" in inspect.signature(raw).parameters
          else "check_rep")
    return functools.partial(raw, **{kw: False})
