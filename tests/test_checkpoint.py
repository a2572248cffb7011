"""The numpy checkpoint format (training/checkpoint.py): round trips
(synchronous, asynchronous, sharded on the 8-device CPU mesh), the atomic
commit, the manifest, and the errors a wrong template raises."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.models import init_params, make_model
from musicstyletransfer_tpu.parallel import make_mesh
from musicstyletransfer_tpu.training import (
    OptimizerConfig,
    build_optimizer,
    create_train_state,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
    shard_train_state,
)
from musicstyletransfer_tpu.training import checkpoint as ckpt
from tests.test_model import tiny_config


def _state(seed=0, rng_impl="threefry2x32", size=16):
    model = make_model(tiny_config(size=size, heads=2))
    params = init_params(model, jax.random.key(seed), max_seq_len=4)
    tx = build_optimizer(OptimizerConfig("adam", "clip_gradient:1.0", 1e-3))
    state = create_train_state(params, tx,
                               jax.random.key(seed + 1, impl=rng_impl))
    # Non-trivial optimizer moments: one fake update.
    grads = jax.tree.map(jnp.ones_like, params)
    updates, opt = tx.update(grads, state.opt_state, params)
    return state.replace(step=jnp.asarray(5, jnp.int32), opt_state=opt), tx


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def _assert_same_state(restored, state):
    assert _leaves_equal(restored.params, state.params)
    assert _leaves_equal(restored.opt_state, state.opt_state)
    assert int(restored.step) == int(state.step)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(restored.rng)),
        np.asarray(jax.random.key_data(state.rng)))


@pytest.mark.parametrize("rng_impl", ["threefry2x32", "rbg"])
def test_sync_round_trip(tmp_path, rng_impl):
    state, _ = _state(rng_impl=rng_impl)
    save_checkpoint(str(tmp_path), 1, state)
    template, _ = _state(seed=9)
    restored = restore_checkpoint(str(tmp_path), 1, template)
    _assert_same_state(restored, state)
    assert str(jax.random.key_impl(restored.rng)) == rng_impl


def test_async_round_trip(tmp_path):
    """The async save returns after the host snapshot; the state may be
    overwritten (as a donating train step would) before the write ends."""
    state, _ = _state()
    saver = ckpt.AsyncCheckpointer()
    save_checkpoint(str(tmp_path), 2, state, checkpointer=saver)
    expected = jax.tree.map(np.asarray, state.params)
    state = state.replace(params=jax.tree.map(lambda x: x * 0, state.params))
    saver.wait_until_finished()
    template, _ = _state(seed=9)
    restored = restore_checkpoint(str(tmp_path), 2, template)
    assert _leaves_equal(restored.params, expected)


def test_async_write_errors_surface_on_wait(tmp_path):
    saver = ckpt.AsyncCheckpointer()

    def boom():
        raise OSError("disk full")

    saver.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        saver.wait_until_finished()
    saver.wait_until_finished()  # the error is reported once


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_round_trip_any_layout(tmp_path, cpu_devices, tp):
    """Save a state sharded over an 8-device mesh, restore it into a
    template on ANOTHER layout (and unsharded): same values, and the
    restored leaves take the template's shardings."""
    state, _ = _state(size=32)
    mesh = make_mesh(cpu_devices[:8], tp=tp)
    sharded = shard_train_state(state, mesh)
    save_checkpoint(str(tmp_path), 3, sharded)

    other = make_mesh(cpu_devices[:4], tp=4 // tp if tp > 1 else 1)
    template, _ = _state(seed=9, size=32)
    template = shard_train_state(template, other)
    restored = restore_checkpoint(str(tmp_path), 3, template)
    _assert_same_state(restored, state)
    for got, tmpl in zip(jax.tree.leaves(restored.params),
                         jax.tree.leaves(template.params)):
        assert got.sharding == tmpl.sharding

    plain, _ = _state(seed=9, size=32)
    _assert_same_state(restore_checkpoint(str(tmp_path), 3, plain), state)


def test_layout_on_disk_and_atomic_commit(tmp_path):
    state, _ = _state()
    folder = str(tmp_path)
    save_checkpoint(folder, 4, state)
    path = os.path.join(folder, "params.4")
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert manifest["format"] == ckpt.FORMAT and manifest["step"] == 5
    assert "params/encoder/token_emb/embedding" in manifest["keys"]
    # A leftover temporary directory of an interrupted save is not a
    # checkpoint, and a re-save replaces the committed one.
    os.makedirs(os.path.join(folder, "params.5.tmp-123"))
    assert ckpt.checkpoint_indices(folder) == [4]
    save_checkpoint(folder, 4, state.replace(step=jnp.asarray(6)))
    with open(os.path.join(path, "manifest.json")) as fh:
        assert json.load(fh)["step"] == 6


def test_structure_mismatch_raises(tmp_path):
    state, _ = _state(size=16)
    save_checkpoint(str(tmp_path), 1, state)
    wider, _ = _state(size=32)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, wider)
    params = dict(state.params)
    params["extra"] = {"kernel": jnp.zeros((2, 2))}
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_params(str(tmp_path), 1, params)


def test_unknown_format_raises(tmp_path):
    state, _ = _state()
    save_checkpoint(str(tmp_path), 1, state)
    mpath = os.path.join(str(tmp_path), "params.1", "manifest.json")
    with open(mpath) as fh:
        manifest = json.load(fh)
    manifest["format"] = "something-else"
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)
    with pytest.raises(ValueError, match="format"):
        restore_checkpoint(str(tmp_path), 1, state)


def test_restore_params_returns_host_arrays(tmp_path):
    state, _ = _state()
    save_checkpoint(str(tmp_path), 7, state)
    params = restore_params(str(tmp_path), 7, state.params)
    assert all(isinstance(x, np.ndarray) for x in jax.tree.leaves(params))
    assert _leaves_equal(params, state.params)


def test_shipped_checkpoints_are_npz():
    """The shipped models are in the current format (no OCDBT left)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for folder in ("models/guitar_bass/params.6",
                   "models/gan_guitar_bass/generator/params.1"):
        names = sorted(os.listdir(os.path.join(repo, folder)))
        assert names == ["arrays.npz", "manifest.json"], (folder, names)
