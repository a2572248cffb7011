"""Real 2-process distributed CPU test (SURVEY.md §5.8 multi-process
readiness): two OS processes, gloo collectives, 2 virtual
CPU devices each, data-parallel training through the REAL Trainer with
process-sharded data loading and global-array assembly. Both processes must
agree with each other bitwise and with a single-process run numerically."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "dist_worker.py")
STEPS = 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("pid,per_host,want", [
    (0, 4, 0), (3, 4, 3), (4, 4, 0), (9, 8, 1), (15, 8, 7),
])
def test_gpu_process_owns_its_local_card(monkeypatch, pid, per_host, want):
    """A rank beyond the host's card count maps to its local card, not to
    a card index the host does not have."""
    from musicstyletransfer_tpu.parallel import distributed

    seen = {}
    monkeypatch.setattr(distributed.jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    distributed.initialize_distributed("localhost:1", num_processes=16,
                                       process_id=pid, gpus_per_host=per_host)
    assert seen == {"coordinator_address": "localhost:1",
                    "num_processes": 16, "process_id": pid,
                    "local_device_ids": [want]}


def test_gpu_single_host_default_and_bad_count(monkeypatch):
    from musicstyletransfer_tpu.parallel import distributed

    seen = {}
    monkeypatch.setattr(distributed.jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    distributed.initialize_distributed("localhost:1", num_processes=4,
                                       process_id=3)
    assert seen["local_device_ids"] == [3]
    with pytest.raises(ValueError, match="gpus_per_host"):
        distributed.gpu_local_device_ids(0, 0)


@pytest.fixture(scope="module")
def dist_results():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), f"localhost:{port}",
             str(STEPS)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


class TestTwoProcessCLI:
    def test_train_cli_end_to_end(self, tmp_path):
        """The full --dist-coordinator CLI path: corpus load, process-
        sharded batches, sharded training, primary-only checkpointing."""
        from musicstyletransfer_tpu.midi.codec import Melody, MelodyWriter
        from musicstyletransfer_tpu.midi.vocab import note_off_id, note_on_id

        corpus = tmp_path / "corpus"
        writer = MelodyWriter()
        rng = np.random.default_rng(0)
        for cls in ("alpha", "beta"):
            (corpus / cls).mkdir(parents=True)
            for i in range(2):
                pitches = rng.integers(40, 80, 24)
                toks = []
                for p in pitches:
                    toks += [note_on_id(int(p)), note_off_id(int(p))]
                writer.write_to_file(
                    str(corpus / cls / f"m{i}.mid"),
                    Melody(tokens=np.asarray(toks, np.int32)),
                )

        model_dir = tmp_path / "model"
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env["JAX_PLATFORMS"] = "cpu"

        def args(pid):
            return [
                sys.executable, "-m", "musicstyletransfer_tpu.cli.main",
                "--data", str(corpus), "--model-output", str(model_dir),
                "--out-samples", str(tmp_path / "samples"),
                "--batch-size", "4", "--max-seq-len", "8", "--epochs", "2",
                "--cpu", "--prefetch", "0", "--validation-split", "0.5",
                "--checkpoint-frequency", "3", "--sampling-frequency", "0",
                "--dist-coordinator", f"localhost:{port}",
                "--dist-num-processes", "2", "--dist-process-id", str(pid),
                "--dist-num-cpu-devices", "2",
            ]

        procs = [
            subprocess.Popen(args(pid), env=env, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for pid in (0, 1)
        ]
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"CLI worker failed:\n{out}\n{err}"
            outs.append(out)
        for out in outs:
            assert "Training finished." in out
            assert "Process " in out  # dist banner
        # the primary checkpointed; params.N + bookkeeping exist once
        names = os.listdir(model_dir)
        assert any(n.startswith("params.") for n in names), names
        assert "train_state.json" in names


class TestTwoProcessTraining:
    def test_processes_agree_bitwise(self, dist_results):
        a, b = dist_results
        assert a["steps"] == b["steps"] == STEPS
        assert a["param_checksum"] == b["param_checksum"]
        assert a["mean_total_loss"] == b["mean_total_loss"]

    def test_matches_single_process_run(self, dist_results):
        """Same data, same seeds, single process on the 8-device CPU mesh."""
        from musicstyletransfer_tpu.data import MelodyDataset
        from musicstyletransfer_tpu.midi.codec import Melody
        from musicstyletransfer_tpu.models import init_params, make_model
        from musicstyletransfer_tpu.parallel import make_mesh
        from musicstyletransfer_tpu.training import TrainConfig, Trainer
        from tests.test_model import tiny_config

        mel = {"a": [Melody(tokens=np.arange(10, 52, dtype=np.int32))],
               "b": [Melody(tokens=np.arange(12, 44, dtype=np.int32))]}
        ds = MelodyDataset(4, 4, mel, seed=11)
        cfg = tiny_config(vocab=60, classes=2, latent=8, size=16, heads=2,
                          layers=1)
        model = make_model(cfg)
        params = init_params(model, jax.random.key(0), max_seq_len=4)
        mesh = make_mesh(jax.devices("cpu")[:4], tp=1)
        tcfg = TrainConfig(batch_size=4, sampling_frequency=0,
                           checkpoint_frequency=10 ** 9,
                           num_checkpoints_not_improved=-1, prefetch=0,
                           logdir="/tmp/dist-ref-tb", log_every=10 ** 9)
        t = Trainer(tcfg, model, params, sampler=None, mesh=mesh)
        n = 0
        while n < STEPS:
            for batch in ds:
                t._step(batch)
                n += 1
                if n >= STEPS:
                    break
        vals = t._drain_metrics()
        checksum = float(
            sum(float(jnp.sum(jnp.abs(x)))
                for x in jax.tree.leaves(jax.device_get(t.state.params)))
        )
        a = dist_results[0]
        np.testing.assert_allclose(
            a["mean_total_loss"], vals["total_loss"], rtol=1e-4
        )
        np.testing.assert_allclose(a["param_checksum"], checksum, rtol=1e-4)


class TestFaultInjection:
    """kill -9 one worker mid-run — including while an
    async checkpoint save is in flight — restart the pair, and the run must
    resume from the last COMPLETE checkpoint bitwise with assert_in_sync
    passing. Recovery semantics: Trainer._load_latest_checkpoint walks
    checkpoints newest-first (saves commit by atomic rename, so an
    interrupted save usually just never appears; a corrupt survivor falls
    back to its predecessor)."""

    def test_kill9_midrun_resumes_bitwise(self, tmp_path):
        import time as _time

        folder = str(tmp_path / "fault-model")
        worker = os.path.join(REPO, "tests", "dist_fault_worker.py")
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}

        def spawn(mode, port):
            return [
                subprocess.Popen(
                    [sys.executable, worker, str(pid), f"localhost:{port}",
                     folder, mode],
                    env=env, cwd=REPO, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True,
                )
                for pid in (0, 1)
            ]

        # Phase 1: run until worker 1 SIGKILLs itself right after starting
        # checkpoint 3's save; then SIGKILL the primary while its own save
        # may still be in flight (whole-job preemption).
        procs = spawn("crash", _free_port())
        out1, err1 = procs[1].communicate(timeout=600)
        assert procs[1].returncode == -9, (
            f"worker 1 should die by SIGKILL:\n{out1}\n{err1}")
        _time.sleep(2.0)
        procs[0].kill()
        out0, err0 = procs[0].communicate(timeout=120)
        # Both workers recorded two DURABLE checkpoints before the crash.
        names = os.listdir(folder)
        assert "params.1" in names and "params.2" in names, names
        assert "checksums.jsonl" in names, names

        # Phase 2: fresh pair on the same folder resumes and continues.
        procs = spawn("resume", _free_port())
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"resume worker failed:\n{out}\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
        for o in outs:
            # Resumed from the last COMPLETE checkpoint (2 if save 3 was
            # interrupted before its atomic commit; 3 if it won the race),
            # with bitwise-identical params to what that save serialized.
            assert o["resumed_from"] in (2, 3), o
            assert o["sha_match"], o
            assert o["resumed_step"] == 4 * o["resumed_from"], o
            assert o["final_ckpt"] == o["resumed_from"] + 1, o
        assert outs[0]["resumed_from"] == outs[1]["resumed_from"]
        assert os.path.isdir(os.path.join(
            folder, f"params.{outs[0]['final_ckpt']}")), os.listdir(folder)


class TestTPCheckpointAcrossProcesses:
    """multi-process TP states must checkpoint and
    restore bitwise through the collective gather-to-primary save."""

    def test_tp2_save_restore_bitwise(self, tmp_path):
        folder = str(tmp_path / "tp-ckpt")
        os.makedirs(folder, exist_ok=True)
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        worker = os.path.join(REPO, "tests", "dist_ckpt_worker.py")
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(pid), f"localhost:{port}",
                 folder],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )
            for pid in (0, 1)
        ]
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"ckpt worker failed:\n{out}\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
        for o in outs:
            assert o["model_axis_spans_processes"], o
            assert o["params_match"], o
            assert o["opt_match"], o
            assert o["step_match"], o
            assert o["rng_match"], o
        # one durable checkpoint on disk
        assert os.path.isdir(os.path.join(folder, "params.1"))
