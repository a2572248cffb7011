"""End-to-end smoke run of the system on one NVIDIA GPU.

    python chip_smoke.py               # phases (a)-(g) on one card
    python chip_smoke.py --four-cards  # the cross-device paths on four cards

One process drives the card through the entry points a user calls and
checks every result; any failure exits nonzero. Phases:

(a) device gate: JAX's default platform must be a GPU (never the CPU);
(b) canonical training through ``cli.main`` (scripts/train-vae.sh widths)
    on work/data/guitar_bass, then checkpoint restore and a finite eval;
(c) wide and long training steps (scripts/train-vae-{wide,long}.sh widths)
    with each step's compiled memory analysis, and cuDNN fused attention
    asserted in the long step's compiled HLO;
(d) style transfer (``cli.sample`` with models/guitar_bass) and the GAN
    (``cli.gan``: a few training steps, then ``--generate`` from
    models/gan_guitar_bass); every output MIDI must parse back;
(e) serving: the micro-batch service and the streaming engine answer
    requests in-process;
(f) numerics: attention against its float32 reference at the flagship,
    wide and long widths (forward and gradients, bf16 and f32), and the
    shipped checkpoints' teacher-forced logits against tests/goldens;
(g) baseline times, each printed beside the card's name and power limit.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
SHIPPED_VAE = os.path.join(REPO, "models", "guitar_bass")
SHIPPED_GAN = os.path.join(REPO, "models", "gan_guitar_bass")
GOLDENS = os.path.join(REPO, "tests", "goldens")

# Tolerances, with their reasons.
# f32 under "highest" matmul precision: only summation order differs from
# the float32 reference (no TF32 rounding), so agree to ~1e-6 relative.
TOL_F32 = 1e-4
# bf16 operands (cuDNN flash attention, or XLA below its crossover
# length): 8 mantissa bits on inputs,
# outputs and the P·V product; ~2^-8 relative per rounding, compounded
# over the softmax. Compared as max|a-b| / max|b|.
TOL_BF16 = 3e-2
# Goldens in bf16: against the float32 truth the card's bf16 path may be
# at most 25% less accurate (max and mean error) than the recorded bf16
# path was (same bound as tests/test_goldens.py).
BF16_GOLDEN_SLACK = 1.25
# One bf16 training step on a (data=2, model=2) mesh against one card: the
# model-axis split rounds partial matmul sums to bf16 before they are
# added (2^-8 relative each), compounded through 6 layers and the
# backward pass; bias gradients (sums of bf16 terms over B*T rows that
# largely cancel) amplify that most (1.6e-2 at a cut-down width on 4
# virtual CPU devices). Loss and per-parameter gradient norms, relative.
TOL_BF16_STEP = 5e-2

CARD = "unknown card"


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str):
    """Context manager printing a phase's wall time."""
    @contextlib.contextmanager
    def cm():
        t0 = time.perf_counter()
        log(f"--- {label}")
        yield
        log(f"--- {label}: done in {time.perf_counter() - t0:.1f} s")
    return cm()


def report_time(name: str, value: float, unit: str) -> None:
    log(f"TIME {name} = {value} {unit} [{CARD}]")


def script_args(name: str, **overrides) -> list:
    """The CLI flags of scripts/<name>, with ``${VAR:-default}`` expanded
    to its default and ``overrides`` (flag -> value) replacing flags."""
    argv, lines = [], open(os.path.join(REPO, "scripts", name)).read()
    for line in lines.replace("\\\n", "\n").splitlines():
        line = line.strip()
        if not line.startswith("--"):
            continue
        for tok in line.split():
            tok = tok.strip('"')
            if tok.startswith("${") and ":-" in tok:
                tok = tok[tok.index(":-") + 2:].rstrip("}")
            argv.append(tok)
    out, i = [], 0
    while i < len(argv):
        flag = argv[i]
        has_value = i + 1 < len(argv) and not argv[i + 1].startswith("--")
        value = argv[i + 1] if has_value else None
        key = flag[2:].replace("-", "_")
        if key in overrides:
            value = overrides.pop(key)
        if value is not False:
            out.append(flag)
            if value is not None and value is not True:
                out.append(str(value))
        i += 2 if has_value else 1
    for key, value in overrides.items():
        out.append("--" + key.replace("_", "-"))
        if value is not True:
            out.append(str(value))
    return out


def rel_err(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def block(x):
    import jax

    return jax.block_until_ready(x)


# --------------------------------------------------------------- (a) ----

def phase_device_gate():
    import jax

    from musicstyletransfer_tpu.hardware import card_info, require_gpu
    from musicstyletransfer_tpu.utils import configure_jax_cache

    global CARD
    devices = require_gpu()
    cache = configure_jax_cache()
    CARD = card_info().splitlines()[0]
    log(CARD)
    log(f"jax {jax.__version__}; devices: {len(devices)} x "
        f"{devices[0].device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    return devices


# --------------------------------------------------------------- (b) ----

def phase_canonical_training(tmp):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from musicstyletransfer_tpu.cli import main as cli_main
    from musicstyletransfer_tpu.data import Loader, MelodyDataset
    from musicstyletransfer_tpu.models import init_params, make_model
    from musicstyletransfer_tpu.models.config import Config
    from musicstyletransfer_tpu.training import (
        LossConfig, build_optimizer, create_train_state, make_eval_step,
        restore_checkpoint,
    )
    from musicstyletransfer_tpu.training import checkpoint as ckpt

    model_dir = os.path.join(tmp, "vae")
    argv = script_args(
        "train-vae.sh", data=CORPUS, model_output=model_dir,
        out_samples=os.path.join(tmp, "vae-samples"), epochs=1,
        sampling_frequency=0, checkpoint_frequency=1000000,
        logdir=os.path.join(tmp, "tb"))
    log("cli.main " + " ".join(argv))
    t0 = time.perf_counter()
    cli_main.main(argv)
    report_time("canonical_cli_epoch_s", round(time.perf_counter() - t0, 3),
                "s (compile included)")

    idx = ckpt.get_latest_checkpoint_index(model_dir)
    config = Config.load(os.path.join(model_dir, "config"))
    model = make_model(config)
    args = cli_main.get_config(argv)
    tx = build_optimizer(cli_main.create_train_config(args).optimizer)
    template = create_train_state(
        init_params(model, jax.random.key(5), max_seq_len=64), tx,
        jax.random.key(6))
    state = restore_checkpoint(model_dir, idx, template)
    progress = ckpt.TrainingProgress.load(model_dir)
    check(int(state.step) == progress.n_batches > 0,
          f"restored step {int(state.step)} vs {progress.n_batches} batches")
    for leaf in jax.tree.leaves(state.params):
        check(bool(jnp.all(jnp.isfinite(leaf))), "non-finite parameter")
    loader = Loader(CORPUS, max_sequence_length=64)
    batch = next(iter(MelodyDataset(32, 64, loader.melodies, shuffle=False)))
    metrics = make_eval_step(model, LossConfig())(
        state.params, jnp.asarray(batch.tokens), jnp.asarray(batch.seq_lens),
        jnp.asarray(batch.classes), jnp.asarray(batch.labels), 32)
    loss = float(metrics["total_loss"][0]) / float(metrics["total_loss"][1])
    check(np.isfinite(loss), f"eval loss {loss}")
    log(f"canonical: checkpoint {idx} restored at step {int(state.step)}, "
        f"eval total loss {loss:.4f}")


# --------------------------------------------------------------- (c) ----

class _Vocab:
    """num_tokens / num_classes of the bundled corpus (create_model_config
    reads them from a dataset)."""

    def num_tokens(self):
        from musicstyletransfer_tpu.midi.vocab import NUM_EVENTS

        return NUM_EVENTS

    def num_classes(self):
        return 2


def build_preset(script: str, **overrides):
    """(args, model, tx, loss_config) of a training preset script."""
    import jax

    from musicstyletransfer_tpu.cli import main as cli_main
    from musicstyletransfer_tpu.models import make_model
    from musicstyletransfer_tpu.training import LossConfig, build_optimizer

    args = cli_main.get_config(script_args(script, **overrides))
    config = cli_main.create_model_config(args, _Vocab())
    tcfg = cli_main.create_train_config(args)
    loss = LossConfig(kl_weight=tcfg.kl_loss_weight,
                      kl_anneal_steps=tcfg.kl_anneal_steps,
                      free_bits=tcfg.free_bits)
    del jax
    return args, make_model(config), build_optimizer(tcfg.optimizer), loss


def preset_batch(args, batch_size=None):
    import jax.numpy as jnp

    from musicstyletransfer_tpu.data import Loader, MelodyDataset

    L = args.max_seq_len
    loader = Loader(CORPUS, max_sequence_length=L)
    ds = MelodyDataset(batch_size or args.batch_size, L, loader.melodies,
                       shuffle=True, seed=1)
    b = next(iter(ds))
    return tuple(jnp.asarray(x) for x in (b.tokens, b.seq_lens, b.classes,
                                          b.labels))


def compiled_train_step(model, tx, loss_cfg, state, inputs):
    """Lower and compile the trainer's jitted step once; returns
    (compiled, seeded metric accumulator, compile seconds)."""
    from musicstyletransfer_tpu.training import make_train_step
    from musicstyletransfer_tpu.training.train_step import init_metric_acc

    run = make_train_step(model, tx, loss_cfg)
    acc = init_metric_acc()
    t0 = time.perf_counter()
    compiled = run.jitted.lower(state, acc, *inputs).compile()
    return compiled, acc, time.perf_counter() - t0


def train_steps(name, script, n_steps, check_cudnn=False, **overrides):
    import jax
    import numpy as np

    from musicstyletransfer_tpu.models import init_params
    from musicstyletransfer_tpu.training import create_train_state

    args, model, tx, loss_cfg = build_preset(script, **overrides)
    params = init_params(model, jax.random.key(0), args.max_seq_len)
    n_params = sum(x.size for x in jax.tree.leaves(params))
    state = create_train_state(params, tx, jax.random.key(1, impl="rbg"))
    inputs = preset_batch(args)
    log(f"{name}: {n_params:,} params, batch {tuple(inputs[0].shape)}")
    compiled, acc, t_compile = compiled_train_step(model, tx, loss_cfg,
                                                   state, inputs)
    report_time(f"{name}_train_compile_s", round(t_compile, 3), "s")
    log(f"{name} memory_analysis: {compiled.memory_analysis()}")
    if check_cudnn:
        hlo = compiled.as_text()
        check("cudnn$fmha" in hlo,
              f"{name}: no cuDNN fused attention custom call in the HLO")
        log(f"{name}: cuDNN fused attention present "
            f"({hlo.count('cudnn$fmha')} custom calls)")
    times = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        state, acc = compiled(state, acc, *inputs)
        block(acc)
        times.append(time.perf_counter() - t0)
        loss = float(acc["total_loss"][0]) / float(acc["total_loss"][1])
        log(f"{name} step {i + 1}: running total loss {loss:.4f}, "
            f"{times[-1] * 1e3:.2f} ms")
        check(np.isfinite(loss), f"{name}: non-finite loss at step {i + 1}")
    return state, times


def phase_wide_long_training():
    train_steps("wide", "train-vae-wide.sh", 3)
    train_steps("long", "train-vae-long.sh", 2, check_cudnn=True)


# --------------------------------------------------------------- (d) ----

def small_corpus(tmp, per_class=2):
    root = os.path.join(tmp, "corpus-small")
    for cls in ("bass", "guitar"):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for f in sorted(glob.glob(os.path.join(CORPUS, cls, "*.mid")))[
                :per_class]:
            shutil.copy(f, os.path.join(root, cls))
    return root


def all_midi_parse(folder) -> int:
    """Parse every written file back as a Standard MIDI File and tokenize
    its tracks; returns the number of files."""
    from musicstyletransfer_tpu.midi import smf
    from musicstyletransfer_tpu.midi.codec import tokenize_track

    paths = sorted(glob.glob(os.path.join(folder, "*.mid")))
    check(bool(paths), f"no MIDI written under {folder}")
    for p in paths:
        for track in smf.read_midifile(p).tracks:
            tokenize_track(track)
    return len(paths)


def phase_transfer_and_gan(tmp):
    from musicstyletransfer_tpu.cli import gan as cli_gan
    from musicstyletransfer_tpu.cli import sample as cli_sample

    corpus = small_corpus(tmp)
    out = os.path.join(tmp, "transfer")
    cli_sample.main(["--model-output", SHIPPED_VAE, "--data", corpus,
                     "--out-samples", out, "--batch-size", "32",
                     "--max-seq-len", "64", "--checkpoint", "-1"])
    n = all_midi_parse(out)
    log(f"cli.sample: {n} MIDI files written and parsed back")

    gan_dir = os.path.join(tmp, "gan")
    cli_gan.main(["--data", small_corpus(tmp, per_class=1), "--model-output",
                  gan_dir, "--epochs", "1", "--batch-size", "32",
                  "--discriminator-update-steps", "1",
                  "--checkpoint-frequency", "0", "--sampling-frequency",
                  "0", "--logdir", os.path.join(tmp, "gan-tb")])
    gen_out = os.path.join(tmp, "gan-samples")
    cli_gan.main(["--generate", "4", "--model-output", SHIPPED_GAN,
                  "--out-samples", gen_out, "--data", CORPUS])
    n = all_midi_parse(gen_out)
    log(f"cli.gan --generate: {n} MIDI files written and parsed back")


# --------------------------------------------------------------- (e) ----

def corpus_requests(n):
    files = sorted(glob.glob(os.path.join(CORPUS, "*", "*.mid")))
    return [open(files[i % len(files)], "rb").read() for i in range(n)]


def serve(target, requests, timeout_s=300.0):
    import threading

    done, results, errors = threading.Event(), [], []
    lock = threading.Lock()

    def callback(res):
        with lock:
            (errors if isinstance(res, Exception) else results).append(res)
            if len(results) + len(errors) == len(requests):
                done.set()

    target.start()
    try:
        for r in requests:
            target.enqueue(r, callback)
        check(done.wait(timeout_s), "serving timed out")
    finally:
        target.stop()
    check(not errors, f"serving errors: {errors[:1]}")
    return results


def phase_serving():
    from musicstyletransfer_tpu.inference.service import StyleTransferService
    from musicstyletransfer_tpu.inference.streaming import (
        StreamingTransferEngine,
    )

    requests = corpus_requests(8)
    svc = StyleTransferService(SHIPPED_VAE, checkpoint=-1, batch_size=8)
    results = serve(svc, requests)
    check(all(len(r.midi_by_class) == 2 for r in results), "service output")
    log(f"service: {len(results)} requests answered; "
        f"stats {svc.stats.snapshot()}")

    eng = StreamingTransferEngine(SHIPPED_VAE, checkpoint=-1, slots=32)
    results = serve(eng, requests)
    check(all(len(r.midi_by_class) == 2 for r in results), "engine output")
    log(f"streaming: {len(results)} requests answered; "
        f"stats {eng.stats.snapshot()}")
    report_time("streaming_calibrated_harvest_delay_ms",
                round(eng._harvest_delay * 1e3, 6), "ms")


# --------------------------------------------------------------- (f) ----

ATTN_WIDTHS = {
    # name: (B, T, heads, head_dim) of the batched attentions each preset
    # runs (encoder T = L+1, decoder T = L+2).
    "flagship_encoder": (32, 65, 8, 32),
    "flagship_decoder": (32, 66, 8, 16),
    "wide_encoder": (8, 513, 16, 64),
    "wide_decoder": (8, 514, 16, 32),
    "long_encoder": (4, 2047, 8, 64),
    "long_decoder": (4, 2048, 8, 32),
}


def attention_case(B, T, H, D, dtype, causal, seed=0):
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    q, k, v = (jnp.asarray(rng.normal(size=(B, T, H, D)), jnp.float32)
               .astype(dtype) for _ in range(3))
    lens = jnp.asarray(rng.integers(T // 2, T + 1, B), jnp.int32)
    w = jnp.asarray(rng.normal(size=(B, T, H, D)), jnp.float32)
    del jax
    return q, k, v, lens, w


def phase_attention_numerics():
    import jax
    import jax.numpy as jnp

    from musicstyletransfer_tpu.ops.attention import (
        attention, choose_implementation, cudnn_min_seq_len,
        reference_attention,
    )

    log(f"tolerances: f32 (highest) rel {TOL_F32}, bf16 rel {TOL_BF16}")
    for name, (B, T, H, D) in ATTN_WIDTHS.items():
        causal = name.endswith("decoder")
        for dtype, tol in ((jnp.float32, TOL_F32), (jnp.bfloat16, TOL_BF16)):
            q, k, v, lens, w = attention_case(B, T, H, D, dtype, causal)
            impl = choose_implementation(q)

            def loss(fn, q, k, v):
                out = fn(q, k, v, lens, causal)
                return jnp.sum(out.astype(jnp.float32) * w), out

            with jax.default_matmul_precision("highest"):
                (_, out), g = jax.jit(jax.value_and_grad(
                    lambda q, k, v: loss(attention, q, k, v),
                    argnums=(0, 1, 2), has_aux=True))(q, k, v)
                (_, ref), g_ref = jax.jit(jax.value_and_grad(
                    lambda q, k, v: loss(reference_attention, q, k, v),
                    argnums=(0, 1, 2), has_aux=True))(
                        *(x.astype(jnp.float32) for x in (q, k, v)))
            errs = [rel_err(out, ref)] + [rel_err(a, b)
                                          for a, b in zip(g, g_ref)]
            log(f"attention {name} {jnp.dtype(dtype).name} [{impl}]: "
                f"rel err fwd {errs[0]:.2e} dq {errs[1]:.2e} "
                f"dk {errs[2]:.2e} dv {errs[3]:.2e} (tol {tol})")
            check(max(errs) < tol, f"attention {name} {dtype} out of tol")
            if dtype == jnp.bfloat16:
                want = "cudnn" if T >= cudnn_min_seq_len(D) else "xla"
                check(impl == want, f"{name}: bf16 picked {impl}, not {want}")


def phase_golden_numerics():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from musicstyletransfer_tpu.inference.sampler import load_inference_model
    from musicstyletransfer_tpu.models import make_generator, make_model
    from musicstyletransfer_tpu.models.config import Config
    from musicstyletransfer_tpu.models.gan import init_gan_params
    from musicstyletransfer_tpu.training import (
        get_latest_checkpoint_index, restore_params,
    )

    def bf16_bound(got, recorded, truth, what):
        err = np.abs(np.asarray(got, np.float32) - truth)
        ref = np.abs(recorded - truth)
        log(f"golden {what} bf16: max err {err.max():.3e} (recorded bf16 "
            f"{ref.max():.3e}), mean {err.mean():.3e} ({ref.mean():.3e})")
        check(err.max() <= BF16_GOLDEN_SLACK * ref.max()
              and err.mean() <= BF16_GOLDEN_SLACK * ref.mean(),
              f"golden {what} bf16 out of bound")

    g = dict(np.load(os.path.join(GOLDENS, "vae_guitar_bass.npz")))
    model, params = load_inference_model(SHIPPED_VAE, checkpoint=-1)
    inputs = tuple(jnp.asarray(g[k]) for k in ("tokens", "seq_lens",
                                               "classes"))
    m32 = make_model(model.config.copy(dtype="float32"))
    with jax.default_matmul_precision("highest"):
        logits, mu, _ = jax.jit(lambda p, *a: m32(p, *a))(params, *inputs)
    e = rel_err(logits, g["logits_f32"])
    log(f"golden vae f32 highest: rel err logits {e:.2e} (tol {TOL_F32})")
    check(e < TOL_F32, "golden vae f32 out of tol")
    logits, mu, _ = jax.jit(lambda p, *a: model(p, *a))(params, *inputs)
    bf16_bound(logits, g["logits_bf16"], g["logits_f32"], "vae logits")

    g = dict(np.load(os.path.join(GOLDENS, "gan_guitar_bass.npz")))
    config = Config.load(os.path.join(SHIPPED_GAN, "config"))
    gen_folder = os.path.join(SHIPPED_GAN, "generator")
    template, _ = init_gan_params(config, jax.random.key(0))
    gp = jax.device_put(restore_params(
        gen_folder, get_latest_checkpoint_index(gen_folder), template))
    args = (jnp.asarray(g["noise"]), jnp.asarray(g["classes"]),
            jax.random.wrap_key_data(jnp.asarray(g["roll_key"])))
    gen32 = make_generator(config.copy(dtype="float32"))
    with jax.default_matmul_precision("highest"):
        logits, _ = jax.jit(gen32)(gp, *args)
    e = rel_err(logits, g["gen_logits_f32"])
    log(f"golden gan f32 highest: rel err logits {e:.2e} (tol {TOL_F32})")
    check(e < TOL_F32, "golden gan f32 out of tol")
    logits, _ = jax.jit(make_generator(config))(gp, *args)
    bf16_bound(logits, g["gen_logits_bf16"], g["gen_logits_f32"],
               "gan logits")


# --------------------------------------------------------------- (g) ----

def time_fn(fn, *args, n=10):
    """(compile+first call s, mean steady-state s) with block_until_ready."""
    t0 = time.perf_counter()
    block(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    block(out)
    return first, (time.perf_counter() - t0) / n


def phase_baseline_times():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from musicstyletransfer_tpu.data import Loader, MelodyDataset
    from musicstyletransfer_tpu.inference.decode import (
        sample_sequences, style_transfer_all_classes,
    )
    from musicstyletransfer_tpu.inference.sampler import load_inference_model
    from musicstyletransfer_tpu.midi.vocab import PAD_ID
    from musicstyletransfer_tpu.ops.attention import attention

    model, params = load_inference_model(SHIPPED_VAE, checkpoint=-1)
    loader = Loader(CORPUS, max_sequence_length=64)
    ds = MelodyDataset(128, 64, loader.melodies, shuffle=True, seed=0)
    b = next(iter(ds))
    max_len = 130

    def decode_stats(seqs, seconds):
        seqs = np.asarray(seqs).reshape(-1, max_len)
        live = seqs != PAD_ID
        steps = int(np.max(np.nonzero(live.any(0))[0]))  # loop iterations
        events = int(live[:, 1:].sum())
        return seconds / max(steps, 1) * 1e3, events / seconds, steps

    toks, lens, cls = (jnp.asarray(x[:32]) for x in (b.tokens, b.seq_lens,
                                                     b.classes))
    fn = jax.jit(lambda p, k: sample_sequences(model, p, toks, lens, cls,
                                               max_len, k))
    key = jax.random.key(0)
    first, mean = time_fn(fn, params, key)
    ms_step, ev_s, steps = decode_stats(fn(params, key)[0], mean)
    report_time("decode_B32_compile_first_call_s", round(first, 3), "s")
    report_time("decode_B32_ms_per_step", round(ms_step, 4),
                f"ms ({steps} steps, call {mean * 1e3:.2f} ms)")
    report_time("decode_B32_events_per_s", round(ev_s, 1), "events/s")

    toks, lens = jnp.asarray(b.tokens), jnp.asarray(b.seq_lens)
    fn = jax.jit(lambda p, k: style_transfer_all_classes(
        model, p, toks, lens, max_len, 2, k))
    first, mean = time_fn(fn, params, key, n=5)
    ms_step, ev_s, steps = decode_stats(fn(params, key)[0], mean)
    report_time("service_batch256_compile_first_call_s", round(first, 3), "s")
    report_time("service_batch256_ms_per_step", round(ms_step, 4),
                f"ms ({steps} steps, call {mean * 1e3:.2f} ms)")
    report_time("service_batch256_events_per_s", round(ev_s, 1), "events/s")

    for name, script, n in (("canonical", "train-vae.sh", 10),
                            ("wide", "train-vae-wide.sh", 5),
                            ("long", "train-vae-long.sh", 3)):
        _, times = train_steps(name + "_timed", script, n + 1)
        report_time(f"{name}_train_ms_per_step",
                    round(float(np.mean(times[1:])) * 1e3, 3),
                    f"ms (mean of {n} steps after the first)")

    for T, B, H in ((66, 32, 8), (2048, 4, 8), (8192, 1, 8)):
        D = 64 if T > 66 else 16
        q, k, v, lens, w = attention_case(B, T, H, D, jnp.bfloat16, True)
        for impl in ("cudnn", "xla"):
            def loss(q, k, v, impl=impl):
                out = attention(q, k, v, lens, True, implementation=impl)
                return jnp.sum(out.astype(jnp.float32) * w)

            fb = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
            try:
                first, mean = time_fn(fb, q, k, v, n=10)
            except Exception as exc:  # XLA's [T, T] scores may not fit
                if impl == "cudnn":
                    raise
                log(f"attention T={T} xla: did not run ({type(exc).__name__})")
                continue
            report_time(f"attention_fwd_bwd_T{T}_B{B}_H{H}_D{D}_{impl}_ms",
                        round(mean * 1e3, 4),
                        f"ms (compile+first {first:.2f} s)")


# ------------------------------------------------------ --four-cards ----

def four_cards(devices):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from musicstyletransfer_tpu.data import Loader, MelodyDataset
    from musicstyletransfer_tpu.inference.decode import sample_sequences
    from musicstyletransfer_tpu.inference.sampler import load_inference_model
    from musicstyletransfer_tpu.inference.sharded import (
        sharded_sample_sequences,
    )
    from musicstyletransfer_tpu.models import init_params, make_model
    from musicstyletransfer_tpu.ops.attention import reference_attention
    from musicstyletransfer_tpu.ops.ring_attention import (
        ring_attention_sharded,
    )
    from musicstyletransfer_tpu.parallel import make_mesh
    from musicstyletransfer_tpu.parallel.mesh import batch_sharding, use_mesh
    from musicstyletransfer_tpu.training import (
        create_train_state, make_train_step, shard_train_state,
    )

    check(len(devices) == 4, f"--four-cards needs 4 GPUs, got {len(devices)}")

    def wide_step_vs_one_card(dtype, tol):
        """One wide-preset training step (dropout off) on one card and on
        the (data=2, model=2) mesh; returns the mesh step's compiled HLO."""
        args, model, tx, loss_cfg = build_preset(
            "train-vae-wide.sh", e_dropout=0.0, d_dropout=0.0, dtype=dtype)
        params = init_params(model, jax.random.key(0), args.max_seq_len)
        inputs = preset_batch(args)

        def one_step(mesh):
            state = create_train_state(params, tx, jax.random.key(1))
            if mesh is not None:
                state = shard_train_state(state, mesh)
            step = make_train_step(model, tx, loss_cfg, mesh=mesh,
                                   per_param_grad_norms=True)
            with jax.default_device(devices[0]):
                state, acc = step(state, None, *inputs)
            hlo = None
            if mesh is not None:  # the program the step just ran
                with use_mesh(mesh):
                    hlo = step.jitted.lower(
                        state, acc, *(jax.device_put(x, batch_sharding(mesh))
                                      for x in inputs)).compile().as_text()
            return jax.tree.map(np.asarray, acc), hlo

        one, _ = one_step(None)
        four, hlo = one_step(make_mesh(devices, tp=2))
        loss1 = one["total_loss"][0] / one["total_loss"][1]
        loss4 = four["total_loss"][0] / four["total_loss"][1]
        # Per-parameter gradient norms, each error relative to the larger
        # of its own norm and 1e-3 of the global norm (some gradients are
        # analytically zero, e.g. the key bias under softmax).
        floor = 1e-3 * float(one["grad_norm"][0])
        names = [k for k in one if k.startswith("grad_norm")]
        gnorm_err, worst = max(
            (abs(float(four[k][0]) - float(one[k][0]))
             / max(abs(float(one[k][0])), floor), k) for k in names)
        loss_err = abs(loss4 - loss1) / abs(loss1)
        log(f"wide step ({dtype}) loss 1 card {loss1:.6f} vs 4 cards "
            f"{loss4:.6f} (rel {loss_err:.2e}); max rel err over "
            f"{len(names)} gradient norms {gnorm_err:.2e} at {worst} "
            f"(tol {tol})")
        check(loss_err < tol, f"wide {dtype} loss differs")
        check(gnorm_err < tol, f"wide {dtype} gradients differ")
        return hlo

    with timed("4-card (data=2, model=2) wide training step vs 1 card"):
        # float32 at "highest" precision: the two layouts may then differ
        # only by reduction order (attention runs XLA's lowering in f32).
        with jax.default_matmul_precision("highest"):
            wide_step_vs_one_card("float32", TOL_F32)
        # The preset's own bf16 step: cuDNN fused attention on batch- and
        # head-sharded q/k/v under GSPMD, which the f32 step never reaches.
        hlo = wide_step_vs_one_card("bfloat16", TOL_BF16_STEP)
        check("cudnn$fmha" in hlo,
              "wide bf16 mesh step: no cuDNN fused attention in the HLO")
        log(f"wide bf16 mesh step: {hlo.count('cudnn$fmha')} cuDNN fused "
            "attention custom calls in the compiled HLO")

    with timed("data=4 sharded greedy style transfer vs 1 card"):
        # float32 at "highest" precision, so the two layouts differ only
        # by reduction order and an argmax tie is the only way to diverge.
        vae, vparams = load_inference_model(SHIPPED_VAE, checkpoint=-1)
        vae = make_model(vae.config.copy(dtype="float32"))
        loader = Loader(CORPUS, max_sequence_length=64)
        b = next(iter(MelodyDataset(32, 64, loader.melodies, shuffle=True,
                                    seed=2)))
        toks, lens, cls = (jnp.asarray(x) for x in (b.tokens, b.seq_lens,
                                                    1 - b.classes))
        with jax.default_matmul_precision("highest"):
            ref, _ = sample_sequences(vae, vparams, toks, lens, cls, 130,
                                      jax.random.key(0), greedy=True)
            out, _ = sharded_sample_sequences(
                vae, vparams, toks, lens, cls, 130, jax.random.key(0),
                make_mesh(devices, tp=1), greedy=True)
        same = np.asarray(ref) == np.asarray(out)
        log(f"greedy transfer: {same.all(axis=1).sum()}/{same.shape[0]} "
            "rows token-identical")
        check(bool(same.all()), "sharded greedy transfer differs")

    with timed("ring attention on model=4 at L=2046 vs plain attention"):
        B, H, D = 4, 8, 64
        mesh = make_mesh(devices, tp=4)
        for T, causal in ((2047, False), (2048, True)):
            q, k, v, lens, w = attention_case(B, T, H, D, jnp.float32,
                                              causal, seed=3)
            t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731

            def ring_loss(q, k, v):
                out = t(ring_attention_sharded(t(q), t(k), t(v), lens,
                                               causal=causal, mesh=mesh))
                return jnp.sum(out * w), out

            def ref_loss(q, k, v):
                out = reference_attention(q, k, v, lens, causal)
                return jnp.sum(out * w), out

            with jax.default_matmul_precision("highest"):
                (_, out), g = jax.jit(jax.value_and_grad(
                    ring_loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
                (_, ref), g_ref = jax.jit(jax.value_and_grad(
                    ref_loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
            errs = [rel_err(out, ref)] + [rel_err(a, b)
                                          for a, b in zip(g, g_ref)]
            log(f"ring T={T} causal={causal}: rel err fwd {errs[0]:.2e} "
                f"dq {errs[1]:.2e} dk {errs[2]:.2e} dv {errs[3]:.2e} "
                f"(tol {TOL_F32})")
            check(max(errs) < TOL_F32, "ring attention out of tolerance")


# ------------------------------------------------------------------------

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the cross-device paths on 4 GPUs")
    opts = parser.parse_args()
    sys.path.insert(0, REPO)

    with timed("(a) device gate"):
        devices = phase_device_gate()
    if opts.four_cards:
        four_cards(devices)
    else:
        scratch = os.path.join(REPO, ".chip_smoke_tmp")
        os.makedirs(scratch, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="run-", dir=scratch)
        try:
            with timed("(b) canonical training via cli.main"):
                phase_canonical_training(tmp)
            with timed("(c) wide and long training"):
                phase_wide_long_training()
            with timed("(d) style transfer and GAN"):
                phase_transfer_and_gan(tmp)
            with timed("(e) serving"):
                phase_serving()
            with timed("(f) numerics"):
                phase_attention_numerics()
                phase_golden_numerics()
            with timed("(g) baseline times"):
                phase_baseline_times()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    from musicstyletransfer_tpu.hardware import device_summary

    log(CARD)
    print(json.dumps({"ok": True, "device": device_summary()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
