"""Beam-vs-sampling QUALITY evaluation on a shipped checkpoint.

beam search is fast (bench beam4_batch32_ms) and
replay-verified, but nothing showed when it *helps*. This script compares
the three decode policies on the same sources, same window:

- ``sampled``: the shipped ancestral path (style-transfer default);
- ``beam1``: K=1 beam == greedy argmax;
- ``beam4``: K=4 (the reference CLI's --beam-size family,
  sampler.py:192-257 — the feature the reference shipped broken);
- ``beam4_lp0.6``: K=4 with GNMT length normalization (alpha 0.6).

Per policy and target class, transfers ``n_batches`` batches and reports:

- ``nll_per_token``: mean per-token NLL of the EMITTED sequences under
  the model (decode.py's score output — cumulative -log p over emitted
  tokens incl. EOS — divided by emitted length). Beam optimizes exactly
  this, so it must win here or it is buggy; the interesting question is
  what that buys on the distribution axes below.
- transfer stats: termination rate, mean length, octave-JS register fit
  (to target vs other classes), pitch-class content preservation vs the
  rotated-row shuffled null (inference/quality.py semantics).

Usage:
    python scripts/beam-eval.py [model_folder] [data_dir] [n_batches] \
        [max_seq_len] [batch_size] [policies]
Defaults: models/guitar_bass ./work/data/guitar_bass 2 64 32 all (B=32
each, so 128 transfers per policy at 2 classes). One JSON line per
policy. ``policies`` is a comma list from
{sampled,beam1,beam4,beam4_lp0.6} — e.g. ``sampled,beam1`` for a
content-preservation A/B at long L where K=4 beam is memory-heavy.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from musicstyletransfer_tpu.utils import (
        configure_jax_cache,
    )

    configure_jax_cache()

    from musicstyletransfer_tpu.data import Loader, MelodyDataset
    from musicstyletransfer_tpu.inference.decode import (
        beam_search,
        sample_sequences,
    )
    from musicstyletransfer_tpu.inference.quality import (
        js_divergence,
        octave_histogram,
        pitch_class_histogram,
    )
    from musicstyletransfer_tpu.inference.sampler import load_inference_model
    from musicstyletransfer_tpu.midi.vocab import EOS_ID, PAD_ID

    folder = sys.argv[1] if len(sys.argv) > 1 else "models/guitar_bass"
    data = sys.argv[2] if len(sys.argv) > 2 else "./work/data/guitar_bass"
    n_batches = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    L = int(sys.argv[4]) if len(sys.argv) > 4 else 64
    B = int(sys.argv[5]) if len(sys.argv) > 5 else 32
    wanted = (sys.argv[6].split(",") if len(sys.argv) > 6 else None)

    model, params = load_inference_model(folder, -1, max_seq_len=L)
    loader = Loader(data, L)
    # Shuffled + seeded: the content-preservation null rotates sources
    # within a batch; corpus-order batches are consecutive chunks of one
    # file, which deflates the null (same rationale as cli.evaluate).
    ds = MelodyDataset(B, L, loader.melodies, shuffle=True, seed=0)
    C = ds.num_classes()
    max_len = 2 * (L + 1)

    # Corpus profiles (full pass) + the eval batches (first n_batches).
    class_rows = [[] for _ in range(C)]
    batches = []
    for bi, b in enumerate(ds):
        nv = int(b.num_valid)
        toks = np.asarray(b.tokens)
        for row, cls in zip(toks[:nv], np.asarray(b.classes)[:nv]):
            class_rows[int(cls)].append(row)
        if bi < n_batches:
            batches.append((jnp.asarray(b.tokens), jnp.asarray(b.seq_lens),
                            nv, toks))
    corpus_pitch = [pitch_class_histogram(r) for r in class_rows]
    corpus_oct = [octave_histogram(r) for r in class_rows]

    policies = [
        ("sampled", dict(kind="sample")),
        ("beam1", dict(kind="beam", k=1, lp=0.0)),
        ("beam4", dict(kind="beam", k=4, lp=0.0)),
        ("beam4_lp0.6", dict(kind="beam", k=4, lp=0.6)),
    ]
    if wanted is not None:
        policies = [p for p in policies if p[0] in wanted]

    rng = jax.random.key(0)
    for name, spec in policies:
        rows = [[] for _ in range(C)]  # emitted token rows per target class
        nll_tok, lengths, term = [], [], []
        own_js, shuf_js = [], []
        t_decode = 0.0
        for tokens, seq_lens, nv, toks_np in batches:
            for c in range(C):
                classes = jnp.full((tokens.shape[0],), c, jnp.int32)
                t0 = time.perf_counter()
                if spec["kind"] == "sample":
                    rng, key = jax.random.split(rng)
                    seqs, scores = sample_sequences(
                        model, params, tokens, seq_lens, classes, max_len,
                        key)
                else:
                    seqs, scores = beam_search(
                        model, params, tokens, seq_lens, classes, max_len,
                        beam_size=spec["k"], length_penalty=spec["lp"])
                seqs = np.asarray(seqs)
                scores = np.asarray(scores)
                t_decode += time.perf_counter() - t0
                for i in range(nv):
                    row = seqs[i]
                    gen_len = int(np.sum(row != PAD_ID)) - 1  # minus SOS
                    lengths.append(gen_len)
                    term.append(bool(np.any(row == EOS_ID)))
                    if gen_len > 0 and spec.get("lp", 0.0) == 0.0:
                        nll_tok.append(float(scores[i]) / gen_len)
                    elif gen_len > 0:
                        # lp > 0 returns the length-NORMALIZED score of
                        # the selected hypothesis: score / len^alpha.
                        nll_tok.append(
                            float(scores[i]) * gen_len ** spec["lp"]
                            / gen_len)
                    rows[c].append(row)
                    h = pitch_class_histogram([row])
                    own_js.append(js_divergence(
                        h, pitch_class_histogram([toks_np[i]])))
                    shuf_js.append(js_divergence(
                        h, pitch_class_histogram([toks_np[(i + 1) % nv]])))
        oct_target, oct_other = [], []
        for c in range(C):
            ho = octave_histogram(rows[c])
            oct_target.append(js_divergence(ho, corpus_oct[c]))
            others = [js_divergence(ho, corpus_oct[o])
                      for o in range(C) if o != c]
            if others:
                oct_other.append(float(np.mean(others)))
        out = {
            "policy": name,
            "sequences": len(lengths),
            "nll_per_token": round(float(np.mean(nll_tok)), 4),
            "termination_rate": round(float(np.mean(term)), 4),
            "mean_generated_len": round(float(np.mean(lengths)), 1),
            "octave_js_to_target": round(float(np.mean(oct_target)), 4),
            "octave_js_to_other": round(float(np.mean(oct_other)), 4),
            "pitch_js_to_own_source": round(float(np.mean(own_js)), 4),
            "pitch_js_to_shuffled_source": round(float(np.mean(shuf_js)), 4),
            "decode_wall_s": round(t_decode, 2),
        }
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
