"""Offline evaluation CLI: metrics for a trained checkpoint over a corpus.

    python -m musicstyletransfer_tpu.cli.evaluate \
        --model-output models/run1 --checkpoint -1 \
        --data /path/to/corpus [--batch-size 32] [--max-seq-len 64] [--cpu]

Prints ONE JSON line with PAD-ignoring perplexity/accuracy/top-5, masked CE,
KL, and total loss — the same metric set the trainer's validation pass uses
(wrap-padded rows masked out, so the numbers are batch-size invariant).
The reference has no evaluation tooling at all (SURVEY.md §4).
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-output", "-m", required=True)
    p.add_argument("--checkpoint", "-c", type=int, default=-1)
    p.add_argument("--data", required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-seq-len", type=int, default=64)
    p.add_argument("--kl-loss", type=float, default=1.0)
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="match the training run's value so losses are "
                        "comparable with its validation logs")
    p.add_argument("--normalize", choices=["valid", "length"],
                   default="valid", help="per-sample CE normalization "
                                         "(match the training run)")
    p.add_argument("--cpu", action="store_true",
                   help="pin compute to a local CPU device")
    p.add_argument("--transfer-stats", action="store_true",
                   help="also run all-classes style transfer on a few "
                        "batches and report output-quality statistics "
                        "(EOS termination rate, lengths, pitch-class JS "
                        "divergence to target vs source distribution)")
    p.add_argument("--stats-batches", type=int, default=4)
    return p


def evaluate(model, params, dataset, kl_weight: float = 1.0,
             label_smoothing: float = 0.0, normalize: str = "valid") -> dict:
    """Aggregate eval metrics over a Dataset (library entry point).

    Pass the TRAINING run's loss settings for numbers comparable with its
    validation logs."""
    from ..training.metrics import MetricAccumulator
    from ..training.train_step import LossConfig, make_eval_step

    eval_step = make_eval_step(
        model,
        LossConfig(kl_weight=kl_weight, label_smoothing=label_smoothing,
                   normalize=normalize),
    )
    acc = MetricAccumulator()
    for batch in dataset:
        metrics = eval_step(
            params,
            jnp.asarray(batch.tokens),
            jnp.asarray(batch.seq_lens),
            jnp.asarray(batch.classes),
            jnp.asarray(batch.labels),
            jnp.asarray(batch.num_valid, jnp.int32),
        )
        acc.update(jax.device_get(metrics))
    return acc.get()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..utils import (
        configure_jax_cache, pin_local_cpu,
    )

    configure_jax_cache()
    if args.cpu:
        pin_local_cpu()

    from ..data import Loader, MelodyDataset
    from ..inference.sampler import load_inference_model

    model, params = load_inference_model(
        args.model_output, args.checkpoint, max_seq_len=args.max_seq_len
    )
    loader = Loader(args.data, args.max_seq_len)
    dataset = MelodyDataset(
        args.batch_size, args.max_seq_len, loader.melodies, shuffle=False
    )
    vals = evaluate(model, params, dataset, kl_weight=args.kl_loss,
                    label_smoothing=args.label_smoothing,
                    normalize=args.normalize)
    if args.transfer_stats:
        from ..inference.quality import transfer_stats

        # Seeded-shuffled dataset for the stats pass: transfer_stats'
        # content-preservation NULL rotates sources within a batch, and
        # unshuffled batches are consecutive chunks of the same file,
        # which deflates the null (neighbor chunks share content). The
        # metric pass above stays in corpus order (order-invariant).
        stats_dataset = MelodyDataset(
            args.batch_size, args.max_seq_len, loader.melodies,
            shuffle=True, seed=0,
        )
        vals.update(transfer_stats(model, params, stats_dataset,
                                   dataset.num_classes(),
                                   max_batches=args.stats_batches))
    print(json.dumps({k: round(v, 6) for k, v in sorted(vals.items())}))


if __name__ == "__main__":
    main()
