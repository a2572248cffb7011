"""GAN training entry point: ``python -m musicstyletransfer_tpu.cli.gan``.

The reference's scripts/train.sh:5 invokes ``music_style_transfer.GAN.main``
— a module absent from the reference repository. This CLI reconstructs that
entry point from the launch script's surviving flag surface (train.sh:6-21);
see models/gan.py for the design rationale. Flag names, defaults and the
``parse_known_args`` behavior follow the reference CLI conventions
(VarAutoEncoder/config.py:73-75); ``--d-*`` here means *discriminator* (as
in train.sh), not the VAE decoder.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import jax

from ..data import Loader, ToyData, load_dataset
from ..models.gan import (
    DiscriminatorConfig,
    GANConfig,
    GeneratorConfig,
    init_gan_params,
)
from ..training.gan_trainer import GANTrainConfig, GANTrainer


def build_gan_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()

    net = parser.add_argument_group("Network")
    net.add_argument("--g-n-layers", type=int, default=1)
    net.add_argument("--g-rnn-hidden-dim", type=int, default=256)
    net.add_argument("--g-emb-hidden-dim", type=int, default=256)
    net.add_argument("--noise-dim", type=int, default=64)
    net.add_argument("--d-n-layers", type=int, default=1)
    net.add_argument("--d-rnn-hidden-dim", type=int, default=256)
    net.add_argument("--d-emb-hidden-dim", type=int, default=256)

    data = parser.add_argument_group("Data")
    data.add_argument("--batch-size", type=int, default=32)
    data.add_argument("--max-seq-len", type=int, default=64)
    data.add_argument("--slices-per-quarter-note", type=float, default=4)
    data.add_argument("--data", type=str, default="data")
    data.add_argument("--validation-split", type=float, default=0.0)

    train = parser.add_argument_group("Training")
    train.add_argument("--epochs", type=int, default=10000)
    train.add_argument("--discriminator-update-steps", type=int, default=5)
    train.add_argument("--g-learning-rate", type=float, default=5e-5)
    train.add_argument("--d-learning-rate", type=float, default=5e-5)
    train.add_argument("--label-smoothing", type=float, default=0.0)
    train.add_argument("--negative-label-downscaling", action="store_true")
    train.add_argument("--r1-gamma", type=float, default=0.1,
                       help="R1 gradient-penalty weight on real inputs. "
                            "Default 0.1 — the measured sweet spot "
                            "(sweep: dense output AND the "
                            "sharpest class separation at 14k steps; the "
                            "unregularized run collapses there). "
                            "--parity-gan or 0 turns it off.")
    train.add_argument("--parity-gan", action="store_true",
                       help="restore the bare reconstructed train.sh "
                            "surface (R1 penalty off). The reference's own "
                            "GAN module is absent from its repo, so this "
                            "only pins the reconstructed surface, not "
                            "measured behavior — the default diverges "
                            "deliberately because unregularized training "
                            "self-destructs).")

    misc = parser.add_argument_group("Misc")
    misc.add_argument("--checkpoint-frequency", type=int, default=5000)
    misc.add_argument("--sampling-frequency", type=int, default=1000)
    misc.add_argument("--out-samples", "-o", type=str, default=None)
    misc.add_argument("--model-output", "-m", type=str, default="models/gan")
    misc.add_argument("--gpu", action="store_true")  # ignored; JAX picks devices
    misc.add_argument("--toy", action="store_true")
    misc.add_argument("--verbose", action="store_true")
    misc.add_argument("--generate", type=int, default=0, metavar="N",
                      help="no training: load a checkpoint from "
                           "--model-output and write N samples per class "
                           "to --out-samples")
    misc.add_argument("--checkpoint", "-c", type=int, default=-1,
                      help="checkpoint index for --generate (-1 = latest)")

    ext = parser.add_argument_group("Extensions")
    ext.add_argument("--dtype", choices=["bfloat16", "float32"],
                     default="bfloat16")
    ext.add_argument("--seed", type=int, default=0)
    ext.add_argument("--cpu", action="store_true",
                     help="force CPU devices (tests/dev)")
    ext.add_argument("--temperature", type=float, default=1.0)
    ext.add_argument("--num-samples", type=int, default=8,
                     help="generated MIDIs per class at each sampling tick")
    ext.add_argument("--logdir", type=str, default=None,
                     help="TensorBoard logdir for GAN scalars")
    return parser


def get_gan_config(argv=None) -> argparse.Namespace:
    config, _unparsed = build_gan_parser().parse_known_args(argv)
    return config


def create_gan_config(args, num_classes: int, num_tokens: int,
                      max_seq_len: int) -> GANConfig:
    return GANConfig(
        generator_config=GeneratorConfig(
            n_layers=args.g_n_layers,
            hidden_dim=args.g_rnn_hidden_dim,
            emb_dim=args.g_emb_hidden_dim,
            noise_dim=args.noise_dim,
            num_classes=num_classes,
            output_dim=num_tokens,
            max_seq_len=max_seq_len,
        ),
        discriminator_config=DiscriminatorConfig(
            n_layers=args.d_n_layers,
            hidden_dim=args.d_rnn_hidden_dim,
            emb_dim=args.d_emb_hidden_dim,
            num_classes=num_classes,
            input_dim=num_tokens,
        ),
        dtype=args.dtype,
    )


def create_gan_train_config(args) -> GANTrainConfig:
    return GANTrainConfig(
        discriminator_update_steps=args.discriminator_update_steps,
        g_learning_rate=args.g_learning_rate,
        d_learning_rate=args.d_learning_rate,
        label_smoothing=args.label_smoothing,
        negative_label_downweighting=args.negative_label_downscaling,
        r1_gamma=0.0 if getattr(args, "parity_gan", False) else args.r1_gamma,
        checkpoint_frequency=args.checkpoint_frequency,
        sampling_frequency=args.sampling_frequency,
        num_samples=args.num_samples,
        temperature=args.temperature,
        logdir=args.logdir,
        seed=args.seed,
    )


def main_toy(args, epochs: int = 200) -> None:
    dataset = ToyData()
    model_folder = "/tmp/music-style-transfer/toy/gan"
    config = create_gan_config(
        args, dataset.num_classes(), dataset.num_tokens(), max_seq_len=4
    )
    trainer = GANTrainer(config, create_gan_train_config(args),
                         out_samples=args.out_samples)
    trainer.fit(dataset, model_folder, epochs=epochs)


def generate_only(args) -> None:
    """Load the latest GAN checkpoint and write samples, no training."""
    from ..training import get_latest_checkpoint_index, restore_params
    from ..models.gan import init_gan_params

    config = GANConfig.load(os.path.join(args.model_output, "config"))
    gen_folder = os.path.join(args.model_output, "generator")
    idx = (args.checkpoint if args.checkpoint >= 0
           else get_latest_checkpoint_index(gen_folder))
    if idx < 0:
        raise SystemExit(f"no generator checkpoint under {gen_folder}")
    template, _ = init_gan_params(config, jax.random.key(0))
    g_params = jax.device_put(restore_params(gen_folder, idx, template))

    tc = dataclasses.replace(create_gan_train_config(args),
                             num_samples=args.generate)
    trainer = GANTrainer(config, tc)
    out = args.out_samples or "gan-samples"
    paths = trainer.sample_to_midi(g_params, out)
    print(f"wrote {len(paths)} samples from checkpoint {idx} to {out}")

    if args.data and os.path.isdir(args.data):
        # Class-conditional quality vs the corpus: one JSON line
        # (inference/quality.py — conditioning works iff own-class JS
        # is below other-class JS).
        import json

        from ..inference.quality import class_conditional_stats

        melodies = Loader(
            path=args.data,
            max_sequence_length=args.max_seq_len,
            slices_per_quarter_note=args.slices_per_quarter_note,
        ).read_melodies()
        corpus = {
            idx: [m.tokens for m in melodies[name]]
            for idx, name in enumerate(sorted(melodies))
        }
        gen_rows = trainer.generate_class_rows(g_params)
        print(json.dumps(class_conditional_stats(gen_rows, corpus)))


def main(argv=None) -> None:
    args = get_gan_config(argv)

    from ..utils import configure_jax_cache

    configure_jax_cache()
    if args.cpu:
        from ..utils import pin_local_cpu

        pin_local_cpu()

    if args.toy:
        main_toy(args)
        return

    if args.generate > 0:
        generate_only(args)
        return

    loader = Loader(
        path=args.data,
        max_sequence_length=args.max_seq_len,
        slices_per_quarter_note=args.slices_per_quarter_note,
    )
    train_dataset, _ = load_dataset(
        loader, args.batch_size, args.validation_split, None
    )

    os.makedirs(args.model_output, exist_ok=True)
    if args.out_samples:
        os.makedirs(args.out_samples, exist_ok=True)

    config = create_gan_config(
        args, train_dataset.num_classes(), train_dataset.num_tokens(),
        args.max_seq_len,
    )
    print("Using GAN configuration:")
    print(config.to_json())

    trainer = GANTrainer(config, create_gan_train_config(args),
                         out_samples=args.out_samples)
    # eval_shape: count parameters without tracing/executing a real init
    # (fit() performs the actual init; doing it twice would add a full
    # rollout trace before training starts).
    shapes = jax.eval_shape(
        lambda: init_gan_params(config, jax.random.key(0))
    )
    n_params = sum(x.size for x in jax.tree.leaves(shapes))
    print(f"GAN parameters: {n_params:,}")
    trainer.fit(train_dataset, args.model_output, epochs=args.epochs)
    print("GAN training finished.")


if __name__ == "__main__":
    main()
