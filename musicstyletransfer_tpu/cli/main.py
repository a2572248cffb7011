"""Training entry point: ``python -m musicstyletransfer_tpu.cli.main``.

Reference: VarAutoEncoder/main.py:1-176. The reference's non-toy path is
broken at head (it passes ``lstm_config=`` to DecoderConfig — SURVEY.md
§8.7); this build uses the transformer decoder for both paths, matching the
toy path's evident intent, with ``--decoder-type lstm`` selecting the
legacy variant.
"""

from __future__ import annotations

import os

import jax

from ..data import Loader, ToyData, load_dataset
from ..models import (
    DecoderConfig,
    EncoderConfig,
    LSTMConfig,
    ModelConfig,
    TransformerConfig,
    init_params,
    make_model,
)
from ..parallel import make_mesh
from ..training import OptimizerConfig, TrainConfig, Trainer
from .flags import get_config


def create_model_config(args, dataset) -> ModelConfig:
    """Reference: main.py:96-118 (create_model_config), fixed per §8.7."""
    return ModelConfig(
        encoder_config=EncoderConfig(
            transformer_config=TransformerConfig(
                model_size=args.e_rnn_hidden_dim,
                dropout=args.e_dropout,
                num_layers=args.e_n_layers,
                vocab_size=dataset.num_tokens(),
                num_heads=args.e_num_heads,
                norm_scheme=args.norm_scheme,
                remat=args.remat,
                ring_attention=args.ring_attention,
                sequence_sharding=args.ring_attention,
            ),
            latent_dim=args.latent_dim,
            num_classes=dataset.num_classes(),
            input_dim=dataset.num_tokens(),
        ),
        decoder_config=DecoderConfig(
            transformer_config=TransformerConfig(
                model_size=args.d_rnn_hidden_dim,
                dropout=args.d_dropout,
                num_layers=args.d_n_layers,
                vocab_size=dataset.num_tokens(),
                num_heads=args.e_num_heads,
                norm_scheme=args.norm_scheme,
                remat=args.remat,
                ring_attention=args.ring_attention,
                sequence_sharding=args.ring_attention,
            ),
            latent_dim=args.latent_dim,
            num_classes=dataset.num_classes(),
            output_dim=dataset.num_tokens(),
            decoder_type=args.decoder_type,
            class_conditioning=args.class_conditioning,
            lstm_config=(
                LSTMConfig(
                    n_layers=args.d_n_layers,
                    hidden_dim=args.d_rnn_hidden_dim,
                    dropout=args.d_dropout,
                )
                if args.decoder_type == "lstm"
                else None
            ),
        ),
        dtype=args.dtype,
    )


def create_train_config(args) -> TrainConfig:
    """Reference: main.py:79-94."""
    return TrainConfig(
        batch_size=args.batch_size,
        sampling_frequency=args.sampling_frequency,
        checkpoint_frequency=args.checkpoint_frequency,
        num_checkpoints_not_improved=args.num_checkpoints_not_improved,
        optimizer=OptimizerConfig(
            optimizer=args.optimizer,
            optimizer_params=args.optimizer_params,
            learning_rate=args.learning_rate,
        ),
        kl_loss_weight=args.kl_loss,
        kl_anneal_steps=args.kl_anneal_steps,
        free_bits=args.free_bits,
        label_smoothing=args.label_smoothing,
        negative_label_downscaling=args.negative_label_downscaling,
        verbose=args.verbose,
        logdir=args.logdir,
        seed=args.seed,
        prefetch=args.prefetch,
        grad_accum_steps=args.grad_accum_steps,
        steps_per_dispatch=args.steps_per_dispatch,
        log_param_grad_norms=args.log_param_grad_norms,
        profile_dir=args.profile_dir,
        rng_impl=args.rng_impl,
        keep_checkpoints=args.keep_checkpoints,
        gen_health_rows=args.gen_health_rows,
    )


def create_toy_model_config(data) -> ModelConfig:
    """Reference: main.py:14-38 (create_toy_model_config)."""
    tc = TransformerConfig(
        model_size=32, dropout=0.0, num_layers=1, num_heads=2,
        vocab_size=data.num_tokens(),
    )
    return ModelConfig(
        encoder_config=EncoderConfig(
            transformer_config=tc, latent_dim=16,
            num_classes=data.num_classes(), input_dim=data.num_tokens(),
        ),
        decoder_config=DecoderConfig(
            transformer_config=tc, latent_dim=16,
            num_classes=data.num_classes(), output_dim=data.num_tokens(),
        ),
        dtype="float32",
    )


def create_toy_train_config() -> TrainConfig:
    """Reference: main.py:41-56."""
    return TrainConfig(
        batch_size=1,
        sampling_frequency=500,
        checkpoint_frequency=1000,
        num_checkpoints_not_improved=-1,
        kl_loss_weight=1.0,
        optimizer=OptimizerConfig(
            learning_rate=1e-3, optimizer="adam",
            optimizer_params="clip_gradient:1.0",
        ),
    )


def _select_devices(args):
    if args.cpu:
        return jax.devices("cpu")
    return jax.devices()


def _maybe_pin_cpu(args) -> None:
    if args.cpu:
        from ..utils import pin_local_cpu

        pin_local_cpu()


def main_toy(args, epochs: int = 20000) -> None:
    """Reference: main.py:59-76 (main_toy)."""
    dataset = ToyData()
    config = create_toy_model_config(dataset)
    model_folder = "/tmp/music-style-transfer/toy/model"
    os.makedirs(model_folder, exist_ok=True)
    config.save(os.path.join(model_folder, "config"))

    model = make_model(config)
    params = init_params(model, jax.random.key(args.seed), max_seq_len=4)
    trainer = Trainer(create_toy_train_config(), model, params, sampler=None)
    trainer.fit(
        dataset=dataset,
        validation_dataset=dataset,
        model_folder=model_folder,
        epochs=epochs,
    )


def main(argv=None) -> None:
    args = get_config(argv)

    from ..utils import configure_jax_cache

    configure_jax_cache()

    if args.dist_coordinator:
        # Multi-process mode: must run before any backend is touched.
        from ..parallel import initialize_distributed

        initialize_distributed(
            args.dist_coordinator,
            num_processes=args.dist_num_processes,
            process_id=args.dist_process_id,
            num_cpu_devices=args.dist_num_cpu_devices,
            gpus_per_host=args.dist_gpus_per_host,
        )

    _maybe_pin_cpu(args)

    if args.toy:
        main_toy(args)
        return

    loader = Loader(
        path=args.data,
        max_sequence_length=args.max_seq_len,
        slices_per_quarter_note=args.slices_per_quarter_note,
    )
    val_loader = (
        Loader(
            path=args.validation_data,
            max_sequence_length=args.max_seq_len,
            slices_per_quarter_note=args.slices_per_quarter_note,
        )
        if args.validation_data is not None
        else None
    )
    # device_layout: ship raw chunks; the jitted train step tensorizes on
    # device (the north-star host/device split — see data/dataset.py).
    train_dataset, valid_dataset = load_dataset(
        loader, args.batch_size, args.validation_split, val_loader,
        device_layout=True,
    )

    os.makedirs(args.model_output, exist_ok=True)
    if args.out_samples:
        os.makedirs(args.out_samples, exist_ok=True)

    config = create_model_config(args, train_dataset)
    config.save(os.path.join(args.model_output, "config"))
    print("Using configuration:")
    print(config.to_json())

    model = make_model(config)
    params = init_params(model, jax.random.key(args.seed),
                         max_seq_len=args.max_seq_len)
    n_params = sum(x.size for x in jax.tree.leaves(params))
    print(f"Model parameters: {n_params:,}")

    devices = _select_devices(args)
    mesh = make_mesh(devices, tp=args.tp) if (len(devices) > 1 or args.tp > 1) else None
    if mesh is not None:
        print(f"Mesh: {dict(mesh.shape)}")

    dist = None
    if args.dist_coordinator:
        from ..parallel import ProcessShardedDataset, mesh_process_info

        assert mesh is not None, "distributed mode needs a multi-device mesh"
        dist = mesh_process_info(mesh)
        print(f"Process {dist.index + 1}/{dist.count} "
              f"(global batch {train_dataset.batch_size})")
        train_dataset = ProcessShardedDataset(train_dataset, dist)
        # validation stays unwrapped: every process iterates the full set
        # and slices its rows (Trainer._eval_pass).

    from ..inference.sampler import get_sampler

    # The reference hardcodes 'sampling' here (main.py:156) even though it
    # parses --sampling-type; we honor the flag on both CLIs.
    sampler = get_sampler(args.sampling_type, args.model_output, None, args)

    trainer = Trainer(create_train_config(args), model, params,
                      sampler=sampler, mesh=mesh, dist=dist)
    trainer.fit(
        dataset=train_dataset,
        validation_dataset=valid_dataset,
        model_folder=args.model_output,
        epochs=args.epochs,
    )
    print("Training finished.")


if __name__ == "__main__":
    main()
