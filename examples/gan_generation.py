"""Class-conditional GAN: short adversarial training + MIDI generation.

Trains the reconstructed GAN family (models/gan.py) on the bundled
guitar/bass corpus for a few epochs, then generates MIDI per class and
prints the class-conditional quality statistics (pitch-class + octave JS
vs the corpus profiles).

    python examples/gan_generation.py [corpus_dir] [out_dir] [epochs]

Defaults: work/data/guitar_bass, /tmp/mst-gan-example, 20 epochs
(~1 min on CPU).
"""

import os
import sys

# Runnable from a plain checkout (no pip install): the repo root is the
# example's parent directory.
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

from musicstyletransfer_tpu.data import Loader, load_dataset
from musicstyletransfer_tpu.inference.quality import class_conditional_stats
from musicstyletransfer_tpu.models.gan import (
    DiscriminatorConfig,
    GANConfig,
    GeneratorConfig,
)
from musicstyletransfer_tpu.training.gan_trainer import (
    GANTrainConfig,
    GANTrainer,
)
from musicstyletransfer_tpu.utils import configure_jax_cache


def main() -> None:
    configure_jax_cache()
    corpus_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "work/data/guitar_bass"
    )
    out_dir = sys.argv[2] if len(sys.argv) > 2 else "/tmp/mst-gan-example"
    epochs = int(sys.argv[3]) if len(sys.argv) > 3 else 20

    L = 64
    loader = Loader(path=corpus_dir, max_sequence_length=L,
                    slices_per_quarter_note=4)
    dataset, _ = load_dataset(loader, 32, 0.0, None)

    config = GANConfig(
        generator_config=GeneratorConfig(
            n_layers=1, hidden_dim=256, emb_dim=256, noise_dim=64,
            num_classes=dataset.num_classes(),
            output_dim=dataset.num_tokens(), max_seq_len=L,
        ),
        discriminator_config=DiscriminatorConfig(
            n_layers=1, hidden_dim=256, emb_dim=256,
            num_classes=dataset.num_classes(),
            input_dim=dataset.num_tokens(),
        ),
        dtype="bfloat16" if jax.default_backend() != "cpu" else "float32",
    )
    trainer = GANTrainer(
        config,
        GANTrainConfig(checkpoint_frequency=0, sampling_frequency=0,
                       num_samples=8),
    )
    metrics = trainer.fit(dataset, os.path.join(out_dir, "model"),
                          epochs=epochs)
    print("final:", {k: round(v, 4) for k, v in metrics.items()})

    paths = trainer.sample_to_midi(trainer.g_state.params,
                                   os.path.join(out_dir, "samples"))
    print(f"wrote {len(paths)} MIDI samples to {out_dir}/samples")

    melodies = loader.read_melodies()
    corpus = {
        i: [m.tokens for m in melodies[name]]
        for i, name in enumerate(sorted(melodies))
    }
    stats = class_conditional_stats(
        trainer.generate_class_rows(trainer.g_state.params), corpus
    )
    print("quality:", {k: round(v, 4) for k, v in stats.items()})


if __name__ == "__main__":
    main()
