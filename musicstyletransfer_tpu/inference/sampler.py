"""Samplers and style transfer: encode -> class swap -> decode -> MIDI files.

Reference: VarAutoEncoder/sampler.py:17-257. The API surface (get_sampler,
SamplerBase.process_dataset/process_batch, update_parameters,
reload_checkpoint, load_inference_model) and the output naming scheme
(``out-{i}.original.mid`` / ``out-{i}.class-{c}.mid``, sampler.py:90,102)
match the reference; generation itself runs as one jitted on-device loop
(decode.py) instead of a Python-stepped loop with a per-token host sync.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.dataset import Batch, Dataset
from ..midi.codec import MelodyWriter, melody_from_ids
from ..models.config import Config, ModelConfig
from ..models.vae import init_params, make_model
from ..training import checkpoint as ckpt
from .decode import beam_search, sample_sequences


def load_inference_model(
    model_folder: str,
    checkpoint: Optional[int],
    max_seq_len: int = 64,
):
    """Config JSON -> model; optionally restore params from a checkpoint.

    Reference: sampler.py:17-38 (load_inference_model). ``checkpoint=-1``
    picks the latest; ``None`` returns freshly initialized params (used for
    in-training samplers whose params are injected via update_parameters).
    """
    config = Config.load(os.path.join(model_folder, "config"))
    assert isinstance(config, ModelConfig), type(config)
    model = make_model(config)
    params = init_params(model, jax.random.key(0), max_seq_len=max_seq_len)
    if checkpoint is None:
        return model, params
    if checkpoint == -1:
        checkpoint = ckpt.get_latest_checkpoint_index(model_folder)
    params = ckpt.restore_params(model_folder, checkpoint, params)
    # restore_params hands back HOST numpy leaves. Place them on the
    # default device once, here — otherwise every jitted inference call
    # re-uploads the full parameter set as call arguments (measured to
    # dominate serving capacity, hiding the decode-budget win of length
    # bucketing).
    params = jax.device_put(params)
    return model, params


def get_sampler(type: str, model_folder: str, checkpoint: Optional[int], args):
    """Sampler factory (reference: sampler.py:41-53)."""
    visualize = getattr(args, "visualize_samples", False)
    if type == "sampling":
        return Sampling(model_folder, checkpoint, verbose=args.verbose,
                        seed=getattr(args, "seed", 0), visualize=visualize,
                        temperature=getattr(args, "temperature", 1.0),
                        top_k=getattr(args, "top_k", 0),
                        top_p=getattr(args, "top_p", 0.0))
    if type == "beam-search":
        return BeamSearchSampler(
            model_folder, checkpoint, beam_size=args.beam_size,
            verbose=args.verbose, visualize=visualize,
            length_penalty=getattr(args, "length_penalty", 0.0),
        )
    raise ValueError(f"Sampler {type} is not implemented")


class SamplerBase:
    """Reference: sampler.py:56-158 (SamplerBase)."""

    def __init__(
        self,
        model_folder: str,
        checkpoint: Optional[int],
        verbose: bool = False,
        max_seq_len: int = 64,
        visualize: bool = False,
    ):
        self.model, self.params = load_inference_model(
            model_folder, checkpoint, max_seq_len
        )
        self.model_folder = model_folder
        self.verbose = verbose
        self.visualize = visualize

    def reload_checkpoint(self, checkpoint: int) -> None:
        self.model, self.params = load_inference_model(
            self.model_folder, checkpoint
        )

    def update_parameters(self, params) -> None:
        """Adopt live training weights (reference: sampler.py:72-75).

        Copies the arrays: the jitted train step DONATES its input state,
        so aliasing the trainer's buffers would leave this sampler holding
        deleted arrays after the next training step.
        """
        self.params = jax.tree.map(jnp.copy, params)

    # ------------------------------------------------------------------

    def process_dataset(self, dataset: Dataset, output_suffix: str) -> None:
        """Write originals + per-target-class transfers for every batch
        (reference: sampler.py:77-109)."""
        os.makedirs(output_suffix, exist_ok=True)
        print("Starting to decode dataset")
        writer = MelodyWriter()
        current = 0
        for bi, batch in enumerate(dataset):
            print(f"Processing batch {bi}")
            self._write_batch(batch, output_suffix, dataset.num_classes(),
                              writer, index_offset=current)
            current += batch.batch_size
        print("Done with dataset decoding")

    def process_batch(
        self, batch: Batch, output_suffix: str, num_classes: int
    ) -> None:
        """Reference: sampler.py:111-135."""
        os.makedirs(output_suffix, exist_ok=True)
        self._write_batch(batch, output_suffix, num_classes, MelodyWriter(),
                          index_offset=0)

    def _write_batch(
        self,
        batch: Batch,
        output_suffix: str,
        num_classes: int,
        writer: MelodyWriter,
        index_offset: int,
    ) -> None:
        for i, row in enumerate(np.asarray(batch.tokens)):
            self._write_melody(
                writer, melody_from_ids(row),
                os.path.join(output_suffix,
                             f"out-{index_offset + i}.original.mid"),
            )
        all_sequences = self.sample_all_classes(batch, num_classes)
        for class_idx in range(num_classes):
            for i, row in enumerate(np.asarray(all_sequences[class_idx])):
                self._write_melody(
                    writer, melody_from_ids(row),
                    os.path.join(
                        output_suffix,
                        f"out-{index_offset + i}.class-{class_idx}.mid",
                    ),
                )

    def _write_melody(self, writer, melody, path: str) -> None:
        writer.write_to_file(path, melody)
        if self.visualize and len(melody):
            # Piano-roll PNG next to each MIDI (--visualize-samples; the
            # reference's visualize path was stale, utils.py:52-61).
            from ..utils import visualize_melody

            visualize_melody(melody, path + ".png")

    def sample_all_classes(self, batch: Batch, num_classes: int) -> np.ndarray:
        """[C, B, T] transfers into every class. Default: host loop with the
        class conditioning overwritten per class (reference: sampler.py:93-95);
        Sampling overrides this with the fused single-call path."""
        outs = []
        for class_idx in range(num_classes):
            transfer = Batch(
                tokens=batch.tokens,
                seq_lens=batch.seq_lens,
                classes=np.full_like(batch.classes, class_idx),
                labels=batch.labels,
            )
            outs.append(self.sample(transfer))
        return np.stack(outs, axis=0)

    def sample(self, batch: Batch) -> np.ndarray:
        raise NotImplementedError


class Sampling(SamplerBase):
    """Ancestral multinomial sampling (reference: sampler.py:161-189),
    with optional temperature / top-k / nucleus (top-p) controls."""

    def __init__(self, *args, seed: int = 0, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self._rng = jax.random.key(seed)
        self.temperature = temperature
        self.top_k = int(top_k)
        self.top_p = float(top_p)

    def sample(self, batch: Batch) -> np.ndarray:
        max_len = int(batch.tokens.shape[1]) * 2  # reference: sampler.py:164
        self._rng, key = jax.random.split(self._rng)
        seqs, _scores = sample_sequences(
            self.model,
            self.params,
            jnp.asarray(batch.tokens),
            jnp.asarray(batch.seq_lens),
            jnp.asarray(batch.classes),
            max_len,
            key,
            self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
        )
        return np.asarray(seqs)

    def sample_all_classes(self, batch: Batch, num_classes: int) -> np.ndarray:
        """One fused device call: encode + decode all C target classes."""
        from .decode import style_transfer_all_classes

        max_len = int(batch.tokens.shape[1]) * 2
        self._rng, key = jax.random.split(self._rng)
        seqs, _scores = style_transfer_all_classes(
            self.model,
            self.params,
            jnp.asarray(batch.tokens),
            jnp.asarray(batch.seq_lens),
            max_len,
            num_classes,
            key,
            self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
        )
        return np.asarray(seqs)


class BeamSearchSampler(SamplerBase):
    """Batched beam search (working redesign of reference sampler.py:192-257)."""

    def __init__(self, *args, beam_size: int = 5, length_penalty: float = 0.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.beam_size = beam_size
        self.length_penalty = length_penalty
        self.max_length_factor = 2.0

    def sample(self, batch: Batch) -> np.ndarray:
        max_len = int(batch.tokens.shape[1] * self.max_length_factor)
        seqs, _scores = beam_search(
            self.model,
            self.params,
            jnp.asarray(batch.tokens),
            jnp.asarray(batch.seq_lens),
            jnp.asarray(batch.classes),
            max_len,
            self.beam_size,
            self.length_penalty,
        )
        return np.asarray(seqs)
