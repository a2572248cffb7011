"""Standalone sampling / style-transfer CLI:
``python -m musicstyletransfer_tpu.cli.sample``.

Reference: VarAutoEncoder/sampler.py:259-296 (sample_toy + main).
"""

from __future__ import annotations

import jax

from ..data import Loader, MelodyDataset, ToyData
from ..inference.sampler import get_sampler
from .flags import get_config


def _setup_jax(args) -> None:
    """Enable the compile cache, optional CPU pin
    (--cpu pins the default device without dropping other backends)."""
    from ..utils import (
        configure_jax_cache, pin_local_cpu,
    )

    configure_jax_cache()
    if getattr(args, "cpu", False):
        pin_local_cpu()


def sample_toy(args) -> None:
    """Reference: sampler.py:261-270."""
    sampler = get_sampler(
        "sampling", "/tmp/music-style-transfer/toy/model", args.checkpoint, args
    )
    dataset = ToyData()
    sampler.process_dataset(dataset, args.out_samples)


def main(argv=None) -> None:
    args = get_config(argv)
    if not args.out_samples:
        # Default is None; without this the sampler dies later in
        # os.makedirs(None) with an unhelpful TypeError.
        raise SystemExit(
            "sample: --out-samples OUTPUT_DIR is required "
            "(where the transferred .mid files are written)"
        )
    _setup_jax(args)

    if args.toy:
        sample_toy(args)
        return

    loader = Loader(
        path=args.data,
        max_sequence_length=args.max_seq_len,
        slices_per_quarter_note=args.slices_per_quarter_note,
    )
    dataset = MelodyDataset(
        args.batch_size, loader.max_sequence_length, loader.melodies
    )

    sampler = get_sampler(
        args.sampling_type, args.model_output, args.checkpoint, args
    )
    sampler.process_dataset(dataset, args.out_samples)


if __name__ == "__main__":
    main()
