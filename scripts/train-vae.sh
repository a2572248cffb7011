#!/bin/bash
# Canonical VAE training run (reference: scripts/train-vae.sh:1-29).
# Same hyperparameters; entry point is this package's CLI.
set -e

python -m musicstyletransfer_tpu.cli.main \
--batch-size 32 \
--kl-loss 1.0 \
--validation-split 0.0 \
--max-seq-len 64 \
--slices-per-quarter-note 4 \
--data ./work/data/guitar_bass \
--model-output models/guitar_bass \
--out-samples /tmp/out \
--sampling-frequency 2000 \
--checkpoint-frequency 1000 \
--num-checkpoints-not-improved 32 \
--epochs 10000 \
--optimizer adam \
--optimizer-params clip_gradient:1.0 \
--learning-rate 0.0003 \
--label-smoothing 0.0 \
--e-n-layers 2 \
--e-dropout 0.2 \
--e-rnn-hidden-dim 256 \
--e-emb-hidden-dim 256 \
--latent-dim 256 \
--d-n-layers 1 \
--d-rnn-hidden-dim 128 \
--d-dropout 0.2 \
--steps-per-dispatch 8 \
--kl-anneal-steps 2000 \
--free-bits 0.1 \
"$@"
# --steps-per-dispatch 8: the canonical step is small enough for host
# dispatch to matter; 8 steps per program amortize it. Bit-identical
# training trajectory; pass --steps-per-dispatch 1 for per-step dispatch.
# --kl-anneal-steps 2000 --free-bits 0.1: DOCUMENTED DIVERGENCE from the
# reference objective (round 4). The plain objective measurably collapses
# the latent (KL -> 0.001; target-fit looks fine while content
# preservation dies), so the shipped
# checkpoint's recipe is the default. Pass --kl-anneal-steps 0
# --free-bits 0 for the bare reference objective.
