#!/bin/bash
# Scaled VAE: wider hidden/latent, longer note sequences. Point --data at a
# large corpus (e.g. a Lakh MIDI subset laid out as class subdirectories).
set -e

python -m musicstyletransfer_tpu.cli.main \
--batch-size 16 \
--kl-loss 0.5 \
--validation-split 0.1 \
--max-seq-len 512 \
--data "${DATA:-./work/data/guitar_bass}" \
--model-output models/scaled \
--out-samples /tmp/out-scaled \
--sampling-frequency 2000 \
--checkpoint-frequency 1000 \
--num-checkpoints-not-improved 32 \
--epochs 10000 \
--optimizer adam \
--optimizer-params clip_gradient:1.0 \
--learning-rate 0.0002 \
--e-n-layers 4 \
--e-dropout 0.1 \
--e-rnn-hidden-dim 512 \
--e-num-heads 8 \
--latent-dim 512 \
--d-n-layers 2 \
--d-rnn-hidden-dim 256 \
--d-dropout 0.1 \
--kl-anneal-steps 2000 \
--free-bits 0.1 \
--steps-per-dispatch 4 \
"$@"
# No --remat: activations fit device memory at this size, so recompute
# buys nothing. Pass --remat yourself for bigger variants that run out.
# --steps-per-dispatch 4: 4 steps per program amortize host dispatch.
# Exact same semantics as 4 single steps.
# --kl-anneal-steps 2000 --free-bits 0.1: same documented divergence
# as train-vae.sh — the plain objective measurably collapses the
# latent at this scale (KL 0.001 on an earlier scaled run). Pass
# --kl-anneal-steps 0 --free-bits 0 for the bare reference objective.
