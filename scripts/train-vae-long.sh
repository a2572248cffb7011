#!/bin/bash
# Long-sequence VAE with sequence-parallel ring attention: the time axis
# shards over the mesh's model axis (--tp carries the ring) and K/V chunks
# rotate via ppermute (ops/ring_attention.py). Any max-seq-len works (the
# ring pads the time axis internally); 2046 keeps the decoder's T = L+2 at
# a round 2048.
# On a single device the ring is ineligible and the stacks use the fused
# attention of ops/attention.py — same command, graceful degradation (TP
# defaults to 1 so the command runs anywhere; set TP=2.. on a multi-GPU
# host to engage the ring — make_mesh rejects TP > device count).
set -e

python -m musicstyletransfer_tpu.cli.main \
--batch-size 4 \
--kl-loss 0.5 \
--validation-split 0.1 \
--max-seq-len 2046 \
--data "${DATA:-./work/data/guitar_bass}" \
--model-output models/long \
--out-samples /tmp/out-long \
--sampling-frequency 2000 \
--checkpoint-frequency 1000 \
--num-checkpoints-not-improved 32 \
--epochs 10000 \
--optimizer adam \
--optimizer-params clip_gradient:1.0,skip_nonfinite:10 \
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
--class-conditioning per_step \
--ring-attention \
--tp "${TP:-1}" \
"$@"
# --class-conditioning per_step --free-bits 0.1: the
# structural fix for long-L conditioning. With the class signal only in
# the prepended position-0 state, NO free-bits floor passed both
# quality axes at L=2046 — 0.1 (51 nats) let z's register info override
# the class (transfers kept the SOURCE register), 0.02 flipped register
# but starved content preservation to its null's edge (both ends
# measured). Injecting the
# class embedding at EVERY decoder position decouples the two: the
# class no longer competes with z for the position-0 channel, so the
# floor can stay at the corpus-scale 0.1 and z keeps row content.
# Measured (models/long_ps01): octave JS to
# target 0.009 vs 0.653 to the other class (128 transfers; the best
# initial-only point managed 0.168), own-source JS <= shuffled null
# (0.375 < 0.396 at n=32, at the null at n=128 under sampled decode),
# same teacher-forced quality (acc 0.600 / ppl 2.84, eval KL 8.4).
# skip_nonfinite:10: the measured long run logged finite grad spikes to
# 2.6e4 near the end; the guard rejects any NaN/Inf step outright (inert
# on finite grads, so it does not change the measured recipe).
# --kl-anneal-steps 2000: same documented
# divergence family as train-vae.sh (the plain objective collapses the
# latent). Pass --kl-anneal-steps 0 --free-bits 0 --class-conditioning
# initial for the bare reference objective.
