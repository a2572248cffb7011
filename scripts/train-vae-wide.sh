#!/bin/bash
# Wide VAE (enc 4x1024 h16 / dec 2x512 h16, L=512, bf16, remat-free): the
# largest-matmul training config this framework ships; use it when the
# corpus is large enough to feed ~79M parameters.
set -e

python -m musicstyletransfer_tpu.cli.main \
--batch-size 8 \
--kl-loss 0.5 \
--validation-split 0.1 \
--max-seq-len 512 \
--data "${DATA:-./work/data/guitar_bass}" \
--model-output models/wide \
--out-samples /tmp/out-wide \
--sampling-frequency 2000 \
--checkpoint-frequency 1000 \
--num-checkpoints-not-improved 32 \
--epochs 10000 \
--optimizer adam \
--optimizer-params clip_gradient:1.0,clip_global_norm:1.0,warmup_steps:500,decay_steps:17000,skip_nonfinite:10 \
--learning-rate 0.0002 \
--e-n-layers 4 \
--e-dropout 0.1 \
--e-rnn-hidden-dim 1024 \
--e-num-heads 16 \
--latent-dim 1024 \
--d-n-layers 2 \
--d-rnn-hidden-dim 512 \
--d-dropout 0.1 \
--norm-scheme pre \
--kl-anneal-steps 2000 \
--free-bits 0.1 \
--steps-per-dispatch 4 \
"$@"
# --kl-anneal-steps 2000 --free-bits 0.1: same documented divergence
# as train-vae.sh — the plain objective measurably collapses the
# latent at this scale (KL 0.001 on an earlier scaled run). Pass
# --kl-anneal-steps 0 --free-bits 0 for the bare reference objective.
#
# Schedule + global-norm clip: a wide run at a flat 2e-4 had late-run
# grad-norm spikes (8.5-28.3) and per-checkpoint generation health
# oscillating to a degenerate FINAL checkpoint. warmup 500 + cosine decay over 17k
# steps (the 20-epoch budget on the synth_scaled corpus) plus
# clip_global_norm:1.0 bound the tail; the trainer's per-checkpoint
# generation-health probe (--gen-health-rows, default 8) tracks decode
# collapse that teacher-forced CE misses.
#
# --norm-scheme pre is what actually holds this config together: post-LN
# at d=1024 depth-4 explodes in the BACKWARD at ~2200 steps regardless
# of schedule/clipping. Pre-LN bounded grad norms at <=7.0 over a full
# 17,240-step run with zero non-finite updates.
