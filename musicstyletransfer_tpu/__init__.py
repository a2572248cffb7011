"""musicstyletransfer_tpu: a JAX MIDI music style-transfer framework that
runs on NVIDIA GPUs and on the CPU (the package name is historical).

Capability parity target: slyforce/MusicStyleTransfer (see SURVEY.md).
The architecture is idiomatic JAX, not a translation:

- ``midi``      — event vocabulary, SMF byte codec, MIDI<->token streams
                  (reference: music_style_transfer/MIDIUtil/*).
- ``data``      — corpus loading, tensorization, static-shape batching
                  (reference: VarAutoEncoder/data.py).
- ``models``    — class-conditional sequence-VAE transformer as parameter
                  pytrees + functions (reference: VarAutoEncoder/model.py,
                  transformer.py); the GAN family.
- ``ops``       — attention (cuDNN fused attention on the GPU via
                  jax.nn.dot_product_attention) and ring attention.
- ``parallel``  — jax.sharding mesh / partitioning rules, pipeline,
                  multi-process layer.
- ``training``  — losses, metrics, fused jitted train step, trainer loop,
                  checkpointing (reference: trainer.py, loss.py, metrics.py).
- ``inference`` — on-device autoregressive decoding (lax.while_loop + KV
                  cache), style transfer, samplers, serving (reference:
                  sampler.py).
- ``cli``       — argparse surface and entry points (reference: config.py,
                  main.py).
- ``hardware``  — the GPU-or-fail device gate and published peak rates.
"""

__version__ = "0.1.0"
