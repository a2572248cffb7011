"""Attention for the model: ``ops.attention`` (the one batched attention
function and its float32 reference) and ``ops.ring_attention`` (the
sequence-parallel ring over a mesh axis)."""

from . import attention
from .ring_attention import ring_attention, ring_attention_sharded

__all__ = ["attention", "ring_attention", "ring_attention_sharded"]
