"""Tensor ops of the port: the flash-attention kernels' wrappers, norms and
RoPE tables. svi_tpu's exports, imported at first access; svi_tpu's
`apply_rope` is the attention kernels' RoPE pre-pass
(`attention.rope_rotate_flat`)."""

from .._exports import lazy_exports

_EXPORTS = {
    "attention_bnsd": "attention",
    "flash_attention": "attention",
    "channel_rms_norm": "norms",
    "gelu_tanh": "norms",
    "layer_norm": "norms",
    "modulate": "norms",
    "rms_norm": "norms",
    "t5_layer_norm": "norms",
    "rope_angles_for_grid": "rope",
    "sinusoidal_embedding_1d": "rope",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
