"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (the version CPU tensors take, and the one the card's run is held
against)."""

from .attention import (
    FlashAttentionFunction,
    dot_product_attention,
    flash_attention,
    flash_backward,
    flash_backward_dkv,
    flash_backward_dq,
    flash_backward_reference,
    flash_forward,
    flash_forward_reference,
    mha_reference,
)

__all__ = [
    "FlashAttentionFunction",
    "dot_product_attention",
    "flash_attention",
    "flash_backward",
    "flash_backward_dkv",
    "flash_backward_dq",
    "flash_backward_reference",
    "flash_forward",
    "flash_forward_reference",
    "mha_reference",
]
