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
from .autotune import AutotuneTable, autotune_flash_attention, resolve_blocks, static_flash_blocks

__all__ = [
    "AutotuneTable",
    "FlashAttentionFunction",
    "autotune_flash_attention",
    "dot_product_attention",
    "flash_attention",
    "flash_backward",
    "flash_backward_dkv",
    "flash_backward_dq",
    "flash_backward_reference",
    "flash_forward",
    "flash_forward_reference",
    "mha_reference",
    "resolve_blocks",
    "static_flash_blocks",
]
