"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (the version CPU tensors take, and the one the card's run is held
against)."""

from .attention import (
    dot_product_attention,
    flash_attention,
    flash_forward,
    flash_forward_reference,
    mha_reference,
)

__all__ = [
    "dot_product_attention",
    "flash_attention",
    "flash_forward",
    "flash_forward_reference",
    "mha_reference",
]
