"""Models of the port: the flagship BERT-base transformer (serving path)."""

from .transformer import (
    DecodeSlotPool,
    KvCacheLostError,
    QaHead,
    Transformer,
    TransformerConfig,
    generate,
    init_params,
    init_qa_head,
)
from .weights import params_from_jax, params_to_numpy, qa_params_from_jax

__all__ = [
    "DecodeSlotPool",
    "KvCacheLostError",
    "QaHead",
    "Transformer",
    "TransformerConfig",
    "generate",
    "init_params",
    "init_qa_head",
    "params_from_jax",
    "params_to_numpy",
    "qa_params_from_jax",
]
