"""Models of the port: the flagship BERT-base transformer (serving and training)."""

from .paged_decode import BlockAllocator, NoFreeBlocksError, PagedDecodeSlotPool
from .transformer import (
    DecodeSlotPool,
    KvCacheLostError,
    QaHead,
    Transformer,
    TransformerConfig,
    generate,
    init_params,
    init_qa_head,
    loss_and_grads,
    loss_fn,
    make_qa_train_step,
    make_train_step,
    qa_loss_fn,
    token_ce_loss,
)
from .weights import (
    params_from_jax,
    params_to_numpy,
    qa_params_from_jax,
    updater_state_from_jax,
    updater_state_to_numpy,
)

__all__ = [
    "BlockAllocator",
    "DecodeSlotPool",
    "KvCacheLostError",
    "NoFreeBlocksError",
    "PagedDecodeSlotPool",
    "QaHead",
    "Transformer",
    "TransformerConfig",
    "generate",
    "init_params",
    "init_qa_head",
    "loss_and_grads",
    "loss_fn",
    "make_qa_train_step",
    "make_train_step",
    "params_from_jax",
    "params_to_numpy",
    "qa_loss_fn",
    "qa_params_from_jax",
    "token_ce_loss",
    "updater_state_from_jax",
    "updater_state_to_numpy",
]
