"""Models of the port: the flagship BERT-base transformer (serving and
training), LeNet and SimpleCNN, the GravesLSTM char-RNN, and the
ComputationGraph models ResNet-50 and InceptionResNetV1."""

from .facenet import InceptionResNetV1
from .paged_decode import BlockAllocator, NoFreeBlocksError, PagedDecodeSlotPool
from .resnet import ResNet50
from .text_lstm import TextGenerationLSTM
from .transformer import (
    DecodeSlotPool,
    KvCacheLostError,
    QaHead,
    Transformer,
    TransformerConfig,
    generate,
    init_params,
    init_qa_head,
    layer_costs,
    loss_and_grads,
    loss_fn,
    make_qa_train_step,
    make_train_step,
    qa_loss_fn,
    token_ce_loss,
)
from .weights import (
    cg_params_from_jax,
    mln_params_from_jax,
    params_from_jax,
    params_to_numpy,
    qa_params_from_jax,
    updater_state_from_jax,
    updater_state_to_numpy,
)
from .zoo import LeNet, SimpleCNN, ZooModel

__all__ = [
    "BlockAllocator",
    "cg_params_from_jax",
    "DecodeSlotPool",
    "InceptionResNetV1",
    "KvCacheLostError",
    "LeNet",
    "NoFreeBlocksError",
    "PagedDecodeSlotPool",
    "QaHead",
    "ResNet50",
    "SimpleCNN",
    "TextGenerationLSTM",
    "Transformer",
    "TransformerConfig",
    "generate",
    "init_params",
    "init_qa_head",
    "layer_costs",
    "loss_and_grads",
    "loss_fn",
    "make_qa_train_step",
    "make_train_step",
    "mln_params_from_jax",
    "params_from_jax",
    "params_to_numpy",
    "qa_loss_fn",
    "qa_params_from_jax",
    "token_ce_loss",
    "updater_state_from_jax",
    "updater_state_to_numpy",
    "ZooModel",
]
