"""Models of the port: the flagship BERT-base transformer (serving and
training) and its HF checkpoint import (``models.bert_import``), the
GravesLSTM char-RNN, the image zoo: LeNet, SimpleCNN, VGG16, VGG19, AlexNet,
Darknet19 and TinyYOLO (MultiLayerNetworks), ResNet-50, InceptionResNetV1,
SqueezeNet, UNet, Xception and NASNet (ComputationGraphs), the
Mixture-of-Experts FFN with its expert-parallel form, and the variational
autoencoder."""

from .facenet import InceptionResNetV1
from .moe import MoEConfig, init_moe_params, moe_ffn, moe_partition_specs
from .nasnet import NASNet
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
    actor_critic_params_from_jax,
    cg_params_from_jax,
    mln_params_from_jax,
    moe_params_from_jax,
    params_from_jax,
    params_to_numpy,
    qa_params_from_jax,
    updater_state_from_jax,
    updater_state_to_numpy,
    vae_params_from_jax,
)
from .vae import VariationalAutoencoder
from .vgg import VGG16, VGG19
from .zoo import LeNet, SimpleCNN, ZooModel
from .yolo import TinyYOLO, Yolo2OutputLayer
from .zoo_ext import AlexNet, Darknet19, SqueezeNet, UNet, Xception

__all__ = [
    "actor_critic_params_from_jax",
    "AlexNet",
    "BlockAllocator",
    "cg_params_from_jax",
    "Darknet19",
    "DecodeSlotPool",
    "InceptionResNetV1",
    "KvCacheLostError",
    "LeNet",
    "NoFreeBlocksError",
    "PagedDecodeSlotPool",
    "QaHead",
    "ResNet50",
    "SimpleCNN",
    "SqueezeNet",
    "TextGenerationLSTM",
    "TinyYOLO",
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
    "MoEConfig",
    "init_moe_params",
    "moe_ffn",
    "moe_params_from_jax",
    "moe_partition_specs",
    "NASNet",
    "params_from_jax",
    "params_to_numpy",
    "qa_loss_fn",
    "qa_params_from_jax",
    "token_ce_loss",
    "UNet",
    "updater_state_from_jax",
    "updater_state_to_numpy",
    "vae_params_from_jax",
    "VariationalAutoencoder",
    "VGG16",
    "VGG19",
    "Xception",
    "Yolo2OutputLayer",
    "ZooModel",
]
