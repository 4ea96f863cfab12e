"""Neural-network building blocks of the port: the MultiLayerNetwork
runtime, its configuration builders and core layers, activations, losses,
weight init, dropout, constraints, updaters and schedules."""

from .attention_layers import LearnedSelfAttentionLayer, SelfAttentionLayer
from .conf import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    GlobalPoolingLayer,
    GravesLSTM,
    InputType,
    LastTimeStep,
    Layer,
    LossLayer,
    LSTM,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    OutputLayer,
    RnnOutputLayer,
    SubsamplingLayer,
)
from .multilayer import MultiLayerNetwork
from .updaters import (
    AdaDelta,
    AdaGrad,
    AdaMax,
    Adam,
    AMSGrad,
    ExponentialSchedule,
    FixedSchedule,
    InverseSchedule,
    IUpdater,
    Nadam,
    Nesterovs,
    NoOp,
    PolySchedule,
    RmsProp,
    Schedule,
    Sgd,
    SigmoidSchedule,
    StepSchedule,
    WarmupLinearDecay,
)

__all__ = ["ActivationLayer", "BatchNormalization", "ConvolutionLayer", "DenseLayer",
           "DropoutLayer", "GlobalPoolingLayer", "GravesLSTM", "InputType", "LastTimeStep",
           "Layer", "LearnedSelfAttentionLayer", "LossLayer", "LSTM", "MultiLayerConfiguration",
           "MultiLayerNetwork", "NeuralNetConfiguration", "OutputLayer", "RnnOutputLayer",
           "SelfAttentionLayer", "SubsamplingLayer",
           "AdaDelta", "AdaGrad", "AdaMax", "Adam", "AMSGrad", "ExponentialSchedule",
           "FixedSchedule", "InverseSchedule", "IUpdater", "Nadam", "Nesterovs", "NoOp",
           "PolySchedule", "RmsProp", "Schedule", "Sgd", "SigmoidSchedule", "StepSchedule",
           "WarmupLinearDecay"]
