"""Neural-network building blocks of the port: the MultiLayerNetwork and
ComputationGraph runtimes, their configuration builders, core layers and
graph vertices, activations, losses, weight init, dropout, constraints,
updaters and schedules."""

from .attention_layers import (AttentionVertex, LearnedSelfAttentionLayer,
                               RecurrentAttentionLayer, SelfAttentionLayer)
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
from .graph import ComputationGraph
from .graph_conf import (
    ComputationGraphConfiguration,
    ElementWiseVertex,
    FlattenVertex,
    GraphBuilder,
    GraphVertex,
    L2NormalizeVertex,
    MergeVertex,
    PreprocessorVertex,
    ReshapeVertex,
    ScaleVertex,
    ShiftVertex,
    StackVertex,
    SubsetVertex,
    UnstackVertex,
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

__all__ = ["ActivationLayer", "AttentionVertex", "BatchNormalization", "ComputationGraph",
           "ComputationGraphConfiguration", "ConvolutionLayer", "DenseLayer", "DropoutLayer",
           "ElementWiseVertex", "FlattenVertex", "GlobalPoolingLayer", "GraphBuilder",
           "GraphVertex", "GravesLSTM", "InputType", "L2NormalizeVertex", "LastTimeStep",
           "Layer", "LearnedSelfAttentionLayer", "LossLayer", "LSTM", "MergeVertex",
           "MultiLayerConfiguration", "MultiLayerNetwork", "NeuralNetConfiguration",
           "OutputLayer", "PreprocessorVertex", "RecurrentAttentionLayer", "ReshapeVertex",
           "RnnOutputLayer", "ScaleVertex", "SelfAttentionLayer", "ShiftVertex",
           "StackVertex", "SubsamplingLayer", "SubsetVertex", "UnstackVertex",
           "AdaDelta", "AdaGrad", "AdaMax", "Adam", "AMSGrad", "ExponentialSchedule",
           "FixedSchedule", "InverseSchedule", "IUpdater", "Nadam", "Nesterovs", "NoOp",
           "PolySchedule", "RmsProp", "Schedule", "Sgd", "SigmoidSchedule", "StepSchedule",
           "WarmupLinearDecay"]
