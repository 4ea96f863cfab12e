"""Neural-network building blocks of the port: updaters and schedules."""

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

__all__ = ["AdaDelta", "AdaGrad", "AdaMax", "Adam", "AMSGrad", "ExponentialSchedule",
           "FixedSchedule", "InverseSchedule", "IUpdater", "Nadam", "Nesterovs", "NoOp",
           "PolySchedule", "RmsProp", "Schedule", "Sgd", "SigmoidSchedule", "StepSchedule",
           "WarmupLinearDecay"]
