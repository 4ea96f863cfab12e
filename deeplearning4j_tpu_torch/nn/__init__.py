"""Neural-network building blocks of the port: updaters and schedules."""

from .updaters import Adam, FixedSchedule, IUpdater, NoOp, Schedule, Sgd, WarmupLinearDecay

__all__ = ["Adam", "FixedSchedule", "IUpdater", "NoOp", "Schedule", "Sgd",
           "WarmupLinearDecay"]
