"""Training listeners: the TrainingListener SPI and its implementations."""

from .listeners import (
    TrainingListener,
    ScoreIterationListener,
    PerformanceListener,
    CheckpointListener,
    TimeIterationListener,
    CollectScoresIterationListener,
    EvaluativeListener,
)

__all__ = [
    "TrainingListener",
    "ScoreIterationListener",
    "PerformanceListener",
    "CheckpointListener",
    "TimeIterationListener",
    "CollectScoresIterationListener",
    "EvaluativeListener",
]
