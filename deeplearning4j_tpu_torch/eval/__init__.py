"""Evaluation metrics of the port (host numpy, copied from the JAX package)."""

from .evaluation import (
    ROC,
    Evaluation,
    EvaluationBinary,
    EvaluationCalibration,
    RegressionEvaluation,
    ROCMultiClass,
    eval_metrics,
)

__all__ = ["Evaluation", "RegressionEvaluation", "ROC", "EvaluationBinary",
           "ROCMultiClass", "EvaluationCalibration", "eval_metrics"]
