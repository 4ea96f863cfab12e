"""Evaluation metrics of the port (host numpy, copied from the JAX package)."""

from .evaluation import Evaluation, RegressionEvaluation, eval_metrics

__all__ = ["Evaluation", "RegressionEvaluation", "eval_metrics"]
