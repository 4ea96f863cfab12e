"""Evaluation metrics of the port (host numpy, copied from the JAX package)."""

from .evaluation import Evaluation, RegressionEvaluation

__all__ = ["Evaluation", "RegressionEvaluation"]
