"""Evaluation metrics.

Copy of ``Evaluation`` and ``RegressionEvaluation`` from
``deeplearning4j_tpu/eval/evaluation.py`` (nd4j's ``Evaluation``: confusion
matrix, accuracy/precision/recall/F1; ``RegressionEvaluation``: per-column
MSE/MAE/RMSE/R²), host numpy and merge-able across minibatches. Their
``to_metrics`` export to the monitoring registry waits for the monitoring
port (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _to_np(x):
    if hasattr(x, "detach"):  # a torch tensor, wherever it lives
        return x.detach().cpu().numpy()
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


class Evaluation:
    """Multi-class classification eval over one-hot (or prob) outputs."""

    def __init__(self, num_classes: Optional[int] = None):
        self.num_classes = num_classes
        self.confusion: Optional[np.ndarray] = None  # [actual, predicted]

    def _ensure(self, n):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)
        elif n > self.num_classes:
            # grow for classes unseen in earlier minibatches (int-label path)
            grown = np.zeros((n, n), dtype=np.int64)
            grown[: self.num_classes, : self.num_classes] = self.confusion
            self.confusion = grown
            self.num_classes = n

    def eval(self, labels, predictions, mask=None) -> None:
        """labels/predictions: [N, C] one-hot / probabilities, or [N] ints.
        Time series [N, C, T] are flattened over (N,T) with optional mask."""
        y, p = _to_np(labels), _to_np(predictions)
        if y.ndim == 3:  # [N,C,T] -> [N*T, C]
            n, c, t = y.shape
            m = _to_np(mask).reshape(-1).astype(bool) if mask is not None else None
            y = np.moveaxis(y, 1, 2).reshape(-1, c)
            p = np.moveaxis(p, 1, 2).reshape(-1, c)
            if m is not None:
                y, p = y[m], p[m]
        y_idx = y.argmax(-1) if y.ndim > 1 else y.astype(np.int64)
        p_idx = p.argmax(-1) if p.ndim > 1 else p.astype(np.int64)
        n_classes = max(
            (y.shape[-1] if y.ndim > 1 else int(y_idx.max()) + 1),
            (p.shape[-1] if p.ndim > 1 else int(p_idx.max()) + 1),
        )
        self._ensure(n_classes)
        np.add.at(self.confusion, (y_idx, p_idx), 1)

    def merge(self, other: "Evaluation") -> "Evaluation":
        if other.confusion is not None:
            self._ensure(other.num_classes)
            self.confusion += other.confusion
        return self

    # --- metrics (Evaluation.accuracy()/precision()/recall()/f1()) ---

    def _tp(self):
        return np.diag(self.confusion).astype(np.float64)

    def accuracy(self) -> float:
        total = self.confusion.sum()
        return float(self._tp().sum() / total) if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        col = self.confusion.sum(axis=0).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(col > 0, self._tp() / col, np.nan)
        return float(per[cls]) if cls is not None else float(np.nanmean(per))

    def recall(self, cls: Optional[int] = None) -> float:
        row = self.confusion.sum(axis=1).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(row > 0, self._tp() / row, np.nan)
        return float(per[cls]) if cls is not None else float(np.nanmean(per))

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def stats(self) -> str:
        lines = [
            f"# of classes: {self.num_classes}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall:    {self.recall():.4f}",
            f"F1 Score:  {self.f1():.4f}",
            "Confusion matrix (rows=actual, cols=predicted):",
            str(self.confusion),
        ]
        return "\n".join(lines)


class RegressionEvaluation:
    """org.nd4j.evaluation.regression.RegressionEvaluation: per-column
    MSE/MAE/RMSE/R²/correlation, merge-able."""

    def __init__(self):
        self.n = 0
        self.sum_err2 = None
        self.sum_abs_err = None
        self.sum_y = None
        self.sum_y2 = None
        self.sum_p = None
        self.sum_p2 = None
        self.sum_yp = None

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = _to_np(labels), _to_np(predictions)
        y = y.reshape(-1, y.shape[-1]) if y.ndim > 1 else y.reshape(-1, 1)
        p = p.reshape(-1, p.shape[-1]) if p.ndim > 1 else p.reshape(-1, 1)
        err = p - y
        stats = dict(
            sum_err2=(err ** 2).sum(0),
            sum_abs_err=np.abs(err).sum(0),
            sum_y=y.sum(0),
            sum_y2=(y ** 2).sum(0),
            sum_p=p.sum(0),
            sum_p2=(p ** 2).sum(0),
            sum_yp=(y * p).sum(0),
        )
        if self.sum_err2 is None:
            for k, v in stats.items():
                setattr(self, k, v)
        else:
            for k, v in stats.items():
                setattr(self, k, getattr(self, k) + v)
        self.n += y.shape[0]

    def merge(self, other: "RegressionEvaluation") -> "RegressionEvaluation":
        if other.sum_err2 is not None:
            if self.sum_err2 is None:
                for k in ("sum_err2", "sum_abs_err", "sum_y", "sum_y2", "sum_p", "sum_p2", "sum_yp"):
                    setattr(self, k, getattr(other, k))
                self.n = other.n
            else:
                for k in ("sum_err2", "sum_abs_err", "sum_y", "sum_y2", "sum_p", "sum_p2", "sum_yp"):
                    setattr(self, k, getattr(self, k) + getattr(other, k))
                self.n += other.n
        return self

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err2[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs_err[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.sum_err2[col] / self.n))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self.sum_y2[col] - self.sum_y[col] ** 2 / self.n
        return float(1.0 - self.sum_err2[col] / ss_tot) if ss_tot > 0 else 0.0
