"""Evaluation metrics.

Copy of ``deeplearning4j_tpu/eval/evaluation.py``: nd4j's ``Evaluation``
(confusion matrix, accuracy/precision/recall/F1), ``EvaluationBinary``
(per-output thresholded counts), ``ROC`` (thresholded AUC),
``ROCMultiClass`` (one-vs-all), ``EvaluationCalibration`` (reliability
diagram, expected calibration error) and ``RegressionEvaluation``
(per-column MSE/MAE/RMSE/R²). All work in host numpy, take tensors on the
card or the CPU (:func:`_to_np` copies them to the host) and merge across
minibatches; ``to_metrics`` exports the ``tdl_eval_*`` gauges
(:func:`eval_metrics`) that a deploy controller's eval gate judges.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _to_np(x):
    if hasattr(x, "detach"):  # a torch tensor, wherever it lives
        return x.detach().cpu().numpy()
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def eval_metrics(registry=None):
    """Get-or-create the offline-eval gauge families.

    One declaration site so eval gates, alert rules and the ``/metrics``
    scrape all see the same numbers an :class:`Evaluation` computed::

        tdl_eval_accuracy{model}    classification accuracy (only
                                    classification sets this gauge)
        tdl_eval_f1{model}          macro-averaged F1 (classification only)
        tdl_eval_score{model}       the headline gate score: accuracy for
                                    classification, R² for regression
    """
    from ..monitoring.registry import get_registry

    r = registry if registry is not None else get_registry()
    return (
        r.gauge("tdl_eval_accuracy",
                "offline-eval classification accuracy by model/candidate",
                labels=("model",)),
        r.gauge("tdl_eval_f1",
                "offline-eval macro F1 by model/candidate",
                labels=("model",)),
        r.gauge("tdl_eval_score",
                "offline-eval headline score by model/candidate (accuracy "
                "for classification, R-squared for regression)",
                labels=("model",)),
    )


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

    def to_metrics(self, registry=None, model: str = "default"
                   ) -> Dict[str, float]:
        """Export this eval's numbers as ``tdl_eval_*`` gauges and return
        them: the same values an eval gate judged are on the ``/metrics``
        scrape, alertable like any other family."""
        acc_g, f1_g, score_g = eval_metrics(registry)
        out = {"accuracy": self.accuracy(), "f1": self.f1(),
               "score": self.accuracy()}
        acc_g.labels(model).set(out["accuracy"])
        f1_g.labels(model).set(out["f1"])
        score_g.labels(model).set(out["score"])
        return out

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


class EvaluationBinary:
    """Per-output independent binary eval (org.nd4j.evaluation.classification
    .EvaluationBinary)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = _to_np(labels), _to_np(predictions)
        pred = (p >= self.threshold).astype(np.int64)
        yb = (y >= 0.5).astype(np.int64)
        m = _to_np(mask).astype(bool) if mask is not None else np.ones_like(yb, dtype=bool)
        axis = 0
        tp = ((pred == 1) & (yb == 1) & m).sum(axis=axis)
        fp = ((pred == 1) & (yb == 0) & m).sum(axis=axis)
        tn = ((pred == 0) & (yb == 0) & m).sum(axis=axis)
        fn = ((pred == 0) & (yb == 1) & m).sum(axis=axis)
        if self.tp is None:
            self.tp, self.fp, self.tn, self.fn = tp, fp, tn, fn
        else:
            self.tp += tp
            self.fp += fp
            self.tn += tn
            self.fn += fn

    def merge(self, other: "EvaluationBinary") -> "EvaluationBinary":
        if other.tp is not None:
            if self.tp is None:
                self.tp, self.fp, self.tn, self.fn = other.tp, other.fp, other.tn, other.fn
            else:
                self.tp += other.tp
                self.fp += other.fp
                self.tn += other.tn
                self.fn += other.fn
        return self

    def accuracy(self):
        tot = self.tp + self.fp + self.tn + self.fn
        return ((self.tp + self.tn) / np.maximum(tot, 1)).astype(float)

    def precision(self):
        return (self.tp / np.maximum(self.tp + self.fp, 1)).astype(float)

    def recall(self):
        return (self.tp / np.maximum(self.tp + self.fn, 1)).astype(float)


class ROC:
    """AUC via thresholded TPR/FPR curve (org.nd4j.evaluation.classification
    .ROC with thresholdSteps; exact mode approximated by many steps)."""

    def __init__(self, threshold_steps: int = 200):
        self.steps = threshold_steps
        self._scores = []
        self._labels = []

    def eval(self, labels, predictions, mask=None) -> None:
        y, p = _to_np(labels).reshape(-1), _to_np(predictions).reshape(-1)
        if mask is not None:
            m = _to_np(mask).reshape(-1).astype(bool)
            y, p = y[m], p[m]
        self._labels.append(y)
        self._scores.append(p)

    def merge(self, other: "ROC") -> "ROC":
        self._labels.extend(other._labels)
        self._scores.extend(other._scores)
        return self

    def calculate_auc(self) -> float:
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        thresholds = np.linspace(0.0, 1.0, self.steps + 1)
        pos = (y >= 0.5).sum()
        neg = len(y) - pos
        if pos == 0 or neg == 0:
            return 0.0
        tpr = [(s[y >= 0.5] >= t).sum() / pos for t in thresholds]
        fpr = [(s[y < 0.5] >= t).sum() / neg for t in thresholds]
        return float(abs(np.trapezoid(tpr, fpr)))

    calculateAUC = calculate_auc


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

    def to_metrics(self, registry=None, model: str = "default"
                   ) -> Dict[str, float]:
        """Export the regression headline as ``tdl_eval_score`` (R² of the
        first column) — the gauge an eval gate and its alerts judge; the
        classification-only accuracy/F1 gauges are left untouched."""
        _, _, score_g = eval_metrics(registry)
        out = {"score": self.r_squared(0)}
        score_g.labels(model).set(out["score"])
        return out


class ROCMultiClass:
    """One-vs-all ROC per class (org.nd4j.evaluation.classification
    .ROCMultiClass): labels one-hot [N, C], predictions probabilities
    [N, C]; per-class AUC + macro average, mergeable across workers."""

    def __init__(self, threshold_steps: int = 200):
        self.steps = threshold_steps
        self._rocs: Dict[int, ROC] = {}

    def eval(self, labels, predictions, mask=None) -> None:
        y = _to_np(labels)
        p = _to_np(predictions)
        if y.ndim == 3:  # DL4J time-series layout [N, C, T] → class axis LAST
            y = np.moveaxis(y, 1, -1)
            p = np.moveaxis(p, 1, -1)
        C = y.shape[-1]
        for c in range(C):
            self._rocs.setdefault(c, ROC(self.steps)).eval(
                y[..., c], p[..., c], mask=mask)

    def merge(self, other: "ROCMultiClass") -> "ROCMultiClass":
        for c, roc in other._rocs.items():
            if c not in self._rocs:
                # fresh accumulator, then merge: aliasing other's ROC would
                # double-count when either side keeps evaling after merge
                self._rocs[c] = ROC(roc.steps)
            self._rocs[c].merge(roc)
        return self

    def calculate_auc(self, class_idx: int) -> float:
        return self._rocs[class_idx].calculate_auc()

    calculateAUC = calculate_auc

    def calculate_average_auc(self) -> float:
        if not self._rocs:
            return 0.0
        return float(np.mean([r.calculate_auc() for r in self._rocs.values()]))

    calculateAverageAUC = calculate_average_auc

    def num_classes(self) -> int:
        return len(self._rocs)


class EvaluationCalibration:
    """Reliability diagram + residual-plot data (org.nd4j.evaluation
    .classification.EvaluationCalibration): bins predicted confidence vs
    observed accuracy; expected calibration error (ECE) summary."""

    def __init__(self, reliability_bins: int = 10):
        self.bins = reliability_bins
        self._counts = np.zeros(reliability_bins, np.int64)
        self._correct = np.zeros(reliability_bins, np.int64)
        self._conf_sum = np.zeros(reliability_bins, np.float64)

    def eval(self, labels, predictions, mask=None) -> None:
        y = _to_np(labels)
        p = _to_np(predictions)
        if y.ndim == 3:  # DL4J time-series layout [N, C, T] → class axis last
            y = np.moveaxis(y, 1, -1)
            p = np.moveaxis(p, 1, -1)
        if mask is not None:
            m = _to_np(mask).astype(bool).reshape(-1)
            y = y.reshape(-1, y.shape[-1])[m]
            p = p.reshape(-1, p.shape[-1])[m]
        else:
            y = y.reshape(-1, y.shape[-1])
            p = p.reshape(-1, p.shape[-1])
        conf = p.max(-1)
        correct = p.argmax(-1) == y.argmax(-1)
        idx = np.clip((conf * self.bins).astype(int), 0, self.bins - 1)
        np.add.at(self._counts, idx, 1)
        np.add.at(self._correct, idx, correct.astype(np.int64))
        np.add.at(self._conf_sum, idx, conf)

    def merge(self, other: "EvaluationCalibration") -> "EvaluationCalibration":
        if self.bins != other.bins:
            raise ValueError(
                f"cannot merge EvaluationCalibration with reliability_bins="
                f"{other.bins} into one with reliability_bins={self.bins}")
        self._counts += other._counts
        self._correct += other._correct
        self._conf_sum += other._conf_sum
        return self

    def reliability_diagram(self):
        """[(bin_center, mean_confidence, observed_accuracy, count)] rows."""
        out = []
        for b in range(self.bins):
            n = int(self._counts[b])
            center = (b + 0.5) / self.bins
            if n == 0:
                out.append((center, center, float("nan"), 0))
            else:
                out.append((center, float(self._conf_sum[b] / n),
                            float(self._correct[b] / n), n))
        return out

    getReliabilityInfo = reliability_diagram

    def expected_calibration_error(self) -> float:
        total = self._counts.sum()
        if total == 0:
            return 0.0
        ece = 0.0
        for b in range(self.bins):
            n = self._counts[b]
            if n:
                acc = self._correct[b] / n
                conf = self._conf_sum[b] / n
                ece += (n / total) * abs(acc - conf)
        return float(ece)
