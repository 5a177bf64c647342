"""Classification evaluation: the ``Evaluation`` of
``deeplearning4j_tpu/eval/classification.py``, analog of
``org.nd4j.evaluation.classification.Evaluation`` (accuracy / precision /
recall / F1 / confusion matrix / top-N), ``ROC``, ``ROCMultiClass``,
``ROCBinary``, ``EvaluationBinary`` and ``EvaluationCalibration``.

Host-side numpy accumulation; inputs accept torch tensors (on any
device) and numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray


def _np(x):
    if x is None:
        return None
    if isinstance(x, NDArray):
        x = x.buf()
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.is_floating_point() and t.dtype != torch.float64:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(x)


class Evaluation:
    """Multi-class classification metrics (ref: Evaluation)."""

    def __init__(self, num_classes: Optional[int] = None, labels_names=None,
                 top_n: int = 1):
        self.num_classes = num_classes
        self.labels_names = labels_names
        self._cm: Optional[np.ndarray] = None
        # ref: Evaluation(int topN) — top-N accuracy alongside top-1
        self.top_n = int(top_n)
        self._topn_hits = 0
        self._topn_total = 0

    def _ensure(self, n):
        if self._cm is None:
            self.num_classes = self.num_classes or n
            self._cm = np.zeros((self.num_classes, self.num_classes), dtype=np.int64)

    def topNAccuracy(self) -> float:
        """ref: Evaluation#topNAccuracy (0.0 when top_n == 1 unused)."""
        if self._topn_total == 0:
            return 0.0
        return self._topn_hits / self._topn_total

    top_n_accuracy = topNAccuracy

    def eval(self, labels, predictions, mask=None):
        """labels: one-hot or int; predictions: probabilities or int classes.
        Rank-3 (N,T,C) inputs flatten over time with optional mask (ref:
        evalTimeSeries)."""
        y, p, m = _np(labels), _np(predictions), _np(mask)
        if y.ndim == 3:  # time series
            n, t = y.shape[:2]
            y = y.reshape(n * t, -1)
            p = p.reshape(n * t, -1)
            m = m.reshape(n * t) if m is not None else None
        y_idx = y.argmax(-1) if y.ndim > 1 and y.shape[-1] > 1 else y.astype(int).ravel()
        p_idx = p.argmax(-1) if p.ndim > 1 and p.shape[-1] > 1 else p.astype(int).ravel()
        if self.top_n > 1:
            if p.ndim > 1 and p.shape[-1] > 1:
                kn = min(self.top_n, p.shape[-1])
                topk = np.argpartition(-p, kn - 1, axis=-1)[:, :kn]
                hits = (topk == y_idx[:, None]).any(axis=1)
            else:
                # integer-class predictions carry no ranking: top-N
                # degrades to top-1 so the denominator tracks accuracy's
                hits = (p_idx == y_idx)
            if m is not None:
                hits = hits[m.astype(bool).ravel()]
            self._topn_hits += int(hits.sum())
            self._topn_total += int(hits.shape[0])
        n_cls = max(y.shape[-1] if y.ndim > 1 else y_idx.max() + 1,
                    p.shape[-1] if p.ndim > 1 else p_idx.max() + 1)
        self._ensure(int(n_cls))
        if m is not None:
            keep = m.astype(bool).ravel()
            y_idx, p_idx = y_idx[keep], p_idx[keep]
        np.add.at(self._cm, (y_idx, p_idx), 1)
        return self

    # ------------------------------------------------------------- metrics
    def confusion_matrix(self) -> np.ndarray:
        return self._cm

    def accuracy(self) -> float:
        total = self._cm.sum()
        return float(np.trace(self._cm) / total) if total else 0.0

    def _tp(self, c):
        return self._cm[c, c]

    def _fp(self, c):
        return self._cm[:, c].sum() - self._cm[c, c]

    def _fn(self, c):
        return self._cm[c, :].sum() - self._cm[c, c]

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fp(cls)
            return float(self._tp(cls) / denom) if denom else 0.0
        vals = [self.precision(c) for c in range(self.num_classes) if self._cm[c, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fn(cls)
            return float(self._tp(cls) / denom) if denom else 0.0
        vals = [self.recall(c) for c in range(self.num_classes) if self._cm[c, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        tn = self._cm.sum() - self._cm[cls, :].sum() - self._fp(cls)
        denom = self._fp(cls) + tn
        return float(self._fp(cls) / denom) if denom else 0.0

    def matthews_correlation(self, cls: int) -> float:
        tp, fp, fn = self._tp(cls), self._fp(cls), self._fn(cls)
        tn = self._cm.sum() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    def stats(self) -> str:
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes: {self.num_classes}",
            f" Accuracy:  {self.accuracy():.4f}",
            *([f" Top {self.top_n} Accuracy: {self.topNAccuracy():.4f}"]
              if self.top_n > 1 else []),
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "",
            "=========================Confusion Matrix=========================",
            str(self._cm),
        ]
        return "\n".join(lines)

    # camelCase parity
    confusionMatrix = confusion_matrix
    falsePositiveRate = false_positive_rate


#: the trapezoid rule (``np.trapz`` before numpy 2.0)
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class ROC:
    """Binary ROC/AUC with exact thresholds (ref: org.nd4j.evaluation.ROC
    with thresholdSteps=0 → exact mode)."""

    def __init__(self):
        self._scores = []
        self._labels = []

    def eval(self, labels, predictions):
        y, p = _np(labels), _np(predictions)
        if y.ndim > 1 and y.shape[-1] == 2:
            y = y[..., 1]
            p = p[..., 1]
        self._labels.append(y.ravel())
        self._scores.append(p.ravel())
        return self

    def _sorted(self):
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        order = np.argsort(-s, kind="stable")
        return y[order], s[order]

    def calculate_auc(self) -> float:
        y, _ = self._sorted()
        pos = y.sum()
        neg = len(y) - pos
        if pos == 0 or neg == 0:
            return 0.5
        tps = np.cumsum(y)
        fps = np.cumsum(1 - y)
        tpr = np.concatenate([[0], tps / pos])
        fpr = np.concatenate([[0], fps / neg])
        return float(_trapezoid(tpr, fpr))

    def calculate_auprc(self) -> float:
        y, _ = self._sorted()
        pos = y.sum()
        if pos == 0:
            return 0.0
        tps = np.cumsum(y)
        precision = tps / np.arange(1, len(y) + 1)
        recall = tps / pos
        return float(_trapezoid(precision, recall))

    calculateAUC = calculate_auc
    calculateAUCPR = calculate_auprc


class ROCMultiClass:
    """One-vs-all ROC per class (ref: ROCMultiClass)."""

    def __init__(self):
        self._rocs = {}

    def eval(self, labels, predictions):
        y, p = _np(labels), _np(predictions)
        for c in range(y.shape[-1]):
            self._rocs.setdefault(c, ROC()).eval(y[..., c], p[..., c])
        return self

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs.values()]))

    calculateAUC = calculate_auc
    calculateAverageAUC = average_auc


class ROCBinary(ROCMultiClass):
    """Per-output binary ROC for multi-label sigmoid outputs (ref:
    org.nd4j.evaluation.classification.ROCBinary). Same per-column
    accumulation as ROCMultiClass (one-vs-all ≡ independent binary outputs);
    adds 1-D promotion, num_labels and per-output AUPRC."""

    def eval(self, labels, predictions):
        y, p = _np(labels), _np(predictions)
        if y.ndim == 1:
            y, p = y[:, None], p[:, None]
        return super().eval(y, p)

    def num_labels(self) -> int:
        return len(self._rocs)

    def calculate_auprc(self, output: int) -> float:
        return self._rocs[output].calculate_auprc()

    calculateAUCPR = calculate_auprc


class EvaluationBinary:
    """Per-output binary metrics for multi-label sigmoid outputs
    (ref: EvaluationBinary)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self._tp = self._fp = self._tn = self._fn = None

    def eval(self, labels, predictions):
        y, p = _np(labels), _np(predictions)
        pred = (p >= self.threshold).astype(int)
        y = y.astype(int)
        if self._tp is None:
            n = y.shape[-1]
            self._tp = np.zeros(n, np.int64)
            self._fp = np.zeros(n, np.int64)
            self._tn = np.zeros(n, np.int64)
            self._fn = np.zeros(n, np.int64)
        self._tp += ((pred == 1) & (y == 1)).sum(0)
        self._fp += ((pred == 1) & (y == 0)).sum(0)
        self._tn += ((pred == 0) & (y == 0)).sum(0)
        self._fn += ((pred == 0) & (y == 1)).sum(0)
        return self

    def accuracy(self, out: int) -> float:
        total = self._tp[out] + self._fp[out] + self._tn[out] + self._fn[out]
        return float((self._tp[out] + self._tn[out]) / total) if total else 0.0

    def precision(self, out: int) -> float:
        d = self._tp[out] + self._fp[out]
        return float(self._tp[out] / d) if d else 0.0

    def recall(self, out: int) -> float:
        d = self._tp[out] + self._fn[out]
        return float(self._tp[out] / d) if d else 0.0

    def f1(self, out: int) -> float:
        p, r = self.precision(out), self.recall(out)
        return 2 * p * r / (p + r) if (p + r) else 0.0


class EvaluationCalibration:
    """Reliability/calibration histograms (ref: EvaluationCalibration)."""

    def __init__(self, bins: int = 10):
        self.bins = bins
        self._counts = np.zeros(bins, np.int64)
        self._correct = np.zeros(bins, np.int64)
        self._conf_sum = np.zeros(bins, np.float64)

    def eval(self, labels, predictions):
        y, p = _np(labels), _np(predictions)
        y_idx = y.argmax(-1).ravel()
        p_idx = p.argmax(-1).ravel()
        conf = p.max(-1).ravel()
        b = np.clip((conf * self.bins).astype(int), 0, self.bins - 1)
        np.add.at(self._counts, b, 1)
        np.add.at(self._correct, b, (y_idx == p_idx).astype(int))
        np.add.at(self._conf_sum, b, conf)
        return self

    def reliability(self):
        """(bin_confidence, bin_accuracy, bin_count) triples."""
        with np.errstate(invalid="ignore"):
            acc = np.where(self._counts > 0,
                           self._correct / np.maximum(self._counts, 1), 0.0)
            conf = np.where(self._counts > 0,
                            self._conf_sum / np.maximum(self._counts, 1), 0.0)
        return conf, acc, self._counts

    def expected_calibration_error(self) -> float:
        conf, acc, counts = self.reliability()
        total = counts.sum()
        if total == 0:
            return 0.0
        return float(np.sum(counts / total * np.abs(conf - acc)))
