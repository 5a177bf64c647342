"""Regression evaluation: counterpart of
``deeplearning4j_tpu/eval/regression.py``, analog of
``org.nd4j.evaluation.regression.RegressionEvaluation`` (MSE/MAE/RMSE/
RSE/PC/R² per column). Host-side float64 numpy sums; inputs accept
torch tensors (on any device, one copy to the host each) and numpy
arrays."""
from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.eval.classification import _np


class RegressionEvaluation:
    def __init__(self, num_columns: Optional[int] = None):
        self.num_columns = num_columns
        self._sum_sq_err = None
        self._sum_abs_err = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_pred_sq = None
        self._sum_label_pred = None
        self._n = 0

    def eval(self, labels, predictions):
        y = _np(labels).astype(np.float64)
        p = _np(predictions).astype(np.float64)
        if y.ndim == 3:
            y = y.reshape(-1, y.shape[-1])
            p = p.reshape(-1, p.shape[-1])
        if y.ndim == 1:
            y, p = y[:, None], p[:, None]
        if self._sum_sq_err is None:
            self.num_columns = y.shape[-1]
            z = np.zeros(self.num_columns)
            (self._sum_sq_err, self._sum_abs_err, self._sum_label,
             self._sum_label_sq, self._sum_pred, self._sum_pred_sq,
             self._sum_label_pred) = (z.copy() for _ in range(7))
        err = p - y
        self._sum_sq_err += (err ** 2).sum(0)
        self._sum_abs_err += np.abs(err).sum(0)
        self._sum_label += y.sum(0)
        self._sum_label_sq += (y ** 2).sum(0)
        self._sum_pred += p.sum(0)
        self._sum_pred_sq += (p ** 2).sum(0)
        self._sum_label_pred += (y * p).sum(0)
        self._n += y.shape[0]
        return self

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_sq_err[col] / self._n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs_err[col] / self._n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self._sum_label_sq[col] - self._sum_label[col] ** 2 / self._n
        return float(1.0 - self._sum_sq_err[col] / ss_tot) if ss_tot else 0.0

    def pearson_correlation(self, col: int = 0) -> float:
        n = self._n
        cov = (self._sum_label_pred[col]
               - self._sum_label[col] * self._sum_pred[col] / n)
        var_y = self._sum_label_sq[col] - self._sum_label[col] ** 2 / n
        var_p = self._sum_pred_sq[col] - self._sum_pred[col] ** 2 / n
        denom = np.sqrt(var_y * var_p)
        return float(cov / denom) if denom else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sum_sq_err) / self._n)

    def average_mean_absolute_error(self) -> float:
        return float(np.mean(self._sum_abs_err) / self._n)

    def stats(self) -> str:
        cols = range(self.num_columns)
        lines = ["Column    MSE          MAE          RMSE         R^2"
                 "          PC"]
        for c in cols:
            lines.append(f"{c:<8}{self.mean_squared_error(c):<13.6g}"
                         f"{self.mean_absolute_error(c):<13.6g}"
                         f"{self.root_mean_squared_error(c):<13.6g}"
                         f"{self.r_squared(c):<13.6g}"
                         f"{self.pearson_correlation(c):<13.6g}")
        return "\n".join(lines)

    # camelCase parity
    meanSquaredError = mean_squared_error
    meanAbsoluteError = mean_absolute_error
    rootMeanSquaredError = root_mean_squared_error
    rSquared = r_squared
    pearsonCorrelation = pearson_correlation
