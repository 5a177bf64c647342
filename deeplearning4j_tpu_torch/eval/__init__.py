"""Evaluation of the port: counterpart of ``deeplearning4j_tpu.eval``."""
from deeplearning4j_tpu_torch.eval.classification import (
    Evaluation, EvaluationBinary, EvaluationCalibration, ROC, ROCBinary,
    ROCMultiClass)
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation

__all__ = ["Evaluation", "EvaluationBinary", "EvaluationCalibration", "ROC",
           "ROCBinary", "ROCMultiClass", "RegressionEvaluation"]
