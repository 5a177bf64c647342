"""Evaluation of the port: counterpart of ``deeplearning4j_tpu.eval``
(``Evaluation``; the ROC, binary, calibration and regression evaluations
wait with ``evaluateROC*`` and ``evaluateRegression``)."""
from deeplearning4j_tpu_torch.eval.classification import Evaluation

__all__ = ["Evaluation"]
