"""The port's ``Evaluation`` (a copy of the JAX package's host numpy code)
against the reference on the same labels and predictions: the confusion
matrix exactly, every metric to f64 rounding (rtol 1e-12). Predictions
come as torch tensors on the port's side, numpy on the reference's."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.eval.classification import Evaluation as JEval
from deeplearning4j_tpu_torch.eval.classification import Evaluation as TEval


@pytest.mark.parametrize("top_n,masked", [(1, False), (3, False), (1, True)])
def test_evaluation_matches_reference(top_n, masked):
    rng = np.random.default_rng(0)
    n, c = 200, 6
    labels = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    logits = rng.standard_normal((n, c)).astype(np.float32) + 2 * labels
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = (rng.uniform(size=n) > 0.3).astype(np.float32) if masked else None
    j, t = JEval(top_n=top_n), TEval(top_n=top_n)
    for lo in range(0, n, 64):       # several batches accumulate
        sl = slice(lo, lo + 64)
        j.eval(labels[sl], probs[sl], mask=None if mask is None else mask[sl])
        t.eval(torch.from_numpy(labels[sl]), torch.from_numpy(probs[sl]),
               mask=None if mask is None else torch.from_numpy(mask[sl]))
    np.testing.assert_array_equal(t.confusion_matrix(), j.confusion_matrix())
    for fn in ("accuracy", "precision", "recall", "f1", "topNAccuracy"):
        np.testing.assert_allclose(getattr(t, fn)(), getattr(j, fn)(),
                                   rtol=1e-12)
    for cls in range(c):
        np.testing.assert_allclose(t.f1(cls), j.f1(cls), rtol=1e-12)
        np.testing.assert_allclose(t.matthews_correlation(cls),
                                   j.matthews_correlation(cls), rtol=1e-12)
    assert t.stats() == j.stats()
