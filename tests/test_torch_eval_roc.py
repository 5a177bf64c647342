"""The port's ROC family, binary, calibration and regression evaluations
against the JAX package's on the CPU.

On the same numpy arrays every metric agrees to 1e-12 (the same numpy
code; both take tensors or arrays). The nets' ``evaluateROC``,
``evaluateROCMultiClass`` and ``evaluateRegression`` are held against the
reference nets carrying the same weights: the AUCs to 1e-12 (an exact
ROC depends on the scores' order only, and the test checks that the
port's outputs sort as the reference's), the regression metrics within
relative 1e-5 (f32 outputs, float64 sums).
"""
import numpy as np
import pytest

import torch

from deeplearning4j_tpu.data import dataset as j_ds
from deeplearning4j_tpu.data import iterators as j_it
from deeplearning4j_tpu.eval import classification as jc
from deeplearning4j_tpu.eval import regression as jr
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu_torch.data import dataset as t_ds
from deeplearning4j_tpu_torch.data import iterators as t_it
from deeplearning4j_tpu_torch.eval import classification as tc
from deeplearning4j_tpu_torch.eval import regression as tr
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.optim import updaters as t_upd

EXACT = 1e-12


def _arrays(seed, n=64, c=4, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c))
    if ties:
        logits = np.round(logits, 1)
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    y = np.eye(c)[rng.integers(0, c, n)]
    return y.astype(np.float32), p.astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_roc_family_matches_reference(ties, as_tensor):
    batches = [_arrays(s, ties=ties) for s in range(3)]
    wrap = (lambda a: torch.as_tensor(a)) if as_tensor else (lambda a: a)
    t_roc, j_roc = tc.ROCMultiClass(), jc.ROCMultiClass()
    t_bin, j_bin = tc.ROCBinary(), jc.ROCBinary()
    t_two, j_two = tc.ROC(), jc.ROC()
    for y, p in batches:
        t_roc.eval(wrap(y), wrap(p))
        j_roc.eval(y, p)
        t_bin.eval(wrap(y), wrap(p))
        j_bin.eval(y, p)
        y2 = np.stack([1 - y[:, 0], y[:, 0]], 1)
        p2 = np.stack([1 - p[:, 0], p[:, 0]], 1)
        t_two.eval(wrap(y2), wrap(p2))
        j_two.eval(y2, p2)
    for c in range(4):
        assert abs(t_roc.calculate_auc(c) - j_roc.calculate_auc(c)) <= EXACT
        assert abs(t_bin.calculate_auprc(c)
                   - j_bin.calculate_auprc(c)) <= EXACT
    assert abs(t_roc.average_auc() - j_roc.average_auc()) <= EXACT
    assert t_bin.num_labels() == j_bin.num_labels() == 4
    assert abs(t_two.calculate_auc() - j_two.calculate_auc()) <= EXACT
    assert abs(t_two.calculate_auprc() - j_two.calculate_auprc()) <= EXACT
    assert 0.0 < t_two.calculate_auc() < 1.0


def test_roc_edge_cases_match_reference():
    for y, p in ((np.ones(5), np.linspace(0, 1, 5)),
                 (np.zeros(5), np.linspace(0, 1, 5)),
                 (np.array([0, 1, 0, 1.0]), np.array([.1, .9, .2, .8]))):
        t, j = tc.ROC().eval(y, p), jc.ROC().eval(y, p)
        assert t.calculate_auc() == j.calculate_auc()
        assert t.calculate_auprc() == j.calculate_auprc()
    b = tc.ROCBinary().eval(np.array([0, 1, 1.0]), np.array([.3, .6, .2]))
    jb = jc.ROCBinary().eval(np.array([0, 1, 1.0]), np.array([.3, .6, .2]))
    assert b.num_labels() == 1 and b.calculateAUC(0) == jb.calculateAUC(0)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_evaluation_binary_matches_reference(threshold):
    rng = np.random.default_rng(1)
    t, j = tc.EvaluationBinary(threshold), jc.EvaluationBinary(threshold)
    for _ in range(3):
        y = (rng.random((20, 5)) > 0.5).astype(np.float32)
        p = rng.random((20, 5)).astype(np.float32)
        t.eval(torch.as_tensor(y), torch.as_tensor(p))
        j.eval(y, p)
    for o in range(5):
        for m in ("accuracy", "precision", "recall", "f1"):
            assert abs(getattr(t, m)(o) - getattr(j, m)(o)) <= EXACT, (m, o)


@pytest.mark.parametrize("bins", [10, 7])
def test_evaluation_calibration_matches_reference(bins):
    t, j = tc.EvaluationCalibration(bins), jc.EvaluationCalibration(bins)
    for s in range(3):
        y, p = _arrays(10 + s)
        t.eval(torch.as_tensor(y), torch.as_tensor(p))
        j.eval(y, p)
    for a, b in zip(t.reliability(), j.reliability()):
        np.testing.assert_allclose(a, b, rtol=0, atol=EXACT)
    assert abs(t.expected_calibration_error()
               - j.expected_calibration_error()) <= EXACT


@pytest.mark.parametrize("shape", [(30,), (30, 3), (6, 5, 2)],
                         ids=["1d", "2d", "time_series"])
def test_regression_evaluation_matches_reference(shape):
    rng = np.random.default_rng(2)
    t, j = tr.RegressionEvaluation(), jr.RegressionEvaluation()
    for _ in range(2):
        y = rng.standard_normal(shape).astype(np.float32)
        p = (y + 0.3 * rng.standard_normal(shape)).astype(np.float32)
        t.eval(torch.as_tensor(y), torch.as_tensor(p))
        j.eval(y, p)
    assert t.num_columns == j.num_columns
    for c in range(t.num_columns):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "r_squared",
                  "pearson_correlation"):
            assert abs(getattr(t, m)(c) - getattr(j, m)(c)) <= EXACT, (m, c)
    assert abs(t.average_mean_squared_error()
               - j.average_mean_squared_error()) <= EXACT
    assert t.stats() == j.stats()


# ------------------------------------------------------------ the nets'
def _conf(ns, n_out, act, loss):
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(4)
            .updater(ns["U"].Sgd(0.1)).list()
            .layer(ns["L"].DenseLayer(n_out=16, activation="tanh"))
            .layer(ns["L"].OutputLayer(n_out=n_out, activation=act,
                                       loss_function=loss))
            .set_input_type(ns["IT"].feed_forward(6)).build())


J = dict(cfg=j_cfg, L=j_layers, U=j_upd, IT=j_inputs.InputType)
P = dict(cfg=t_cfg, L=t_layers, U=t_upd, IT=t_inputs.InputType)
HEADS = {"roc": (2, "softmax", "mcxent"), "multiclass": (4, "softmax",
                                                         "mcxent"),
         "regression": (3, "identity", "mse")}


def _nets(kind):
    import jax
    ref = j_mln.MultiLayerNetwork(_conf(J, *HEADS[kind])).init()
    net = t_mln.MultiLayerNetwork(_conf(P, *HEADS[kind]), device="cpu").init()
    net.set_param_tree(jax.tree.map(np.asarray, ref.param_tree()))
    return ref, net


def _batches(kind, n_out, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = rng.standard_normal((40, 6)).astype(np.float32)
        y = (rng.standard_normal((40, n_out)).astype(np.float32)
             if kind == "regression"
             else np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, 40)])
        out.append((x, y))
    return out


def _order(outs):
    """Each column's stable descending sort order over all batches."""
    cat = np.concatenate(outs)
    return [np.argsort(-cat[:, c], kind="stable") for c in range(cat.shape[1])]


@pytest.mark.parametrize("kind", sorted(HEADS))
def test_nets_evaluate_roc_and_regression_as_the_reference(kind):
    ref, net = _nets(kind)
    batches = _batches(kind, HEADS[kind][0])
    t_iter = t_it.ListDataSetIterator([t_ds.DataSet(x, y)
                                       for x, y in batches])
    j_iter = j_it.ListDataSetIterator([j_ds.DataSet(x, y)
                                       for x, y in batches])
    if kind == "regression":
        t, j = net.evaluateRegression(t_iter), ref.evaluateRegression(j_iter)
        for c in range(3):
            for m in ("mean_squared_error", "mean_absolute_error",
                      "r_squared", "pearson_correlation"):
                a, b = getattr(t, m)(c), getattr(j, m)(c)
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (m, c)
        return
    j_outs = [np.asarray(ref.output(x).toNumpy()) for x, _ in batches]
    t_outs = [net.output(x).numpy() for x, _ in batches]
    for a, b in zip(_order(t_outs), _order(j_outs)):
        np.testing.assert_array_equal(a, b)
    if kind == "roc":
        t, j = net.evaluateROC(t_iter), ref.evaluateROC(j_iter)
        assert abs(t.calculate_auc() - j.calculate_auc()) <= EXACT
        assert abs(t.calculate_auprc() - j.calculate_auprc()) <= EXACT
    else:
        t = net.evaluateROCMultiClass(t_iter)
        j = ref.evaluateROCMultiClass(j_iter)
        for c in range(4):
            assert abs(t.calculate_auc(c) - j.calculate_auc(c)) <= EXACT
        assert abs(t.average_auc() - j.average_auc()) <= EXACT


def test_graph_evaluates_roc_multiclass_on_its_first_output():
    g = (t_cfg.NeuralNetConfiguration.builder().seed(2)
         .updater(t_upd.Sgd(0.1)).graph_builder().add_inputs("in")
         .set_input_types(t_inputs.InputType.feed_forward(6))
         .add_layer("d", t_layers.DenseLayer(n_out=8, activation="tanh"),
                    "in")
         .add_layer("o", t_layers.OutputLayer(n_out=4, activation="softmax",
                                              loss_function="mcxent"), "d")
         .set_outputs("o").build())
    net = t_graph.ComputationGraph(g, device="cpu").init()
    batches = _batches("multiclass", 4)
    roc = net.evaluateROCMultiClass(t_it.ListDataSetIterator(
        [t_ds.DataSet(x, y) for x, y in batches]))
    want = tc.ROCMultiClass()
    for x, y in batches:
        want.eval(y, net.output(x))
    assert roc.average_auc() == want.average_auc()
