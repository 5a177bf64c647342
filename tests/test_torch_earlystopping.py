"""The port's early stopping (``optim/earlystopping.py``) against the JAX
package's on the CPU.

A small MLP with the reference's weights runs the same
``EarlyStoppingConfiguration`` in each package: the same termination
reason and details, the same best epoch and total epochs, and
``score_vs_epoch`` within relative 1e-5 (f32 sums in another order over a
few epochs of SGD); accuracies exactly. The test also checks that no two
epochs' losses sit within 100 × that row of each other, so no comparison
the trainer makes can flip between the packages. Both savers: ``InMemoryModelSaver``'s
best model is a clone (params and states, no updater state, as the
reference's); ``LocalFileModelSaver``'s ``bestModel.bin`` restores on the
CPU when asked and re-scores its recorded best score within relative
1e-6.
"""
import os

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.data import dataset as j_ds
from deeplearning4j_tpu.data import iterators as j_it
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.optim import earlystopping as j_es
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu_torch.data import dataset as t_ds
from deeplearning4j_tpu_torch.data import iterators as t_it
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.optim import earlystopping as t_es
from deeplearning4j_tpu_torch.optim import updaters as t_upd

J = dict(cfg=j_cfg, L=j_layers, IT=j_inputs.InputType, U=j_upd, es=j_es,
         ds=j_ds, it=j_it, MLN=j_mln.MultiLayerNetwork)
P = dict(cfg=t_cfg, L=t_layers, IT=t_inputs.InputType, U=t_upd, es=t_es,
         ds=t_ds, it=t_it, MLN=t_mln.MultiLayerNetwork)
REL = 1e-5


def conf(ns, lr):
    L = ns["L"]
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(2)
            .updater(ns["U"].Sgd(lr)).weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=16, activation="tanh"))
            .layer(L.DenseLayer(n_out=16, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns["IT"].feed_forward(5)).build())


def arrays(seed, n, noise):
    """A learnable rule on the first two features; held-out labels with
    ``noise`` share drawn at random, so the held-out loss turns up."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    cls = (x[:, 0] > 0).astype(int) + (x[:, 1] > 0.5).astype(int)
    flip = rng.random(n) < noise
    cls[flip] = rng.integers(0, 3, flip.sum())
    return x, np.eye(3, dtype=np.float32)[cls]


def iterators(ns):
    tx, ty = arrays(0, 48, 0.0)
    vx, vy = arrays(1, 24, 0.6)
    train = ns["it"].ListDataSetIterator(
        [ns["ds"].DataSet(tx[i:i + 12], ty[i:i + 12]) for i in range(0, 48, 12)])
    held = ns["it"].ListDataSetIterator(
        [ns["ds"].DataSet(vx[i:i + 12], vy[i:i + 12]) for i in range(0, 24, 12)])
    return train, held


def nets(lr):
    ref = J["MLN"](conf(J, lr)).init()
    net = P["MLN"](conf(P, lr), device="cpu").init()
    net.set_param_tree(jax.tree.map(np.asarray, ref.param_tree()))
    net.set_updater_state_from_jax(jax.tree.map(np.asarray, ref._opt_state))
    return ref, net


def setups(ns, case, directory):
    es = ns["es"]
    train, held = iterators(ns)
    b = es.EarlyStoppingConfiguration.Builder()
    if case == "improvement":
        b.score_calculator(es.DataSetLossCalculator(held))
        b.epoch_termination_conditions(
            es.ScoreImprovementEpochTerminationCondition(2),
            es.MaxEpochsTerminationCondition(30))
        b.model_saver(es.InMemoryModelSaver())
    elif case == "max_epochs":
        b.score_calculator(es.DataSetLossCalculator(held, average=False))
        b.epoch_termination_conditions(es.MaxEpochsTerminationCondition(4))
        b.model_saver(es.LocalFileModelSaver(directory)).save_last_model()
    elif case == "accuracy":
        b.score_calculator(es.ClassificationScoreCalculator(held))
        b.epoch_termination_conditions(
            es.BestScoreEpochTerminationCondition(0.4),
            es.MaxEpochsTerminationCondition(10))
        b.evaluate_every_n_epochs(2)
    else:                                    # an exploding score
        b.score_calculator(es.DataSetLossCalculator(held))
        b.epoch_termination_conditions(es.MaxEpochsTerminationCondition(5))
        b.iteration_termination_conditions(
            es.MaxScoreIterationTerminationCondition(0.9))
    return b.build(), train


CASES = {"improvement": 0.5, "max_epochs": 0.2, "accuracy": 0.2,
         "max_score": 0.05}


@pytest.mark.parametrize("case", sorted(CASES))
def test_early_stopping_runs_as_the_reference(tmp_path, case):
    ref, net = nets(CASES[case])
    results = {}
    for pkg, ns, model in (("jax", J, ref), ("port", P, net)):
        d = str(tmp_path / pkg)
        cfg, train = setups(ns, case, d)
        trainer = (ns["es"].EarlyStoppingGraphTrainer
                   if pkg == "port" and case == "accuracy"
                   else ns["es"].EarlyStoppingTrainer)(cfg, model, train)
        results[pkg] = (trainer.fit(), cfg)
    (j, _), (t, t_cfg_) = results["jax"], results["port"]
    assert t.termination_reason == j.termination_reason
    assert t.termination_details == j.termination_details
    assert t.best_model_epoch == j.best_model_epoch
    assert t.total_epochs == j.total_epochs
    assert sorted(t.score_vs_epoch) == sorted(j.score_vs_epoch)
    for e, s in j.score_vs_epoch.items():
        assert abs(t.score_vs_epoch[e] - s) <= REL * max(1.0, abs(s)), e
    if case == "accuracy":      # a share of 24 examples: exact or not at all
        assert t.score_vs_epoch == j.score_vs_epoch
    else:
        scores = sorted(j.score_vs_epoch.values())
        assert all(b - a > 100 * REL * max(1.0, abs(b))
                   for a, b in zip(scores, scores[1:]))
    if j.best_model_score is not None:
        assert abs(t.best_model_score - j.best_model_score) <= \
            REL * max(1.0, abs(j.best_model_score))
    want = {"improvement": ("EpochTerminationCondition",
                            "ScoreImprovementEpochTerminationCondition"),
            "max_epochs": ("MaxEpochs", "MaxEpochsTerminationCondition"),
            "accuracy": ("EpochTerminationCondition",
                         "BestScoreEpochTerminationCondition"),
            "max_score": ("IterationTerminationCondition",
                          "MaxScoreIterationTerminationCondition")}[case]
    assert (t.termination_reason, t.termination_details) == want
    best = t.get_best_model()
    if case == "max_score":
        assert best is net and t.best_model_score is None
    elif case == "max_epochs":
        assert best.device.type == "cpu"
        saver = t_cfg_.model_saver
        assert os.path.exists(os.path.join(saver.directory, "bestModel.bin"))
        latest = saver.get_latest_model()
        assert latest._iteration == net._iteration
        _, held = iterators(P)
        rescored = t_es.DataSetLossCalculator(
            held, average=False).calculate_score(best)
        assert abs(rescored - t.best_model_score) <= 1e-6 * abs(
            t.best_model_score)
    else:
        # an in-memory best is a clone: params and states, a fresh
        # updater state, no frozen set (the reference's clone)
        assert best is not net and best.device.type == "cpu"
        assert best._opt_state is not None and not best._frozen


def test_local_saver_restores_where_the_net_was_saved(tmp_path):
    """The saver that wrote a model restores it onto the saved net's
    device; a saver that did not (a later process on the same directory)
    restores onto the card; a call that names a device wins."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU contract does not apply")
    _, net = nets(0.1)
    saver = t_es.LocalFileModelSaver(str(tmp_path))
    saver.save_best_model(net, 1.0)
    assert saver.get_best_model().device.type == "cpu"
    later = t_es.LocalFileModelSaver(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        later.get_best_model()
    assert later.get_best_model(device="cpu").device.type == "cpu"


def test_max_time_condition_and_builder_aliases():
    cond = t_es.MaxTimeIterationTerminationCondition(0.0)
    cond.initialize()
    assert cond.terminate(1.0)
    b = t_es.EarlyStoppingConfiguration.Builder()
    cfg = (b.scoreCalculator(t_es.DataSetLossCalculator([]))
           .epochTerminationConditions(t_es.MaxEpochsTerminationCondition(1))
           .evaluateEveryNEpochs(3).build())
    assert cfg.evaluate_every_n_epochs == 3
    assert isinstance(cfg.model_saver, t_es.InMemoryModelSaver)
    with pytest.raises(ValueError, match="empty"):
        cfg.score_calculator.calculate_score(None)
