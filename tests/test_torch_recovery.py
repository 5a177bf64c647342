"""The port's ``ResilientTrainer``, ``SkippingIterator``,
``newest_checkpoint`` and ``utils/preemption`` against the JAX package's.

Each scenario of the reference's own tests (``tests/test_resilience.py``'s
recovery and preemption tests) runs in both packages on the same MLP (4 →
16 → 3, Adam 1e-2; the port carrying the JAX net's initial weights) over
the same batches under the same fault plan: restarts, the iteration
count, the quarantined positions, the restore / quarantine / restart /
step-failure counters and the resilience events are equal; the final
params and Adam's leaves agree within f32's row (atol 1e-5); a disturbed
port run equals an undisturbed one bitwise where the reference's test
asks it of the reference. ``chip_smoke.py``'s healing drill runs here at
LeNet size in both packages with its iteration-keyed plan. ``elastic=True``
raises, naming ROADMAP queue 1 item 7.
"""
import os
import time
import zipfile

import numpy as np
import pytest

import jax

import chip_smoke
from deeplearning4j_tpu.data import dataset as j_ds
from deeplearning4j_tpu.data import iterators as j_it
from deeplearning4j_tpu.optim import listeners as j_lst
from deeplearning4j_tpu.resilience import recovery as j_rec
from deeplearning4j_tpu.utils import preemption as j_pre
from deeplearning4j_tpu_torch.data import dataset as t_ds
from deeplearning4j_tpu_torch.data import iterators as t_it
from deeplearning4j_tpu_torch.optim import listeners as t_lst
from deeplearning4j_tpu_torch.optim import transforms as T
from deeplearning4j_tpu_torch.resilience import recovery as t_rec
from deeplearning4j_tpu_torch.utils import preemption as t_pre

from _torch_scoring import (BOTH, JAX, TORCH, reset_all, series,
                            teardown_all, to_numpy_tree)

for _pkg, _ds, _itm, _lst, _rec, _pre in (
        (JAX, j_ds, j_it, j_lst, j_rec, j_pre),
        (TORCH, t_ds, t_it, t_lst, t_rec, t_pre)):
    _pkg.ds, _pkg.it, _pkg.lst, _pkg.rec, _pkg.pre = (_ds, _itm, _lst,
                                                      _rec, _pre)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    teardown_all()


def mlp_conf(ns, seed=7):
    """The reference tests' ``_mlp_conf``."""
    return (ns.cfg.NeuralNetConfiguration.builder()
            .seed(seed).updater(ns.U.Adam(1e-2)).list()
            .layer(ns.L.DenseLayer(n_in=4, n_out=16, activation="relu"))
            .layer(ns.L.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                    loss_function="mcxent"))
            .build())


_INIT = {}


def mlp(pkg):
    """A fresh MLP in ``pkg``, from the one JAX initialization."""
    if "params" not in _INIT:
        _INIT["params"] = to_numpy_tree(
            JAX.MLN(mlp_conf(JAX)).init()._params)
    if pkg is JAX:
        return JAX.MLN(mlp_conf(JAX)).init()      # the same seeded init
    net = TORCH.MLN(mlp_conf(TORCH), device="cpu").init()
    net.set_param_tree(_INIT["params"])
    return net


def data(n=32, seed=0):
    """The reference tests' ``_data``."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype("f4")
    y = np.eye(3, dtype="f4")[rng.randint(0, 3, n)]
    return x, y


def params(pkg, net):
    if pkg is JAX:
        return to_numpy_tree(net._params)
    return {k: {p: v.numpy() for p, v in d.items()}
            for k, d in net._params.items()}


def updater_leaves(pkg, net):
    if pkg is JAX:
        return [np.asarray(a) for a in jax.tree.leaves(net._opt_state)]
    return [np.asarray(a) if isinstance(a, int) else a.numpy()
            for a in T.state_leaves(net._opt_state)]


def observe(pkg, net, rt=None):
    """Everything a scenario must agree on, besides params."""
    return {
        "restarts": None if rt is None else rt.restarts,
        "iteration": net._iteration,
        "counters": {n: series(pkg, n) for n in (
            "dl4j_checkpoint_restores_total", "dl4j_data_quarantined_total",
            "dl4j_resilience_restarts_total",
            "dl4j_training_step_failures_total",
            "dl4j_training_epochs_total")},
        "events": [e["category"] for e in pkg.faults.events()],
    }


def assert_same_state(got, want):
    """Port and reference nets after a scenario: params and updater
    leaves within ATOL."""
    (tp, tu), (jp, ju) = got, want
    assert sorted(tp) == sorted(jp)
    for k in jp:
        for p in jp[k]:
            np.testing.assert_allclose(tp[k][p], jp[k][p], atol=ATOL,
                                       err_msg=f"{k}/{p}")
    assert len(tu) == len(ju)
    for i, (a, b) in enumerate(zip(tu, ju)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), atol=ATOL,
                                   err_msg=f"updater leaf {i}")


def both(run):
    """``run(pkg, tmpdir)`` in each package; returns their observations
    and asserts the nets agree."""
    import tempfile
    seen, states = {}, {}
    for pkg in BOTH:
        with tempfile.TemporaryDirectory() as tmp:
            net, obs = run(pkg, tmp)
        seen[pkg.name] = obs
        states[pkg.name] = (params(pkg, net), updater_leaves(pkg, net))
    assert_same_state(states["torch"], states["jax"])
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def plan(pkg, *specs, seed=1):
    return pkg.faults.FaultPlan([pkg.faults.FaultSpec(*a, **k)
                                 for a, k in specs], seed=seed)


# ---------------------------------------------------------- scenarios
def test_crash_restores_to_the_unfaulted_params():
    def run(pkg, tmp):
        x, y = data(32)
        ref = mlp(pkg)
        ref.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        net = mlp(pkg)
        rt = pkg.rec.ResilientTrainer(net, tmp, max_restarts=3)
        with pkg.faults.active(plan(pkg, (("train.step", "crash"),
                                          {"rate": 1.0, "count": 1}))):
            ret = rt.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        assert ret is net
        for a, b in zip(updater_leaves(pkg, net), updater_leaves(pkg, ref)):
            np.testing.assert_array_equal(a, b)   # bitwise, as the ref's
        obs = observe(pkg, net, rt)
        rt.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        obs["second_fit_restarts"] = rt.restarts   # per fit() call
        return net, obs
    obs = both(run)
    assert obs["restarts"] == 1 and obs["second_fit_restarts"] == 0
    assert "restore" in obs["events"]


@pytest.mark.parametrize("point, count, restarts", [
    ("train.step", 2, 0),            # transient: retried in place
    ("checkpoint.save", 2, None),    # after the update: never re-applied
])
def test_transient_faults_never_double_apply(point, count, restarts):
    def run(pkg, tmp):
        x, y = data(32)
        ref = mlp(pkg)
        ref.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        net = mlp(pkg)
        rt = pkg.rec.ResilientTrainer(
            net, tmp, max_restarts=0 if restarts == 0 else 3)
        with pkg.faults.active(plan(pkg, ((point, "error"),
                                          {"rate": 1.0, "count": count}))):
            rt.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        for k, d in params(pkg, net).items():
            for p, v in d.items():
                np.testing.assert_array_equal(v, params(pkg, ref)[k][p])
        return net, observe(pkg, net, rt)
    obs = both(run)
    assert obs["iteration"] == 4
    if restarts is not None:
        assert obs["restarts"] == restarts


def test_post_update_failure_blames_no_batch():
    def run(pkg, tmp):
        class FailOnce(pkg.lst.TrainingListener):
            fired = False

            def iteration_done(self, model, iteration, epoch, score):
                if not self.fired and iteration >= 2:
                    self.fired = True
                    raise OSError("disk full")

        x, y = data(32)
        ref = mlp(pkg)
        ref.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        net = mlp(pkg)
        net.addListeners(FailOnce())
        rt = pkg.rec.ResilientTrainer(net, tmp, max_restarts=3,
                                      quarantine_after=1)
        rt.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        for k, d in params(pkg, net).items():
            for p, v in d.items():
                np.testing.assert_array_equal(v, params(pkg, ref)[k][p])
        return net, observe(pkg, net, rt)
    assert both(run)["restarts"] == 1


def test_quarantine_skips_exactly_the_poisoned_batch():
    def run(pkg, tmp):
        x, y = data(32)
        ref = mlp(pkg)
        for i in range(1, 4):
            ref.fit(pkg.ds.DataSet(x[i * 8:(i + 1) * 8],
                                   y[i * 8:(i + 1) * 8]))
        net = mlp(pkg)
        rt = pkg.rec.ResilientTrainer(net, tmp, max_restarts=5,
                                      quarantine_after=2)
        with pkg.faults.active(plan(pkg, (("train.step", "crash"),
                                          {"rate": 1.0, "count": 2}))):
            rt.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        for k, d in params(pkg, net).items():
            for p, v in d.items():
                np.testing.assert_allclose(v, params(pkg, ref)[k][p],
                                           atol=0)
        return net, observe(pkg, net, rt)
    obs = both(run)
    assert obs["iteration"] == 3
    assert obs["counters"]["dl4j_data_quarantined_total"] == {(): 1.0}


def test_restart_budget_exhausted_raises_on_both():
    def run(pkg, tmp):
        x, y = data(16)
        net = mlp(pkg)
        rt = pkg.rec.ResilientTrainer(net, tmp, max_restarts=2,
                                      quarantine_after=99)
        with pkg.faults.active(plan(pkg, (("train.step", "crash"),
                                          {"rate": 1.0}))):
            with pytest.raises(pkg.policy.RestartBudgetExhausted):
                rt.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        return net, observe(pkg, net, rt)
    obs = both(run)
    assert obs["restarts"] == 3
    assert obs["counters"]["dl4j_resilience_restarts_total"] == {
        ("MultiLayerNetwork",): 2.0}


def test_coarse_cadence_cross_epoch_restore_matches():
    """A crash on the 4th step attempt (epoch 2's first batch) with a
    cadence of 2: the epoch-boundary checkpoint keeps the restore in
    epoch 2."""
    from unittest import mock

    def run(pkg, tmp):
        x, y = data(24)
        ref = mlp(pkg)
        ref.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=2)
        net = mlp(pkg)
        rt = pkg.rec.ResilientTrainer(net, tmp, max_restarts=3,
                                      checkpoint_every_iterations=2)
        calls = {"n": 0}

        def crash_on_fourth(point):
            if point == "train.step":
                calls["n"] += 1
                if calls["n"] == 4:
                    raise pkg.faults.InjectedFault(point, "crash")

        with mock.patch.object(pkg.faults, "armed", return_value=True), \
                mock.patch.object(pkg.faults, "check",
                                  side_effect=crash_on_fourth), \
                mock.patch.object(pkg.faults, "corrupt",
                                  side_effect=lambda p, v: v):
            rt.fit(pkg.it.ArrayDataSetIterator(x, y, 8), epochs=2)
        for k, d in params(pkg, net).items():
            for p, v in d.items():
                np.testing.assert_array_equal(v, params(pkg, ref)[k][p])
        return net, observe(pkg, net, rt)
    obs = both(run)
    assert obs["restarts"] == 1 and obs["iteration"] == 6


def test_shuffled_replay_equals_the_undisturbed_run():
    def run(pkg, tmp):
        x, y = data(32)
        a = mlp(pkg)
        pkg.rec.ResilientTrainer(a, os.path.join(tmp, "a")).fit(
            pkg.it.ArrayDataSetIterator(x, y, 8, shuffle=True, seed=5),
            epochs=2)
        b = mlp(pkg)
        rt = pkg.rec.ResilientTrainer(b, os.path.join(tmp, "b"),
                                      max_restarts=3)
        with pkg.faults.active(plan(pkg, (("train.step", "crash"),
                                          {"rate": 1.0, "count": 1}))):
            rt.fit(pkg.it.ArrayDataSetIterator(x, y, 8, shuffle=True,
                                               seed=5), epochs=2)
        for k, d in params(pkg, b).items():
            for p, v in d.items():
                np.testing.assert_array_equal(v, params(pkg, a)[k][p])
        return b, observe(pkg, b, rt)
    assert both(run)["restarts"] == 1


def test_non_iterator_fit_and_the_kill_switch_delegate(monkeypatch):
    def run(pkg, tmp):
        x, y = data(16)
        net = mlp(pkg)
        pkg.rec.ResilientTrainer(net, tmp).fit(x[:8], y[:8])
        assert net._iteration == 1
        monkeypatch.setenv("DL4J_TPU_RESILIENCE", "0")
        d = os.path.join(tmp, "off")
        pkg.rec.ResilientTrainer(net, d, max_restarts=3).fit(
            pkg.it.ArrayDataSetIterator(x, y, 8), epochs=1)
        monkeypatch.delenv("DL4J_TPU_RESILIENCE")
        assert os.listdir(d) == []            # no checkpoints, no wrapping
        return net, observe(pkg, net)
    assert both(run)["iteration"] == 3


# ----------------------------------------------------- the pieces alone
def test_newest_checkpoint_skips_a_torn_zip(tmp_path):
    for pkg in BOTH:
        d = tmp_path / pkg.name
        d.mkdir()
        good = str(d / "checkpoint_1_MultiLayerNetwork.zip")
        mlp(pkg).save(good)
        torn = str(d / "checkpoint_2_MultiLayerNetwork.zip")
        with open(torn, "wb") as f:
            f.write(b"PK\x03\x04 this is not a finished zip")
        os.utime(good, (time.time() - 60, time.time() - 60))
        assert pkg.rec.newest_checkpoint(str(d)) == good


def _positions(pkg):
    x, y = data(32)
    it = pkg.rec.SkippingIterator(pkg.it.ArrayDataSetIterator(x, y, 8),
                                  quarantine_after=1)
    seen = [it.position() for _ in iter(it)]
    it.reset()
    seen.append(it.position())
    n = len(list(iter(it)))
    it.note_failure(2)
    it.reset()
    m = len(list(iter(it)))
    sh = pkg.rec.SkippingIterator(
        pkg.it.ArrayDataSetIterator(x, y, 8, shuffle=True),
        quarantine_after=1)
    list(iter(sh))
    sh.note_failure(2)
    q1 = sh.quarantined()
    sh.reset_replay()
    q2 = sh.quarantined()
    sh.reset()
    return seen, n, m, it.quarantined(), q1, q2, sh.quarantined()


def test_skipping_iterator_positions_equal_the_reference():
    got, want = _positions(TORCH), _positions(JAX)
    assert got == want == ([0, 1, 2, 3, -1], 4, 3, [2], [2], [2], [])


def _preemption(pkg, d):
    older = os.path.join(d, "preempt_final_AAA.zip")
    newer = os.path.join(d, "preempt_final_ZZZ.zip")
    net = mlp(pkg)
    net.save(older)
    net.save(newer)
    past = time.time() - 120
    os.utime(older, (past, past))
    found = os.path.basename(pkg.pre.find_final_checkpoint(d))
    os.remove(older)
    real = os.path.join(d, "preempt_final_MultiLayerNetwork.zip")
    net.fit(pkg.ds.DataSet(*data(8)))
    net.save(real)
    with open(newer, "wb") as f:
        f.write(b"corrupt")
    os.utime(real, (time.time() - 60, time.time() - 60))
    kw = {} if pkg is JAX else {"device": "cpu"}
    restored, resumed = pkg.pre.resume_or_new(
        d, lambda: mlp_conf(pkg), **kw)
    with open(real, "wb") as f:
        f.write(b"also corrupt")
    fresh, resumed2 = pkg.pre.resume_or_new(d, lambda: mlp_conf(pkg), **kw)
    handler = pkg.pre.PreemptionHandler()
    lst = pkg.pre.PreemptionSafeListener(handler, d)
    lst.iteration_done(net, 6, 0, 0.5)        # no signal: nothing written
    handler.request_preemption()
    with pytest.raises(pkg.pre.TrainingPreempted) as ei:
        lst.iteration_done(net, 7, 0, 0.5)
    return (found, resumed, restored._iteration, resumed2,
            fresh._iteration, ei.value.iteration,
            os.path.basename(ei.value.checkpoint_path),
            [n for n in os.listdir(d) if n.endswith(".tmp")],
            zipfile.is_zipfile(lst.checkpoint_path))


def test_preemption_checkpoints_equal_the_reference(tmp_path):
    got = {}
    for pkg in BOTH:
        d = tmp_path / pkg.name
        d.mkdir()
        got[pkg.name] = _preemption(pkg, str(d))
    assert got["torch"] == got["jax"]
    assert got["torch"][:6] == ("preempt_final_ZZZ.zip", True, 1, False, 0,
                                7)


def test_resumed_net_lands_on_the_requested_device(tmp_path):
    net = mlp(TORCH)
    net.save(str(tmp_path / "preempt_final_MultiLayerNetwork.zip"))
    back, resumed = t_pre.resume_or_new(str(tmp_path),
                                        lambda: mlp_conf(TORCH),
                                        device="cpu")
    assert resumed and back.device.type == "cpu"


def test_elastic_raises_naming_roadmap_item_7(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        t_rec.ResilientTrainer(mlp(TORCH), str(tmp_path), elastic=True)


# ------------------------------------------------ the chip's drill here
def _drill_sets(pkg, n):
    x, y = data(8 * n, seed=4)
    return [pkg.ds.DataSet(x[i:i + 8], y[i:i + 8])
            for i in range(0, len(x), 8)]


def _counter(pkg):
    def read(name):
        vals = series(pkg, name)
        return sum(vals.values())
    return read


def test_healing_drill_counts_and_heals_as_the_reference(tmp_path):
    """``chip_smoke.healing_drill`` (the scoring phase's plan: a
    transient error, a crash, a batch that crashes twice) over 12 batches
    in both packages: the counts the plan implies, the same in each; the
    port's healed net equals an undisturbed port run over the same
    batches without the quarantined one bitwise, and the reference's
    healed net within ATOL."""
    n = chip_smoke.SC_TRAIN_BATCHES
    recs, states = {}, {}
    for pkg in BOTH:
        net = mlp(pkg)
        rec = chip_smoke.healing_drill(
            net, _drill_sets(pkg, n), str(tmp_path / pkg.name),
            trainer=pkg.rec.ResilientTrainer,
            iterator=pkg.it.ListDataSetIterator, faults=pkg.faults,
            counter=_counter(pkg))
        recs[pkg.name] = {k: rec[k] for k in (
            "fired", "restarts", "restores", "quarantines", "iterations",
            "checkpoints")}
        states[pkg.name] = (params(pkg, net), updater_leaves(pkg, net))
    assert recs["torch"] == recs["jax"]
    want = chip_smoke.healing_expected()
    assert {k: recs["torch"][k] for k in want} == want
    assert_same_state(states["torch"], states["jax"])
    undisturbed = mlp(TORCH)
    poisoned = [i for i, k in chip_smoke.SC_FAULTS.items()
                if k.count("crash") >= 2]
    undisturbed.fit(t_it.ListDataSetIterator(
        [s for i, s in enumerate(_drill_sets(TORCH, n))
         if i not in poisoned]))
    for k, d in params(TORCH, undisturbed).items():
        for p, v in d.items():
            np.testing.assert_array_equal(states["torch"][0][k][p], v)
    for a, b in zip(states["torch"][1], updater_leaves(TORCH, undisturbed)):
        np.testing.assert_array_equal(a, b)
