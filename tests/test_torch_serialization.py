"""Persistence of the port (``utils/serialization.py``, the nets' ``save`` /
``load``, ``ZooModel.save_pretrained`` / ``init_pretrained``,
``CheckpointListener``) against the JAX package on the CPU.

A zip written by either package restores in the other: params, layer
states and every updater leaf (Adam's ``mu`` / ``nu`` and the step count)
bitwise equal, the normalizer's arrays equal, ``meta.json``'s counters
equal. One more Adam step after a cross-package restore agrees within
``test_torch_networks.py``'s f32 per-step row (atol 1e-5: the same f32
arithmetic, sums in another order). ``configuration.json`` is one
document: the port's JSON, parsed by the reference and re-emitted, is the
same string, and the other way round, for every zoo model, updater,
schedule and dropout kind.
"""
import io
import json
import logging
import os
import time
import zipfile

import numpy as np
import pytest

import jax
import torch

import deeplearning4j_tpu.models.zoo as j_zoo
import deeplearning4j_tpu_torch.models.zoo as t_zoo
from deeplearning4j_tpu.data import normalizers as j_norm
from deeplearning4j_tpu.nn import graph as j_graph
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import dropout as j_drop
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.nn.graph_conf import (
    ComputationGraphConfiguration as JG)
from deeplearning4j_tpu.optim import schedules as j_sched
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu.utils import serialization as j_ser
from deeplearning4j_tpu_torch.data import normalizers as t_norm
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import dropout as t_drop
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.nn.graph_conf import (
    ComputationGraphConfiguration as TG)
from deeplearning4j_tpu_torch.optim import schedules as t_sched
from deeplearning4j_tpu_torch.optim import transforms as T
from deeplearning4j_tpu_torch.optim import updaters as t_upd
from deeplearning4j_tpu_torch.optim.listeners import CheckpointListener
from deeplearning4j_tpu_torch.resilience import faults as t_faults
from deeplearning4j_tpu_torch.utils import serialization as t_ser

J = dict(cfg=j_cfg, L=j_layers, IT=j_inputs.InputType, U=j_upd,
         MLN=j_mln.MultiLayerNetwork, CG=j_graph.ComputationGraph,
         norm=j_norm, ser=j_ser)
P = dict(cfg=t_cfg, L=t_layers, IT=t_inputs.InputType, U=t_upd,
         MLN=t_mln.MultiLayerNetwork, CG=t_graph.ComputationGraph,
         norm=t_norm, ser=t_ser)
PKG = {"jax": J, "port": P}
STEP_ATOL = 1e-5


def mln_conf(ns, updater=None):
    """Conv + BatchNormalization + dense + output on 8x8x1: params, BN
    states and (under Adam) mu / nu of every kind of leaf. The convolution
    takes its activation before the BN: a bias straight into a BN has a
    zero gradient in exact arithmetic, which Adam would turn into moves of
    up to its learning rate from rounding alone."""
    L = ns["L"]
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(7)
            .updater(updater or ns["U"].Adam(1e-2)).weight_init("xavier")
            .list()
            .layer(L.ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                      activation="relu"))
            .layer(L.BatchNormalization())
            .layer(L.ActivationLayer(activation="identity"))
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns["IT"].convolutional(8, 8, 1)).build())


def cg_conf(ns, updater=None):
    """Two branches into a merge, a BN, an output: a graph's zip."""
    L = ns["L"]
    g = (ns["cfg"].NeuralNetConfiguration.builder().seed(11)
         .updater(updater or ns["U"].Adam(1e-2)).weight_init("xavier")
         .graph_builder().add_inputs("in")
         .set_input_types(ns["IT"].feed_forward(6)))
    g.add_layer("a", L.DenseLayer(n_out=5, activation="relu"), "in")
    g.add_layer("b", L.DenseLayer(n_out=4, activation="tanh"), "in")
    g.add_vertex("m", ns["gc"].MergeVertex(), "a", "b")
    g.add_layer("bn", L.BatchNormalization(), "m")
    g.add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                     loss_function="mcxent"), "bn")
    return g.set_outputs("out").build()


def _gc(ns):
    if ns is J:
        from deeplearning4j_tpu.nn import graph_conf
    else:
        from deeplearning4j_tpu_torch.nn import graph_conf
    return graph_conf


for _ns in (J, P):
    _ns["gc"] = _gc(_ns)


def data(kind, n=8, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n, 8, 8, 1) if kind == "mln" else (n, 6)
    x = rng.standard_normal(shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def build(pkg, kind, updater=None):
    ns = PKG[pkg]
    conf = (mln_conf if kind == "mln" else cg_conf)(ns, updater)
    cls = ns["MLN"] if kind == "mln" else ns["CG"]
    return cls(conf).init() if pkg == "jax" else cls(conf,
                                                     device="cpu").init()


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def params_of(net):
    return {k: {p: _np(v) for p, v in layer.items()}
            for k, layer in net._params.items()}


def states_of(net):
    return {k: {p: _np(v) for p, v in layer.items()}
            for k, layer in net._states.items()}


def updater_leaves(net):
    if isinstance(net, (t_mln.MultiLayerNetwork, t_graph.ComputationGraph)):
        return [np.asarray(a, np.int32) if isinstance(a, int) else _np(a)
                for a in T.state_leaves(net._opt_state)]
    return [np.asarray(a) for a in jax.tree.leaves(net._opt_state)]


def assert_trees_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k]), k
        for p in want[k]:
            assert got[k][p].dtype == want[k][p].dtype == np.float32
            np.testing.assert_array_equal(got[k][p], want[k][p],
                                          err_msg=f"{k}/{p}")


def assert_leaves_bitwise(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf_{i}")


def fit(net, kind, steps, seed=0):
    for s in range(steps):
        net.fit(*data(kind, seed=seed + s))


def other(pkg):
    return "port" if pkg == "jax" else "jax"


def restore(pkg, path):
    if pkg == "jax":
        return j_ser.ModelSerializer.restore(path)
    return t_ser.ModelSerializer.restore(path, device="cpu")


@pytest.mark.parametrize("kind", ["mln", "cg"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_zip_restores_in_the_other_package_bitwise(tmp_path, writer, kind):
    src = build(writer, kind)
    fit(src, kind, 3)
    x, _ = data(kind, n=20, seed=50)
    norm = PKG[writer]["norm"].NormalizerStandardize()
    norm.fit(_dataset(writer, x))
    path = str(tmp_path / "net.zip")
    PKG[writer]["ser"].ModelSerializer.write_model(src, path,
                                                   normalizer=norm)
    got = restore(other(writer), path)
    assert type(got).__name__ == type(src).__name__
    assert_trees_bitwise(params_of(got), params_of(src))
    assert_trees_bitwise(states_of(got), states_of(src))
    assert_leaves_bitwise(updater_leaves(got), updater_leaves(src))
    assert (got._iteration, got._epoch) == (src._iteration, src._epoch) \
        == (3, 0)
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
    assert {k: meta[k] for k in ("iteration", "epoch", "format_version",
                                 "model_type")} == {
        "iteration": 3, "epoch": 0, "format_version": 1,
        "model_type": type(src).__name__}
    back = PKG[other(writer)]["ser"].ModelSerializer.restore_normalizer(path)
    assert type(back).__name__ == "NormalizerStandardize"
    np.testing.assert_array_equal(back.mean, norm.mean)
    np.testing.assert_array_equal(back.std, norm.std)
    # the restored net answers as the source does
    np.testing.assert_allclose(_np(got.output(x)), _np(
        src.output(x).toNumpy() if hasattr(src.output(x), "toNumpy")
        else src.output(x)), atol=1e-5)


def _dataset(pkg, x):
    if pkg == "jax":
        from deeplearning4j_tpu.data.dataset import DataSet
    else:
        from deeplearning4j_tpu_torch.data.dataset import DataSet
    return DataSet(x, np.zeros((len(x), 3), np.float32))


@pytest.mark.parametrize("kind", ["mln", "cg"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adam_resumes_across_packages(tmp_path, writer, kind):
    """k Adam steps in one package, a zip, a restore in the other with
    every mu / nu leaf bitwise, then one more step in each: the params
    agree within the f32 per-step row."""
    src = build(writer, kind)
    fit(src, kind, 4)
    path = str(tmp_path / "adam.zip")
    src.save(path)
    got = restore(other(writer), path)
    leaves = updater_leaves(got)
    assert_leaves_bitwise(leaves, updater_leaves(src))
    # Adam's count and the learning-rate schedule's
    assert [a.item() for a in leaves if a.ndim == 0] == [4, 4]
    assert sum(a.size for a in leaves if a.ndim) == 2 * sum(
        v.size for layer in params_of(src).values() for v in layer.values())
    x, y = data(kind, seed=99)
    src.fit(x, y)
    got.fit(x, y)
    want, have = params_of(src), params_of(got)
    for k in want:
        for p in want[k]:
            np.testing.assert_allclose(have[k][p], want[k][p],
                                       atol=STEP_ATOL, err_msg=f"{k}/{p}")
    assert abs(float(got.score()) - float(src.score())) <= STEP_ATOL


def _rewrite_zip(src, dst, edit):
    """Copy zip ``src`` to ``dst`` with ``edit(name, bytes)`` -> bytes or
    None (drop) applied to every member."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data_ = edit(name, zin.read(name))
            if data_ is not None:
                zout.writestr(name, data_)


def _edit_coefficients(name, blob):
    if name != "coefficients.npz":
        return blob
    with np.load(io.BytesIO(blob)) as z:
        arrays = {k: z[k] for k in z.files}
    del arrays["3/W"]                          # a missing param
    arrays["3/legacy_b"] = np.zeros(8, np.float32)  # an orphan
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_orphan_and_missing_params_warn_as_the_reference(tmp_path, caplog):
    src = build("jax", "mln")
    path, edited = str(tmp_path / "a.zip"), str(tmp_path / "b.zip")
    src.save(path)
    _rewrite_zip(path, edited, _edit_coefficients)
    msgs = {}
    for pkg, logger in (("jax", "deeplearning4j_tpu"),
                        ("port", "deeplearning4j_tpu_torch")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            net = restore(pkg, edited)
        msgs[pkg] = sorted(r.getMessage() for r in caplog.records
                           if r.name == logger)
        # the missing param keeps its fresh init; the rest are the zip's
        np.testing.assert_array_equal(_np(net._params["0"]["W"]),
                                      np.asarray(src._params["0"]["W"]))
    assert msgs["port"] == msgs["jax"]
    assert len(msgs["port"]) == 2
    assert any("no parameter 3/W" in m for m in msgs["port"])
    assert any("orphaned checkpoint parameter 3/legacy_b" in m
               for m in msgs["port"])


def test_zip_with_grad_compression_state_is_refused(tmp_path):
    src = build("jax", "mln")
    path, edited = str(tmp_path / "a.zip"), str(tmp_path / "b.zip")
    src.save(path)
    buf = io.BytesIO()
    np.savez(buf, residual_0=np.zeros(4, np.float32))

    def add(name, blob):
        return blob
    _rewrite_zip(path, edited, add)
    with zipfile.ZipFile(edited, "a") as zf:
        zf.writestr("gradCompression.npz", buf.getvalue())
    # a gradCompression.npz without its thresholds is refused as the
    # reference refuses it: the net restores with no compression state
    # (state_from_arrays gives None); whole states restore in
    # tests/test_torch_compression.py
    net = t_ser.ModelSerializer.restore(edited, device="cpu")
    ref = j_ser.ModelSerializer.restore(edited)
    assert net._grad_compression_state is None
    assert ref._grad_compression_state is None


def test_non_f32_leaves_are_refused(tmp_path):
    net = build("port", "mln")
    net._params["3"]["W"] = net._params["3"]["W"].to(torch.bfloat16)
    with pytest.raises(TypeError, match="f32 only"):
        net.save(str(tmp_path / "bf16.zip"))
    # and a zip whose array is not f32 is refused on read
    good = build("port", "mln")
    path, edited = str(tmp_path / "a.zip"), str(tmp_path / "b.zip")
    good.save(path)

    def to_f16(name, blob):
        if name != "coefficients.npz":
            return blob
        with np.load(io.BytesIO(blob)) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["3/W"] = arrays["3/W"].astype(np.float16)
        out = io.BytesIO()
        np.savez(out, **arrays)
        return out.getvalue()
    _rewrite_zip(path, edited, to_f16)
    with pytest.raises(TypeError, match="f32 only"):
        t_ser.ModelSerializer.restore(edited, device="cpu")


def test_updater_state_of_another_updater_keeps_fresh_state(tmp_path,
                                                            caplog):
    src = build("port", "mln")
    fit(src, "mln", 2)
    path = str(tmp_path / "adam.zip")
    src.save(path)
    conf = mln_conf(P, t_upd.Nesterovs(0.1, 0.9))
    dst = t_mln.MultiLayerNetwork(conf, device="cpu").init()
    with zipfile.ZipFile(path) as zf, caplog.at_level(logging.WARNING):
        t_ser.ModelSerializer._restore_into(dst, zf, True)
    assert any("does not fit" in r.getMessage() for r in caplog.records)
    assert all(float(a.abs().sum()) == 0 for a in
               T.state_leaves(dst._opt_state) if isinstance(a, torch.Tensor))
    assert_trees_bitwise(params_of(dst), params_of(src))


def test_save_model_atomic_manifest_crash_keeps_previous(tmp_path):
    """The twin of the JAX package's zip-path manifest drill: a crash at
    ``checkpoint.manifest`` (after the fsync, before the rename) leaves
    the previous complete zip in charge, and no new name."""
    net = build("port", "mln")
    path = str(tmp_path / "ck.zip")
    t_ser.save_model_atomic(net, path)
    before = open(path, "rb").read()
    fit(net, "mln", 1)
    plan = t_faults.FaultPlan([t_faults.FaultSpec(
        "checkpoint.manifest", "crash", rate=1.0, count=1)])
    with t_faults.active(plan):
        with pytest.raises(t_faults.InjectedFault):
            t_ser.save_model_atomic(net, path)
    assert open(path, "rb").read() == before       # old save in charge
    assert t_ser.ModelSerializer.restore(path, device="cpu")._iteration == 0
    t_ser.save_model_atomic(net, path)             # no fault: it goes through
    assert t_ser.ModelSerializer.restore(path, device="cpu")._iteration == 1
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_checkpoint_candidates_rank_as_the_reference(tmp_path):
    net = build("port", "mln")
    d = str(tmp_path)
    names = ["checkpoint_1_MultiLayerNetwork.zip",
             "checkpoint_2_MultiLayerNetwork.zip",
             "checkpoint_10_MultiLayerNetwork.zip", "other_3.zip"]
    for n in names:
        net.save(os.path.join(d, n))
    now = time.time()
    # 1 and 10 share an mtime (the counter breaks the tie), 2 is newest
    for n, t in zip(names, (now - 60, now, now - 60, now - 120)):
        os.utime(os.path.join(d, n), (t, t))
    with open(os.path.join(d, "checkpoint_11_MultiLayerNetwork.zip"),
              "wb") as f:
        f.write(b"PK\x03\x04 this is not a finished zip")   # torn
    open(os.path.join(d, "checkpoint_12_MultiLayerNetwork.zip.tmp"),
         "wb").close()                                     # in flight
    for prefix in (None, "checkpoint_"):
        got = t_ser.checkpoint_candidates(d, prefix)
        assert got == j_ser.checkpoint_candidates(d, prefix)
        assert [os.path.basename(p) for p in got] == (
            [names[1], names[2], names[0]]
            + ([names[3]] if prefix is None else []))
    assert t_ser.checkpoint_candidates(str(tmp_path / "absent")) == []


def test_nets_save_and_load(tmp_path):
    for kind, cls in (("mln", t_mln.MultiLayerNetwork),
                      ("cg", t_graph.ComputationGraph)):
        net = build("port", kind)
        fit(net, kind, 2)
        path = str(tmp_path / f"{kind}.zip")
        net.save(path, save_updater=False)
        with zipfile.ZipFile(path) as zf:
            assert "updaterState.npz" not in zf.namelist()
        got = cls.load(path, device="cpu")
        assert type(got) is cls and got.device.type == "cpu"
        assert_trees_bitwise(params_of(got), params_of(net))
        x, _ = data(kind, seed=3)
        assert torch.equal(got.output(x), net.output(x))


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU contract does not apply")
    net = build("port", "mln")
    path = str(tmp_path / "net.zip")
    net.save(path)
    for call in (lambda: t_ser.ModelSerializer.restore(path),
                 lambda: t_mln.MultiLayerNetwork.load(path)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pretrained_cache_round_trip(tmp_path, monkeypatch, writer):
    """``save_pretrained`` in one package, ``init_pretrained`` in the
    other, through the ``DL4J_TPU_ZOO_CACHE`` directory."""
    monkeypatch.setenv("DL4J_TPU_ZOO_CACHE", str(tmp_path))
    zoo = {"jax": j_zoo, "port": t_zoo}
    model = zoo[writer].LeNet(num_classes=10)
    net = (model.init_model() if writer == "jax"
           else model.init_model(device="cpu"))
    x = np.random.default_rng(0).random((4, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[[1, 2, 3, 4]]
    net.fit(x, y)
    path = model.save_pretrained(net, "mnist")
    assert os.path.basename(path) == "lenet_mnist.zip"
    other_model = zoo[other(writer)].LeNet(num_classes=10)
    assert other_model.pretrained_available("mnist")
    got = (other_model.init_pretrained("mnist") if writer == "port"
           else other_model.init_pretrained("mnist", device="cpu"))
    assert_trees_bitwise(params_of(got), params_of(net))
    assert_leaves_bitwise(updater_leaves(got), updater_leaves(net))
    assert got._iteration == 1


def test_checkpoint_listener_rotates_and_records(tmp_path):
    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.observability import global_registry
    net = build("port", "mln")
    it = ListDataSetIterator([DataSet(*data("mln", seed=s))
                              for s in range(2)])
    ck = CheckpointListener(str(tmp_path), save_every_n_epochs=1,
                            keep_last=2, keep_every=3)
    net.setListeners(ck)
    hist = global_registry().histogram("dl4j_checkpoint_save_seconds",
                                       "wall time of one checkpoint save")
    n0 = hist.count
    net.fit(it, epochs=5)
    left = sorted(os.listdir(tmp_path))
    # epochs 1-5 saved; the last two kept, and the 3rd (keep_every)
    assert left == [f"checkpoint_{i}_MultiLayerNetwork.zip"
                    for i in (3, 4, 5)]
    assert ck.last_checkpoint().endswith("checkpoint_5_MultiLayerNetwork.zip")
    newest = t_ser.checkpoint_candidates(str(tmp_path))[0]
    got = t_ser.ModelSerializer.restore(newest, device="cpu")
    assert (got._iteration, got._epoch) == (10, 4)
    assert_trees_bitwise(params_of(got), params_of(net))
    assert hist.count - n0 == 5
    # a fault at checkpoint.save surfaces, and writes nothing
    plan = t_faults.FaultPlan([t_faults.FaultSpec(
        "checkpoint.save", "crash", rate=1.0, count=1)])
    with t_faults.active(plan):
        with pytest.raises(t_faults.InjectedFault):
            ck.on_epoch_end(net, 5)
    assert sorted(os.listdir(tmp_path)) == left


# ------------------------------------------------------- configuration JSON
def _conf_round_trip(port_conf, ref_conf, graph):
    JC = JG if graph else j_cfg.MultiLayerConfiguration
    TC = TG if graph else t_cfg.MultiLayerConfiguration
    pj, rj = port_conf.to_json(), ref_conf.to_json()
    assert pj == rj
    assert JC.from_json(pj).to_json() == pj
    assert TC.from_json(rj).to_json() == rj


ZOO = [n for n in t_zoo.__all__ if n not in ("ZooModel", "PretrainedType")]


@pytest.mark.parametrize("name", ZOO)
def test_zoo_configuration_json_reads_in_both_packages(name):
    t_conf, j_conf = getattr(t_zoo, name)().conf(), getattr(j_zoo, name)().conf()
    _conf_round_trip(t_conf, j_conf, hasattr(t_conf, "network_inputs"))


UPDATERS = ["Sgd", "Nesterovs", "Adam", "AdamW", "AdaMax", "Nadam", "AMSGrad",
            "RmsProp", "AdaGrad", "AdaDelta", "NoOp"]
SCHEDULES = [("FixedSchedule", {}), ("MapSchedule", {"values": {0: 0.1,
                                                               5: 0.01}}),
             ("ExponentialSchedule", {}), ("InverseSchedule", {}),
             ("PolySchedule", {}), ("SigmoidSchedule", {}),
             ("StepSchedule", {}), ("CosineSchedule", {}),
             ("WarmupSchedule", {})]
DROPOUTS = [("Dropout", (0.8,)), ("GaussianDropout", (0.1,)),
            ("GaussianNoise", (0.1,)), ("AlphaDropout", (0.9,)), None]


def _small_conf(ns, updater, dropout, graph):
    L = ns["L"]
    dense = L.DenseLayer(n_out=4, activation="relu", dropout=dropout)
    b = ns["cfg"].NeuralNetConfiguration.builder().seed(1).updater(updater)
    out = L.OutputLayer(n_out=2, activation="softmax",
                        loss_function="mcxent")
    if graph:
        g = (b.graph_builder().add_inputs("in")
             .set_input_types(ns["IT"].feed_forward(3)))
        g.add_layer("d", dense, "in").add_layer("o", out, "d")
        return g.set_outputs("o").build()
    return (b.list().layer(dense).layer(out)
            .set_input_type(ns["IT"].feed_forward(3)).build())


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "cg"])
@pytest.mark.parametrize("updater", UPDATERS)
def test_updater_configuration_json_reads_in_both_packages(updater, graph):
    confs = [_small_conf(ns, getattr(ns["U"], updater)(), None, graph)
             for ns in (P, J)]
    _conf_round_trip(*confs, graph)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=lambda s: s[0])
def test_schedule_configuration_json_reads_in_both_packages(schedule):
    name, kw = schedule
    confs = [_small_conf(ns, ns["U"].Adam(getattr(mod, name)(**kw)), None,
                         False)
             for ns, mod in ((P, t_sched), (J, j_sched))]
    _conf_round_trip(*confs, False)


@pytest.mark.parametrize("dropout", DROPOUTS,
                         ids=lambda d: d[0] if d else "retain_float")
def test_dropout_configuration_json_reads_in_both_packages(dropout):
    confs = [_small_conf(ns, ns["U"].Sgd(0.1),
                         getattr(mod, dropout[0])(*dropout[1]) if dropout
                         else 0.7, True)
             for ns, mod in ((P, t_drop), (J, j_drop))]
    _conf_round_trip(*confs, True)
