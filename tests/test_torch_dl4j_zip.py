"""The port's DL4J-artifact reader and writer (``modelimport/dl4j_zip.py``)
against the JAX package's on the CPU.

The fixture is the JAX package's test's: a zip hand-built to the Java
byte layout (``DataOutputStream`` UTF / long / big-endian records, as
``Nd4j.write`` writes them), rebuilt here; both packages read it into the
same arrays, exactly. Zips the port writes restore in the JAX package,
and the JAX package's in the port, with the same params exactly (the same
numpy plans on the same f32 values) and outputs within atol 1e-5 (f32
sums in another order): dense, convolution with BatchNormalization and
its running statistics, the LSTM gate permutation, GravesLSTM's
peepholes, graph vertices. The two packages write the same
``coefficients.bin`` and ``configuration.json`` bytes for the same net.
"""
import json
import struct
import zipfile

import numpy as np
import pytest

import torch

from deeplearning4j_tpu.modelimport import dl4j_zip as JD
from deeplearning4j_tpu.nn import graph as j_graph
from deeplearning4j_tpu.nn import graph_conf as j_gc
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu_torch.modelimport import dl4j_zip as TD
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import graph_conf as t_gc
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.optim import updaters as t_upd
from deeplearning4j_tpu_torch.utils.serialization import ModelSerializer

J = dict(cfg=j_cfg, L=j_layers, IT=j_inputs.InputType, U=j_upd, gc=j_gc,
         MLN=j_mln.MultiLayerNetwork, CG=j_graph.ComputationGraph)
P = dict(cfg=t_cfg, L=t_layers, IT=t_inputs.InputType, U=t_upd, gc=t_gc,
         MLN=t_mln.MultiLayerNetwork, CG=t_graph.ComputationGraph)
OUT_ATOL = 1e-5


# ------------------------------------------------ the hand-built Java bytes
def _java_utf(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _java_databuffer(values, dtype_name: str) -> bytes:
    fmt = {"FLOAT": ">f4", "LONG": ">i8"}[dtype_name]
    arr = np.asarray(values).astype(fmt)
    return (_java_utf("MIXED_DATA_TYPES") + struct.pack(">q", arr.size)
            + _java_utf(dtype_name) + arr.tobytes())


def _java_nd4j_vector(flat: np.ndarray) -> bytes:
    """``Nd4j.write`` bytes of a rank-1 float vector, following
    BaseDataBuffer#write: the shape-info longs' record, then the data's."""
    shape_info = [1, flat.size, 1, 0, 1, ord("c")]
    return (_java_databuffer(shape_info, "LONG")
            + _java_databuffer(flat, "FLOAT"))


def _dense_fixture_zip(tmp_path):
    """Dense(3→4 relu) + Output(4→2 softmax/NLL) with known weights."""
    act = "org.nd4j.linalg.activations.impl."
    conf = {
        "backpropType": "Standard",
        "confs": [
            {"layer": {"@class": "org.deeplearning4j.nn.conf.layers.DenseLayer",
                       "activationFn": {"@class": act + "ActivationReLU"},
                       "nin": 3, "nout": 4, "layerName": "dense0"},
             "seed": 42},
            {"layer": {"@class": "org.deeplearning4j.nn.conf.layers.OutputLayer",
                       "activationFn": {"@class": act + "ActivationSoftmax"},
                       "lossFn": {"@class": "org.nd4j.linalg.lossfunctions."
                                            "impl.LossNegativeLogLikelihood"},
                       "nin": 4, "nout": 2, "layerName": "out"},
             "seed": 42}],
        "inputType": {"@class": "org.deeplearning4j.nn.conf.inputs."
                                "InputType$InputTypeFeedForward", "size": 3},
    }
    w0 = np.arange(12, dtype=np.float32).reshape(3, 4)
    b0 = np.full(4, 0.5, np.float32)
    w1 = np.arange(8, dtype=np.float32).reshape(4, 2) * 0.1
    b1 = np.full(2, -0.25, np.float32)
    flat = np.concatenate([w0.ravel(order="F"), b0, w1.ravel(order="F"), b1])
    path = tmp_path / "dl4j_dense.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", _java_nd4j_vector(flat))
    return str(path), (w0, b0, w1, b1)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a.toNumpy() if hasattr(a, "toNumpy") else a)


def test_java_bytes_parse_alike():
    v = np.array([1.0, -2.0, 3.5], np.float32)
    blob = _java_nd4j_vector(v)
    np.testing.assert_array_equal(TD.read_nd4j_array(blob), v)
    np.testing.assert_array_equal(TD.read_nd4j_array(blob),
                                  JD.read_nd4j_array(blob))
    m = np.arange(6, dtype=np.float32).reshape(2, 3)
    f_order = (_java_databuffer([2, 2, 3, 1, 2, 0, 1, ord("f")], "LONG")
               + _java_databuffer(m.ravel(order="F"), "FLOAT"))
    np.testing.assert_array_equal(TD.read_nd4j_array(f_order), m)
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4) * 0.5
    assert TD.write_nd4j_array(arr) == JD.write_nd4j_array(arr)
    with pytest.raises(ValueError, match="truncated"):
        TD.read_nd4j_array(blob[:-3])


def test_hand_built_fixture_restores_alike(tmp_path):
    path, (w0, b0, w1, b1) = _dense_fixture_zip(tmp_path)
    net = TD.restore_multi_layer_network(path, device="cpu")
    ref = JD.restore_multi_layer_network(path)
    for key, want in (("0", (w0, b0)), ("1", (w1, b1))):
        for pname, arr in zip(("W", "b"), want):
            got = _np(net._params[key][pname])
            np.testing.assert_array_equal(got, arr)
            np.testing.assert_array_equal(got, np.asarray(
                ref._params[key][pname]))
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    out = _np(net.output(x))
    np.testing.assert_allclose(out, _np(ref.output(x)), atol=OUT_ATOL)
    np.testing.assert_allclose(out.sum(axis=1), np.ones(5), atol=1e-5)
    # ModelSerializer dispatches to the reader on coefficients.bin
    via = ModelSerializer.restore(path, device="cpu")
    assert type(via) is t_mln.MultiLayerNetwork
    np.testing.assert_array_equal(_np(via._params["0"]["W"]), w0)


def test_normalizer_bin_and_size_mismatch_are_loud(tmp_path):
    path, _ = _dense_fixture_zip(tmp_path)
    with zipfile.ZipFile(path, "a") as zf:
        zf.writestr("normalizer.bin", b"\x00\x01")
    with pytest.raises(ValueError, match="normalizer.bin"):
        TD.restore_multi_layer_network(path, device="cpu")
    short = tmp_path / "short.zip"
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(short, "w") as zout:
        zout.writestr("configuration.json", zin.read("configuration.json"))
        zout.writestr("coefficients.bin",
                      _java_nd4j_vector(np.zeros(10, np.float32)))
    with pytest.raises(ValueError, match="exhausted"):
        TD.restore_multi_layer_network(str(short), device="cpu")


# ------------------------------------------- nets written by each package
def _mln(ns, layers, input_type=None):
    b = ns["cfg"].NeuralNetConfiguration.builder().seed(7).updater(
        ns["U"].Adam(1e-3)).list()
    for layer in layers:
        b.layer(layer)
    if input_type is not None:
        b.set_input_type(input_type)
    return b.build()


def conf_dense(ns):
    L = ns["L"]
    return _mln(ns, [L.DenseLayer(n_in=5, n_out=8, activation="relu"),
                     L.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                   loss_function="negativeloglikelihood")])


def conf_conv_bn(ns):
    L = ns["L"]
    return _mln(ns, [L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                        activation="relu"),
                     L.BatchNormalization(),
                     L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
                     L.DenseLayer(n_out=8, activation="relu"),
                     L.OutputLayer(n_out=3, activation="softmax",
                                   loss_function="negativeloglikelihood")],
                ns["IT"].convolutional_flat(8, 8, 1))


def conf_lstm(ns):
    L = ns["L"]
    return _mln(ns, [L.LSTM(n_in=5, n_out=6),
                     L.RnnOutputLayer(n_in=6, n_out=3, activation="softmax",
                                      loss_function="mcxent")])


def conf_graves(ns):
    L = ns["L"]
    return _mln(ns, [L.GravesLSTM(n_in=3, n_out=4),
                     L.RnnOutputLayer(n_in=4, n_out=2, activation="softmax",
                                      loss_function="mcxent")])


def conf_graph(ns):
    L, G = ns["L"], ns["gc"]
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(3)
            .updater(ns["U"].Adam(1e-2)).graph_builder().add_inputs("in")
            .add_layer("a", L.DenseLayer(n_out=6, activation="relu"), "in")
            .add_layer("b", L.DenseLayer(n_out=6, activation="tanh"), "in")
            .add_vertex("sum", G.ElementWiseVertex(op="add"), "a", "b")
            .add_vertex("scaled", G.ScaleVertex(scale=0.5), "sum")
            .add_vertex("merged", G.MergeVertex(), "sum", "scaled")
            .add_layer("bn", L.BatchNormalization(), "merged")
            .add_layer("out", L.OutputLayer(
                n_out=3, activation="softmax",
                loss_function="negativeloglikelihood"), "bn")
            .set_outputs("out").set_input_types(ns["IT"].feed_forward(5))
            .build())


CASES = {"dense": (conf_dense, (4, 5)), "conv_bn": (conf_conv_bn, (2, 64)),
         "lstm": (conf_lstm, (2, 7, 5)), "graves": (conf_graves, (2, 6, 3)),
         "graph": (conf_graph, (8, 5))}


def pair(case):
    """(reference net, port net) with the same seeded params, non-zero
    peepholes and BN statistics, carried from numpy."""
    make, _ = CASES[case]
    graph = case == "graph"
    ref = (J["CG"] if graph else J["MLN"])(make(J)).init()
    net = (P["CG"] if graph else P["MLN"])(make(P), device="cpu").init()
    rng = np.random.default_rng(5)
    params = {k: {p: (rng.standard_normal(np.shape(v)) * 0.3).astype(
        np.float32) for p, v in layer.items()}
        for k, layer in ref.param_tree().items()}
    states = {k: {s: (rng.random(np.shape(v)) + 0.5).astype(np.float32)
                  for s, v in layer.items()}
              for k, layer in ref.state_tree().items()}
    import jax.numpy as jnp
    ref._params = {k: {p: jnp.asarray(v) for p, v in layer.items()}
                   for k, layer in params.items()}
    ref._states = {k: {s: jnp.asarray(v) for s, v in layer.items()}
                   for k, layer in states.items()}
    net.set_param_tree(params)
    net.set_state_tree(states)
    return ref, net


def _x(case):
    return np.random.default_rng(2).normal(size=CASES[case][1]).astype(
        np.float32)


def _restore(mod, path, graph):
    kw = {} if mod is JD else {"device": "cpu"}
    return (mod.restore_computation_graph(path, **kw) if graph
            else mod.restore_multi_layer_network(path, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dl4j_zips_restore_in_the_other_package(tmp_path, case, writer):
    ref, net = pair(case)
    graph = case == "graph"
    src, mod, back = ((net, TD, JD) if writer == "port" else (ref, JD, TD))
    path = str(tmp_path / f"{case}.zip")
    mod.write_model(src, path)
    got = _restore(back, path, graph)
    want_p = ref.param_tree()
    for k in want_p:
        for p in want_p[k]:
            np.testing.assert_array_equal(_np(got._params[k][p]),
                                          np.asarray(want_p[k][p]),
                                          err_msg=f"{k}/{p}")
    for k, layer in ref.state_tree().items():
        for s, v in layer.items():
            np.testing.assert_array_equal(_np(got._states[k][s]),
                                          np.asarray(v), err_msg=f"{k}/{s}")
    x = _x(case)
    np.testing.assert_allclose(_np(got.output(x)), _np(ref.output(x)),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(_np(got.output(x)), _np(net.output(x)),
                               atol=OUT_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_packages_write_the_same_artifact(tmp_path, case):
    ref, net = pair(case)
    paths = [str(tmp_path / f"{w}.zip") for w in ("port", "jax")]
    TD.write_model(net, paths[0])
    JD.write_model(ref, paths[1])
    members = []
    for p in paths:
        with zipfile.ZipFile(p) as zf:
            members.append({n: zf.read(n) for n in zf.namelist()})
    assert members[0] == members[1]


def test_lstm_gates_and_peepholes_land_where_the_reference_puts_them():
    """The flat vector's layout itself: DL4J's [i, f, o, g] gate blocks
    against the fused [i, f, g, o], and GravesLSTM's RW with its three
    peephole columns last."""
    for case in ("lstm", "graves"):
        ref, net = pair(case)
        flat = TD.params_to_flat(net)
        np.testing.assert_array_equal(flat, JD.params_to_flat(ref))
        h = 6 if case == "lstm" else 4
        n_in = 5 if case == "lstm" else 3
        w = np.asarray(ref.param_tree()["0"]["W"])
        dl4j_w = flat[:n_in * 4 * h].reshape((n_in, 4 * h), order="F")
        blocks = dl4j_w.reshape(n_in, 4, h)
        np.testing.assert_array_equal(blocks[:, 2], w[:, 3 * h:])   # o
        np.testing.assert_array_equal(blocks[:, 3], w[:, 2 * h:3 * h])  # g
        if case == "graves":
            rw = flat[n_in * 4 * h:n_in * 4 * h + h * (4 * h + 3)].reshape(
                (h, 4 * h + 3), order="F")
            for col, name in enumerate(("pF", "pO", "pI")):
                np.testing.assert_array_equal(
                    rw[:, 4 * h + col],
                    np.asarray(ref.param_tree()["0"][name]))


def test_conv_bias_comes_first():
    ref, net = pair("conv_bn")
    flat = TD.params_to_flat(net)
    np.testing.assert_array_equal(flat[:4], _np(net._params["0"]["b"]))
    np.testing.assert_array_equal(flat, JD.params_to_flat(ref))


def test_restored_graph_fine_tunes_and_resaves(tmp_path):
    _, net = pair("graph")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    p1 = str(tmp_path / "cg.zip")
    TD.write_model(net, p1)
    g2 = TD.restore_computation_graph(p1, device="cpu")
    g2.fit(x, y)
    s0 = g2.score()
    for _ in range(5):
        g2.fit(x, y)
    assert g2.score() < s0
    p2 = str(tmp_path / "cg2.zip")
    TD.write_model(g2, p2)
    g3 = JD.restore_computation_graph(p2)
    np.testing.assert_allclose(_np(g3.output(x)), _np(g2.output(x)),
                               atol=OUT_ATOL)
    with zipfile.ZipFile(p2) as zf:
        assert "vertices" in json.loads(zf.read("configuration.json"))
    assert type(ModelSerializer.restore(p2, device="cpu")) is \
        t_graph.ComputationGraph
