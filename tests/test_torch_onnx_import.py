"""The port's ONNX import (``modelimport/onnximport.py`` over its own wire
codec ``onnx_proto.py``) against the JAX package's, on the CPU.

Twins of ``tests/test_onnx_import.py`` and ``tests/test_onnx_tranche3.py``:
each of their cases runs as written, with ``OnnxGraphMapper`` standing
for both packages: every model the case builds is imported from the same
bytes by the port (on the CPU) and by the reference, and every
``output`` the case asks of the reference is asked of the port too and
held to it: shapes and dtypes exactly, f32 values to atol = rtol = 1e-5
(the same arithmetic, sums in another order), the graphs that draw
random values by shape and dtype only (the draws are not the
reference's). Where the reference refuses a model, the port must refuse
it with the same message. Then: the codec's round trip across packages,
3 Adam steps of a ``trainable=True`` import against the reference's,
and ``tools/onnx_resnet.py``'s two-stage width-16 ResNet at (2, 3, 32,
32) three ways.
"""
import inspect
import itertools

import numpy as np
import pytest
import torch

import test_onnx_import as ref_a
import test_onnx_tranche3 as ref_b
from deeplearning4j_tpu.modelimport import onnx_proto as JP
from deeplearning4j_tpu.modelimport import onnximport as JO
from deeplearning4j_tpu_torch.modelimport import onnx_proto as TP
from deeplearning4j_tpu_torch.modelimport import onnximport as TO

TOL = dict(atol=1e-5, rtol=1e-5)
DRAWS = {"random_normal_gen", "random_uniform_gen", "bernoulli_sample",
         "random_multinomial"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _compare(ref, port, feeds, outputs, ref_out):
    port_out = port.output(feeds, outputs)
    draws = any(op.op_name in DRAWS for op in ref.ops())
    assert sorted(port_out) == sorted(ref_out)
    for name, want in ref_out.items():
        got, want = _np(port_out[name]), np.asarray(want)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        if draws:
            continue
        if np.issubdtype(want.dtype, np.inexact):
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


class TwinMapper:
    """Imports with both packages; the reference's graph is returned, its
    ``output`` also asked of the port's and compared."""

    compared = 0

    @staticmethod
    def import_model(model, trainable=False):
        port_err = None
        try:
            port = TO.OnnxGraphMapper.import_model(model, trainable=trainable,
                                                   device="cpu")
        except Exception as e:            # held against the reference's
            port_err = e
        try:
            ref = JO.OnnxGraphMapper.import_model(model, trainable=trainable)
        except Exception as e:
            assert port_err is not None, f"the port imported: {e}"
            assert type(port_err).__name__ == type(e).__name__
            assert str(port_err) == str(e)
            raise
        if port_err is not None:
            raise port_err
        if not trainable:
            orig = ref.output

            def output(feeds, outputs=None, **kw):
                got = orig(feeds, outputs, **kw)
                _compare(ref, port, feeds, outputs, got)
                TwinMapper.compared += 1
                return got
            ref.output = output
        return ref

    importModel = import_model
    import_graph = import_model


def _expand(fn):
    """(id suffix, kwargs) of each parametrisation of a test function."""
    marks = [m for m in getattr(fn, "pytestmark", [])
             if m.name == "parametrize"]
    if not marks:
        return [("", {})]
    axes = []
    for m in marks:
        names = [s.strip() for s in m.args[0].split(",")]
        vals = [v if len(names) > 1 else (v,) for v in m.args[1]]
        axes.append([dict(zip(names, v)) for v in vals])
    out = []
    for combo in itertools.product(*axes):
        kw = {k: v for d in combo for k, v in d.items()}
        out.append(("[" + "-".join(str(v) for v in kw.values()) + "]", kw))
    return out


def _reference_cases():
    cases = []
    for mod in (ref_a, ref_b):
        for name, obj in vars(mod).items():
            if name.startswith("test_") and inspect.isfunction(obj):
                for sfx, kw in _expand(obj):
                    cases.append((f"{mod.__name__}::{name}{sfx}", mod, None,
                                  name, kw))
            if name.startswith("Test") and inspect.isclass(obj):
                for mname, fn in vars(obj).items():
                    if mname.startswith("test_"):
                        for sfx, kw in _expand(fn):
                            cases.append((f"{mod.__name__}::{name}::{mname}"
                                          f"{sfx}", mod, obj, mname, kw))
    return cases


CASES = _reference_cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_twin_of_reference_case(case, monkeypatch, tmp_path):
    _cid, mod, cls, name, kw = case
    monkeypatch.setattr(mod, "OnnxGraphMapper", TwinMapper)
    fn = getattr(cls(), name) if cls is not None else getattr(mod, name)
    if "tmp_path" in inspect.signature(fn).parameters:
        kw = dict(kw, tmp_path=tmp_path)
    fn(**kw)


def test_every_reference_case_is_twinned():
    assert len(CASES) >= 40


# --------------------------------------------------------------- the codec
def _graph(P):
    w = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    return P.make_graph(
        nodes=[P.make_node("Gemm", ["x", "w"], ["y"], transB=1, alpha=0.5),
               P.make_node("LeakyRelu", ["y"], ["z"], alpha=0.1),
               P.make_node("Transpose", ["z"], ["t"], perm=[1, 0])],
        name="g", inputs=[P.make_value_info("x", np.float32, (None, 4))],
        outputs=[P.make_value_info("t", np.float32, (3, None))],
        initializers=[P.make_tensor("w", w),
                      P.make_tensor("i", np.arange(5, dtype=np.int64))])


def _model(P):
    return P.make_model(_graph(P))


def test_codec_round_trip_across_packages():
    """Each package's bytes parse in the other's reader to the same tree,
    and both writers emit the same graph bytes."""
    jb, tb = _model(JP), _model(TP)
    for b in (jb, tb):
        jt, tt = JP.parse_model(b), TP.parse_model(b)
        assert jt["graph"] == tt["graph"]
        for init in tt["graph"]["initializer"]:
            np.testing.assert_array_equal(TP.tensor_to_np(init),
                                          JP.tensor_to_np(init))
    assert JP.parse_model(jb)["graph"] == TP.parse_model(tb)["graph"]
    assert _graph(JP) == _graph(TP)
    x = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
    got = TO.OnnxGraphMapper.import_model(jb, device="cpu").output(
        {"x": x}, "t")["t"]
    want = JO.OnnxGraphMapper.import_model(tb).output({"x": x}, "t")["t"]
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


# ------------------------------------------------------ trainable=True fit
def test_trainable_import_takes_three_adam_steps_as_the_reference():
    from deeplearning4j_tpu.autodiff import samediff as JS
    from deeplearning4j_tpu.data.dataset import DataSet as JDS
    from deeplearning4j_tpu.optim.updaters import Adam as JAdam
    from deeplearning4j_tpu_torch.autodiff import samediff as TS
    from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS
    from deeplearning4j_tpu_torch.optim.updaters import Adam as TAdam

    r = np.random.RandomState(4)
    w1, b1 = r.randn(8, 4).astype(np.float32) * 0.4, np.zeros(8, np.float32)
    w2, b2 = r.randn(2, 8).astype(np.float32) * 0.4, np.zeros(2, np.float32)
    model = ref_a._mlp_model(w1, b1, w2, b2)
    x = r.randn(16, 4).astype(np.float32)
    y = np.zeros((16, 2), np.float32)
    y[np.arange(16), (x.sum(1) > 0).astype(int)] = 1.0
    losses = []
    for O, S, DS, Adam, kw in (
            (JO, JS, JDS, JAdam, {}),
            (TO, TS, TDS, TAdam, {"device": "cpu"})):
        sd = O.OnnxGraphMapper.import_model(model, trainable=True, **kw)
        assert sorted(sd.trainable_names()) == ["b1", "b2", "w1", "w2"]
        labels = sd.placeholder("labels", (None, 2), np.float32)
        sd.loss.log_loss(labels, sd.get_variable("probs")).rename("loss")
        sd.set_loss_variables("loss")
        sd.set_training_config(S.TrainingConfig(
            updater=Adam(5e-2), data_set_feature_mapping=["x"],
            data_set_label_mapping=["labels"]))
        hist = sd.fit([DS(x, y)], epochs=3)
        losses.append([float(v) for v in hist])
        losses.append(_np(sd.get_variable("w1").get_arr()))
    np.testing.assert_allclose(losses[2], losses[0], atol=1e-5)
    np.testing.assert_allclose(losses[3], losses[1], atol=1e-5)


# ------------------------------------------------- tools/onnx_resnet.py
def test_onnx_resnet_three_ways():
    """A two-stage, width-16 ResNet of the zoo's blocks at (2, 3, 32, 32),
    its BatchNormalization statistics set from a training-mode forward:
    the port's ComputationGraph (NHWC), the port's import of the authored
    ONNX and the reference's import of the same bytes agree on logits and
    probabilities (atol 1e-5 on probabilities, 1e-4 on logits: f32 over
    two stages, sums in other orders)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.tools import onnx_resnet

    net = ComputationGraph(onnx_resnet.resnet_conf(
        (1, 1), 16, 10, (32, 32, 3), seed=7), device="cpu")
    net.init()
    rng = np.random.default_rng(3)
    calib = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        _a, states, _c = net._forward(net._params, net._states,
                                      (torch.as_tensor(calib),), True, None)
    net.set_state_tree(states)
    model = onnx_resnet.to_onnx(net, 2)
    kinds = {n["op_type"] for n in TP.parse_model(model)["graph"]["node"]}
    assert kinds == {"Pad", "Conv", "BatchNormalization", "Relu", "MaxPool",
                     "Add", "GlobalAveragePool", "Flatten", "Gemm",
                     "Softmax"}
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    xc = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    want = _np(net.output(x))
    port = TO.OnnxGraphMapper.import_model(model, device="cpu").output(
        {"input": xc}, ["logits", "output"])
    ref = JO.OnnxGraphMapper.import_model(model).output(
        {"input": xc}, ["logits", "output"])
    np.testing.assert_allclose(_np(port["output"]), want, atol=1e-5)
    np.testing.assert_allclose(_np(port["output"]), np.asarray(ref["output"]),
                               atol=1e-5)
    np.testing.assert_allclose(_np(port["logits"]), np.asarray(ref["logits"]),
                               atol=1e-4)
    assert float(np.std(_np(port["logits"]), axis=0).mean()) > 1e-3
