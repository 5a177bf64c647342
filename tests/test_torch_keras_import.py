"""The port's Keras H5 import (``modelimport/keras.py`` over its own HDF5
reader ``modelimport/hdf5.py``) against the JAX package's (over h5py), on
the CPU.

Twins of ``tests/test_keras_import.py``: each of its non-slow cases that
goes through ``KerasModelImport`` runs as written, with
``KerasModelImport`` (and the lambda and custom-layer registries) standing
for both packages. Every file a case saves is imported by the port (on
the CPU) and by the reference: the params and BN statistics must be
carried exactly; every ``output`` the case asks of the reference is asked
of the port and held to it (shapes exactly, f32 values to atol 1e-5);
then fresh imports of both take one ``fit`` step (the imported Adam) on
that input, and their params must agree to atol 1e-5. Where the reference refuses a file, the
port must refuse it with the same exception type and message. The cases
that call the importer's internals or a layer directly have twins of
their own below.

Then the tool's models (``tools/keras_h5.py``): its ResNet-50 at 32² with
10 classes, port against reference; its config against
``tf.keras.applications.ResNet50``'s layer by layer (class, name and
inbound edges); its char-LSTM against the zoo's ``TextGenerationLSTM``
(R1) with the same weights; and the gate activation the reference ignores.
"""
import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import test_keras_import as ref_cases  # noqa: E402
from deeplearning4j_tpu.modelimport import keras as JK  # noqa: E402
from deeplearning4j_tpu.nn.conf import layers as JL  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import hdf5  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import keras as TK  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.tools import keras_h5  # noqa: E402

TOL = dict(atol=1e-5, rtol=0)
#: the reference's importer, kept before the twin stands in for it
REF_IMPORT = JK.KerasModelImport


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "toNumpy"):
        return np.asarray(x.toNumpy())
    return np.asarray(x)


def _outputs(x):
    return [_np(o) for o in x] if isinstance(x, (list, tuple)) else [_np(x)]


def _trees_equal(port, ref, what):
    ref = {k: v for k, v in ref.items() if v}
    port = {k: v for k, v in port.items() if v}
    assert sorted(port) == sorted(ref), (what, sorted(port), sorted(ref))
    for k in ref:
        assert sorted(port[k]) == sorted(ref[k]), (what, k)
        for p in ref[k]:
            a, b = _np(port[k][p]), np.asarray(ref[k][p])
            assert a.shape == b.shape, (what, k, p, a.shape, b.shape)
            assert np.array_equal(a, b), (what, k, p)


def _trees_close(port, ref):
    """Every param of ``ref`` within atol 1e-5 of the port's."""
    for k, layer in ref.items():
        for p, v in layer.items():
            np.testing.assert_allclose(_np(port[k][p]), np.asarray(v),
                                       err_msg=f"{k}/{p}", **TOL)


def _labels(want, rng):
    """Labels the shape of an output: one-hot rows where the output is a
    softmax (rows that sum to 1), else uniform [0, 1)."""
    if want.ndim >= 2 and np.allclose(want.sum(-1), 1.0, atol=1e-4):
        idx = rng.integers(0, want.shape[-1], want.shape[:-1])
        return np.eye(want.shape[-1], dtype=np.float32)[idx]
    return rng.random(want.shape).astype(np.float32)


class Twin:
    """Imports with both packages; the reference's net is returned, its
    ``output`` also asked of the port's and compared."""

    compared = 0
    fitted = 0

    @staticmethod
    def _import(path, sequential):
        port_fn = (TK.KerasModelImport.import_keras_sequential_model_and_weights
                   if sequential else
                   TK.KerasModelImport.import_keras_model_and_weights)
        ref_fn = (REF_IMPORT.import_keras_sequential_model_and_weights
                  if sequential else REF_IMPORT.import_keras_model_and_weights)
        port_err = None
        try:
            port = port_fn(path, device="cpu")
        except Exception as e:            # held against the reference's
            port_err = e
        try:
            ref = ref_fn(path)
        except Exception as e:
            assert port_err is not None, f"the port imported: {e}"
            assert type(port_err).__name__ == type(e).__name__
            assert str(port_err) == str(e)
            raise
        if port_err is not None:
            raise port_err
        _trees_equal(port.param_tree(), ref._params, "params")
        _trees_equal(port.state_tree(), ref._states, "states")
        return port, ref, port_fn, ref_fn

    @staticmethod
    def _twin(path, sequential):
        port, ref, port_fn, ref_fn = Twin._import(path, sequential)
        orig = ref.output
        first = []

        def output(*args, **kw):
            got = orig(*args, **kw)
            want = _outputs(got)
            mine = _outputs(port.output(*args, **kw))
            assert len(mine) == len(want)
            for a, b in zip(mine, want):
                assert a.shape == b.shape, (a.shape, b.shape)
                np.testing.assert_allclose(a, b, **TOL)
            Twin.compared += 1
            if not first:
                first.append(1)
                Twin._fit_step(path, port_fn, ref_fn, args, want)
            return got

        def fit(data, labels=None, epochs=1):
            ref_fit(data, labels, epochs=epochs)
            port.fit(data, labels, epochs=epochs)
            _trees_close(port.param_tree(), ref._params)
            Twin.compared += 1

        def score(dataset=None):
            want = ref_score(dataset)
            if dataset is not None:
                from deeplearning4j_tpu_torch.data.dataset import DataSet
                got = port.score(DataSet(_np(dataset.features),
                                         _np(dataset.labels)))
                np.testing.assert_allclose(got, want, rtol=1e-5)
                Twin.compared += 1
            return want

        ref_fit, ref_score = ref.fit, ref.score
        ref.output, ref.fit, ref.score = output, fit, score
        return ref

    @staticmethod
    def _fit_step(path, port_fn, ref_fn, args, want):
        """One ``fit`` step of fresh imports of both on ``args``, with
        labels the shape of the output; the params after it to atol
        1e-5."""
        inputs = args[0] if len(args) == 1 else args
        if isinstance(inputs, (list, tuple)) or len(want) != 1:
            return                        # several inputs or outputs
        y = _labels(want[0], np.random.default_rng(7))
        port, ref = port_fn(path, device="cpu"), ref_fn(path)
        try:
            ref.fit(inputs, y)
        except Exception as e:
            with pytest.raises(type(e)):
                port.fit(inputs, y)
            return
        port.fit(inputs, y)
        _trees_close(port.param_tree(), ref._params)
        Twin.fitted += 1

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path, enforce_training_config=False):
        return Twin._twin(path, True)

    @staticmethod
    def import_keras_model_and_weights(path):
        return Twin._twin(path, False)

    importKerasSequentialModelAndWeights = \
        import_keras_sequential_model_and_weights
    importKerasModelAndWeights = import_keras_model_and_weights


def _port_layer(layer):
    """The port's layer for a reference layer a custom builder made."""
    if isinstance(layer, JL.LambdaLayer):
        return TL.LambdaLayer(name=layer.name, fn=layer.fn,
                              output_type_fn=layer.output_type_fn)
    return TL.layer_from_dict(layer.to_dict())


@pytest.fixture
def twin(monkeypatch):
    import deeplearning4j_tpu.modelimport as jm
    plain_lambda = JK.register_lambda_layer
    plain_custom = JK.register_custom_layer

    def register_lambda_layer(name, fn, output_type_fn=None):
        plain_lambda(name, fn, output_type_fn)
        TK.register_lambda_layer(name, fn, output_type_fn)

    def register_custom_layer(name, builder):
        plain_custom(name, builder)
        TK.register_custom_layer(name, lambda cfg: _port_layer(builder(cfg)))

    for mod in (ref_cases, JK, jm):
        monkeypatch.setattr(mod, "KerasModelImport", Twin)
    monkeypatch.setattr(JK, "register_lambda_layer", register_lambda_layer)
    monkeypatch.setattr(JK, "register_custom_layer", register_custom_layer)
    Twin.compared = Twin.fitted = 0
    yield Twin
    TK._CUSTOM_LAYERS.clear()
    TL.LAMBDA_REGISTRY.clear()


def _slow(fn):
    return any(m.name == "slow" for m in getattr(fn, "pytestmark", []))


# the cases that call the importer's internals or a layer directly: twinned
# one by one below
OWN_TWINS = {
    "test_locally_connected_implementation_2_imported_impl3_rejected",
    "test_locally_connected_impl2_dense_kernel_extraction",
    "test_h5_nested_submodel_weights_do_not_collide",
    "TestLongTailLayers::test_separable_conv1d_causal_semantics",
    "test_deconv_output_padding_direct_layer_parity",
    "test_conv3d_transpose_output_padding_direct",
}


def _reference_cases():
    cases = []
    for name, obj in vars(ref_cases).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            cases.append((name, obj, None))
        elif name.startswith("Test") and inspect.isclass(obj):
            for meth, fn in vars(obj).items():
                if meth.startswith("test_") and inspect.isfunction(fn):
                    cases.append((f"{name}::{meth}", fn, obj))
    return [(n, f, c) for n, f, c in cases if not _slow(f)]


CASES = _reference_cases()


@pytest.mark.parametrize("name, fn, cls",
                         [c for c in CASES if c[0] not in OWN_TWINS],
                         ids=[c[0] for c in CASES if c[0] not in OWN_TWINS])
def test_reference_case(name, fn, cls, tmp_path, twin):
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in inspect.signature(
        fn).parameters else {}
    if cls is None:
        fn(**kwargs)
    else:
        fn(cls(), **kwargs)
    assert twin.compared > 0, "no output was compared"


def test_every_case_is_twinned():
    names = {c[0] for c in CASES}
    assert OWN_TWINS <= names
    assert len(names) >= 28


# ------------------------------------------------------ the cases' own twins
def test_locally_connected_implementation_2_imported_impl3_rejected():
    cfg = {"filters": 4, "kernel_size": [2, 2], "padding": "valid",
           "implementation": 2}
    assert TK._map_layer("LocallyConnected2D", dict(cfg)) is not None
    for impl in (3,):
        cfg["implementation"] = impl
        with pytest.raises(TK.UnsupportedKerasConfigurationException,
                           match="implementation") as port_err:
            TK._map_layer("LocallyConnected2D", dict(cfg))
        with pytest.raises(JK.UnsupportedKerasConfigurationException) as e:
            JK._map_layer("LocallyConnected2D", dict(cfg))
        assert str(port_err.value) == str(e.value)
    cfg["implementation"] = 1
    assert type(TK._map_layer("LocallyConnected2D", cfg)).__name__ == \
        type(JK._map_layer("LocallyConnected2D", cfg)).__name__


def test_locally_connected_impl2_dense_kernel_extraction():
    from deeplearning4j_tpu.nn.conf.layers2 import LocallyConnected2D as JLC
    from deeplearning4j_tpu_torch.nn.conf.layers2 import (
        LocallyConnected2D as TLC)
    rng = np.random.RandomState(0)
    ih = iw = 5
    kh = kw = 2
    cin, f = 3, 4
    oh = ow = 4
    w1 = rng.rand(oh * ow, kh * kw * cin, f).astype("f4")
    dense = np.zeros((ih, iw, cin, oh, ow, f), "f4")
    for o_r in range(oh):
        for o_c in range(ow):
            for dh in range(kh):
                for dw in range(kw):
                    for c in range(cin):
                        feat = (dh * kw + dw) * cin + c
                        dense[o_r + dh, o_c + dw, c, o_r, o_c, :] = \
                            w1[o_r * ow + o_c, feat]
    kw_ = dict(kernel_size=(kh, kw), n_in=cin, n_out=f, input_size=(ih, iw),
               has_bias=False)
    got = {}
    for kernel in (w1, dense):
        pa, pj = {}, {}
        TK._load_weights_into(TLC(**kw_), {"kernel": kernel}, pa, {}, "0")
        JK._load_weights_into(JLC(**kw_), {"kernel": kernel}, pj, {}, "0")
        assert np.array_equal(_np(pa["0"]["W"]), np.asarray(pj["0"]["W"]))
        got[kernel.ndim] = _np(pa["0"]["W"])
    np.testing.assert_allclose(got[3], got[6], atol=0)


def test_h5_nested_submodel_weights_do_not_collide(tmp_path):
    import h5py
    p = str(tmp_path / "w.h5")
    with h5py.File(p, "w") as f:
        g = f.create_group("model_weights").create_group("wrapper")
        g.create_group("dense_a").create_dataset(
            "kernel:0", data=np.ones((2, 2), "f4"))
        g.create_group("dense_b").create_dataset(
            "kernel:0", data=np.zeros((2, 2), "f4") + 7.0)
        f["model_weights"].create_group("simple").create_dataset(
            "kernel:0", data=np.full((3, 3), 2.0, "f4"))
    with h5py.File(p, "r") as f, hdf5.File(p) as g:
        ref, port = JK._H5Weights(f), TK._H5Weights(g)
        assert sorted(port.by_layer) == sorted(ref.by_layer)
        for layer in ref.by_layer:
            assert sorted(port.by_layer[layer]) == sorted(ref.by_layer[layer])
            for k, v in ref.by_layer[layer].items():
                assert np.array_equal(port.by_layer[layer][k], v)
        assert np.allclose(port.get("simple")["kernel"], 2.0)
        with pytest.raises(TK.UnsupportedKerasConfigurationException) as pe:
            port.get("wrapper")
        with pytest.raises(JK.UnsupportedKerasConfigurationException) as je:
            ref.get("wrapper")
        assert str(pe.value) == str(je.value)
        assert np.allclose(port.by_layer["wrapper"]["dense_b/kernel"], 7.0)


def test_separable_conv1d_causal_semantics():
    """The port's causal SeparableConv1D is the left-padded valid one, and
    equals the reference's on the same params."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.conf.layers2 import (
        SeparableConvolution1D as JS)
    from deeplearning4j_tpu_torch.nn.conf.layers2 import (
        SeparableConvolution1D as TS)
    x = np.random.RandomState(8).rand(2, 8, 3).astype("f4")
    kw = dict(kernel_size=3, dilation=2, n_in=3, n_out=4,
              weight_init="xavier")
    lc = TS(padding="causal", **kw)
    p = lc.init_params(torch.Generator().manual_seed(0))
    got, _ = lc.apply(p, torch.from_numpy(x))
    want, _ = TS(padding=0, **kw).apply(
        p, torch.from_numpy(np.pad(x, ((0, 0), (4, 0), (0, 0)))))
    assert tuple(got.shape) == (2, 8, 4)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    ref, _ = JS(padding="causal", **kw).apply(
        {k: jnp.asarray(_np(v)) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_deconv_output_padding_direct_layer_parity():
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.conf.layers import Deconvolution2D as JD
    from deeplearning4j_tpu_torch.nn.conf.layers import Deconvolution2D as TD
    rng = np.random.RandomState(1)
    for pad, op, s in (("same", (1, 1), (2, 2)), ("valid", (1, 0), (2, 2)),
                       ("valid", (2, 1), (3, 3))):
        x = rng.rand(2, 7, 9, 3).astype("f4")
        k = rng.rand(3, 3, 3, 5).astype("f4")
        kw = dict(kernel_size=(3, 3), stride=s,
                  padding=0 if pad == "valid" else pad, n_in=3, n_out=5,
                  has_bias=False, output_padding=op, activation="identity")
        z, _ = TD(**kw).apply({"W": torch.from_numpy(k)}, torch.from_numpy(x))
        zj, _ = JD(**kw).apply({"W": jnp.asarray(k)}, jnp.asarray(x))
        klt = tf.keras.layers.Conv2DTranspose(
            5, 3, strides=s, padding=pad, output_padding=op, use_bias=False)
        _ = klt(x)
        klt.set_weights([k.transpose(0, 1, 3, 2)])
        y = klt(x).numpy()
        assert tuple(z.shape) == y.shape, (pad, op, s, z.shape, y.shape)
        assert np.allclose(_np(z), y, atol=1e-4), (pad, op, s)
        np.testing.assert_allclose(_np(z), np.asarray(zj), **TOL)


def test_conv3d_transpose_output_padding_direct():
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.conf.layers2 import Deconvolution3D as JD
    from deeplearning4j_tpu_torch.nn.conf.layers2 import Deconvolution3D as TD
    rng = np.random.RandomState(2)
    x = rng.rand(2, 4, 5, 6, 2).astype("f4")
    k = rng.rand(3, 3, 3, 2, 3).astype("f4")
    kw = dict(kernel_size=(3, 3, 3), stride=(2, 2, 2), padding=0, n_in=2,
              n_out=3, has_bias=False, output_padding=(1, 1, 1),
              activation="identity")
    z, _ = TD(**kw).apply({"W": torch.from_numpy(k)}, torch.from_numpy(x))
    zj, _ = JD(**kw).apply({"W": jnp.asarray(k)}, jnp.asarray(x))
    klt = tf.keras.layers.Conv3DTranspose(
        3, 3, strides=2, padding="valid", output_padding=1, use_bias=False)
    _ = klt(x)
    klt.set_weights([k.transpose(0, 1, 2, 4, 3)])
    y = klt(x).numpy()
    assert tuple(z.shape) == y.shape
    assert np.allclose(_np(z), y, atol=1e-4)
    np.testing.assert_allclose(_np(z), np.asarray(zj), **TOL)


# ------------------------------------------------------- the tool's models
def _with_output_head(net, layers, reference):
    """``net`` with its Dense output layers made OutputLayers (the loss
    from the activation, as the sequential import promotes its last
    Dense), on the same params, BN statistics and a fresh updater."""
    conf = type(net.conf).from_json(net.conf.to_json())
    for name in conf.network_outputs:
        node = conf.nodes[name]
        d = node.layer
        if type(d) is layers.DenseLayer:
            keep = {f.name for f in dataclasses.fields(layers.OutputLayer)}
            node.layer = layers.OutputLayer(
                **{f.name: getattr(d, f.name)
                   for f in dataclasses.fields(d) if f.name in keep},
                loss_function={"softmax": "mcxent", "sigmoid": "xent"}.get(
                    d.activation, "mse"))
    if reference:
        new = type(net)(conf).init()
        new._params, new._states = dict(net._params), dict(net._states)
        new._opt_state = new._opt.init(new._params)
        return new
    new = type(net)(conf, device=net.device).init()
    new.set_param_tree(net.param_tree())
    new.set_state_tree(net.state_tree())
    new._opt_state = new._opt.init(new._leaves())
    return new


def test_tool_resnet50_port_against_reference(tmp_path):
    """The authored ResNet-50 at 32², 10 classes: params and BN statistics
    carried exactly, probabilities to atol 1e-5; the same refusal to fit
    the Dense head; with an OutputLayer head, one SGD step's displacement
    of each leaf to relative L2 1e-2 (floored at 1e-3 of the whole step) and its loss to 1e-5 relative."""
    path = str(tmp_path / "r50.h5")
    keras_h5.write_resnet50(path, (32, 32, 3), 10, seed=3)
    port = TK.KerasModelImport.import_keras_model_and_weights(path,
                                                              device="cpu")
    ref = JK.KerasModelImport.import_keras_model_and_weights(path)
    _trees_equal(port.param_tree(), ref._params, "params")
    _trees_equal(port.state_tree(), ref._states, "states")
    assert sum(1 for v in port.param_tree().values() if v) == 53 + 53 + 1
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3),
                                                 dtype=np.float32)
    want = _np(ref.output(x))
    np.testing.assert_allclose(_np(port.output(x)), want, **TOL)
    assert want.shape == (4, 10) and want.std() > 1e-3
    y = _labels(want, np.random.default_rng(1))
    # a functional import's head is the Dense layer Keras saved: neither
    # package trains it as it is; with the Dense made an OutputLayer
    # (softmax, mcxent) on the same params, both take a step
    with pytest.raises(ValueError):
        ref.fit(x, y)
    with pytest.raises(ValueError) as te:
        port.fit(x, y)
    assert "not a loss-bearing layer" in str(te.value)
    # SGD: the step is the gradient. 53 BN layers at init amplify f32
    # rounding (the two packages' gradients read ~1e-3 apart, relative,
    # and Adam's first step turns a gradient within rounding of 0 into
    # ±lr): each leaf's displacement is held by relative L2 at 1e-2
    from deeplearning4j_tpu.optim.updaters import Sgd as JSgd
    from deeplearning4j_tpu_torch.optim.updaters import Sgd as TSgd
    ref.conf.updater, port.conf.updater = JSgd(1e-2), TSgd(1e-2)
    ref, port = _with_output_head(ref, JL, True), _with_output_head(
        port, TL, False)
    base = {k: {p: np.asarray(v) for p, v in layer.items()}
            for k, layer in ref._params.items()}
    ref.fit(x, y)
    port.fit(x, y)
    np.testing.assert_allclose(port.score(), ref.score(), rtol=1e-5)
    steps = {(k, p): (_np(port.param_tree()[k][p]).astype(np.float64)
                      - base[k][p], np.asarray(v, np.float64) - base[k][p])
             for k, layer in ref._params.items() for p, v in layer.items()}
    # a convolution's bias ahead of a BN layer has no gradient in exact
    # arithmetic (the BN takes out any shift): each leaf's norm is
    # floored at 1e-3 of the whole step's
    whole = np.sqrt(sum(np.sum(w ** 2) for _, w in steps.values()))
    errs = {kp: np.linalg.norm(g - w) / max(np.linalg.norm(w),
                                            1e-3 * whole)
            for kp, (g, w) in steps.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-2, (worst, errs[worst])


def test_tool_resnet50_config_is_keras(tmp_path):
    """Layer by layer against the config Keras saves for
    ``tf.keras.applications.ResNet50``: the same layers in the same order,
    each its class, name, inbound edges and the fields the importer
    reads; the same weight paths and shapes."""
    import h5py
    model = tf.keras.applications.ResNet50(weights=None,
                                           input_shape=(32, 32, 3),
                                           classes=10)
    path = str(tmp_path / "keras_r50.h5")
    model.save(path)
    with h5py.File(path, "r") as f:
        want = json.loads(f.attrs["model_config"])
    got = keras_h5.resnet50_config((32, 32, 3), 10)
    # Keras numbers its input layers per process: "input_layer_2" after
    # two models; the tool's is the first's name
    text = json.dumps(want).replace(
        json.dumps(want["config"]["layers"][0]["name"]), '"input_layer"')
    want = json.loads(text)
    wl, gl = want["config"]["layers"], got["config"]["layers"]
    assert [ld["name"] for ld in gl] == [ld["name"] for ld in wl]
    read = ("filters", "kernel_size", "strides", "padding", "use_bias",
            "activation", "epsilon", "momentum", "pool_size", "units",
            "batch_shape", "dilation_rate")
    for w, g in zip(wl, gl):
        assert g["class_name"] == w["class_name"], w["name"]
        assert (TK._inbound_layer_names(g.get("inbound_nodes"))
                == TK._inbound_layer_names(w.get("inbound_nodes"))), w["name"]
        for k in read:
            assert g["config"].get(k) == w["config"].get(k), (w["name"], k)
    assert TK._output_names(got["config"]) == TK._output_names(
        want["config"])
    weights = keras_h5.resnet50_weights(got, seed=0)
    for i, layer in enumerate(model.layers):
        mine = weights[gl[i]["name"]]
        assert [p for p, _ in mine] == [v.path for v in layer.weights], \
            layer.name
        assert [a.shape for _, a in mine] == [tuple(v.shape)
                                              for v in layer.weights]


def test_keras_saved_resnet50_reads_like_the_tool(tmp_path):
    """A ResNet-50 that Keras itself saved imports through the port's
    reader as through the reference's h5py, exactly."""
    path = str(tmp_path / "keras_r50.h5")
    tf.keras.applications.ResNet50(weights=None, input_shape=(32, 32, 3),
                                   classes=10).save(path)
    port = TK.KerasModelImport.import_keras_model_and_weights(path,
                                                              device="cpu")
    ref = JK.KerasModelImport.import_keras_model_and_weights(path)
    _trees_equal(port.param_tree(), ref._params, "params")
    _trees_equal(port.state_tree(), ref._states, "states")
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3),
                                                 dtype=np.float32)
    np.testing.assert_allclose(_np(port.output(x)), _np(ref.output(x)), **TOL)


def test_char_lstm_computes_what_r1_computes(tmp_path):
    """The imported char-LSTM (two LSTM(256), a per-step softmax over 47
    characters) on the port's LSTM route (K11L on the card), against the
    zoo's TextGenerationLSTM (R1) carrying the same weights: the same
    probabilities over 50 steps; and the reference's import of the file."""
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    path = str(tmp_path / "char_lstm.h5")
    keras_h5.write_char_lstm(path, seed=5)
    net = TK.KerasModelImport.import_keras_sequential_model_and_weights(
        path, device="cpu")
    assert [type(l).__name__ for l in net.conf.layers] == [
        "LSTM", "LSTM", "OutputLayer"]
    assert [l.cell_route() for l in net.conf.layers[:2]] == ["k11_layer"] * 2
    r1 = TextGenerationLSTM(total_unique_characters=47,
                            tbptt_length=50).init_model(device="cpu")
    assert {k: {p: tuple(v.shape) for p, v in layer.items()}
            for k, layer in r1.param_tree().items()} == {
        k: {p: tuple(v.shape) for p, v in layer.items()}
        for k, layer in net.param_tree().items()}
    r1.set_param_tree(net.param_tree())
    rng = np.random.default_rng(4)
    x = np.eye(47, dtype=np.float32)[rng.integers(0, 47, (3, 50))]
    got = _np(net.output(x))
    assert got.shape == (3, 50, 47)
    np.testing.assert_allclose(got, _np(r1.output(x)), atol=1e-6, rtol=0)
    ref = JK.KerasModelImport.import_keras_sequential_model_and_weights(path)
    np.testing.assert_allclose(got, _np(ref.output(x)), **TOL)


def test_lstm_recurrent_activation_is_ignored_as_in_the_reference(tmp_path):
    """Reference behaviour, reproduced: LSTM reads ``activation`` but not
    ``recurrent_activation``, so a file whose LSTMs say ``hard_sigmoid``
    imports with sigmoid gates. Both packages import both files to the
    same function."""
    outs = {}
    x = np.eye(47, dtype=np.float32)[np.random.default_rng(6).integers(
        0, 47, (2, 50))]
    for gate in ("sigmoid", "hard_sigmoid"):
        config = keras_h5.char_lstm_config()
        for ld in config["config"]["layers"]:
            if ld["class_name"] == "LSTM":
                ld["config"]["recurrent_activation"] = gate
        path = str(tmp_path / f"{gate}.h5")
        keras_h5.save_model(path, config, keras_h5.char_lstm_weights(seed=2))
        port = TK.KerasModelImport.import_keras_sequential_model_and_weights(
            path, device="cpu")
        ref = JK.KerasModelImport.import_keras_sequential_model_and_weights(
            path)
        outs[gate] = _np(port.output(x))
        np.testing.assert_allclose(outs[gate], _np(ref.output(x)), **TOL)
    np.testing.assert_array_equal(outs["sigmoid"], outs["hard_sigmoid"])
