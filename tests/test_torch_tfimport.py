"""The port's TF GraphDef import (``modelimport/tfimport.py`` over its own
wire codec ``tf_proto.py``, and the skeletons of ``tf_skeleton.py``)
against the JAX package's importer and live TF, on the CPU: twins of
``tests/test_tf_import.py``, plus the tests' mini BERT (2 layers, width
32) at (2, 8).

Tolerances: the port against the JAX importer on the same GraphDef atol
1e-5 (f32 sums in another order); against live TF the JAX package's own
rows (atol 1e-5, 1e-4 for the exp/BN graphs and the BERT). 3 ``fit``
steps of the imported BERT against the JAX package's: losses atol 1e-5.
The codec is held to TF field by field. TF and transformers are imported
inside fixtures, so collecting this file costs nothing.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import samediff as J
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.modelimport.tfimport import TFGraphMapper as JG
from deeplearning4j_tpu.optim import updaters as JU
from deeplearning4j_tpu_torch.autodiff import samediff as T
from deeplearning4j_tpu_torch.data.dataset import MultiDataSet as TMDS
from deeplearning4j_tpu_torch.modelimport import tf_proto, tf_skeleton
from deeplearning4j_tpu_torch.modelimport.tfimport import TFGraphMapper as TG
from deeplearning4j_tpu_torch.modelimport.tfimport import TFImportError
from deeplearning4j_tpu_torch.optim import updaters as TU
from tests._torch_bert import attach_head, promote

ATOL_PORT = 1e-5


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _graph_def(tf, fn, input_specs):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    cf = tf.function(fn).get_concrete_function(
        *[tf.TensorSpec(s, tf.float32, name=n) for n, s in input_specs])
    frozen = convert_variables_to_constants_v2(cf)
    return frozen.graph.as_graph_def(), frozen


def _check(tf, fn, feeds, atol=1e-5):
    """The frozen graph of ``fn`` imported by the port from TF's bytes and
    by the JAX package from TF's proto: the port against TF at ``atol``,
    against the JAX import at ATOL_PORT."""
    gd, frozen = _graph_def(tf, fn, [(k, v.shape) for k, v in feeds.items()])
    expected = frozen(**{k: tf.constant(v) for k, v in feeds.items()})
    expected = np.asarray(expected[0] if isinstance(expected, (list, tuple))
                          else expected)
    out = [op.name for op in frozen.graph.get_operations()
           if op.type == "Identity"][-1]
    tsd = TG.import_graph(gd.SerializeToString(), device="cpu")
    jsd = JG.import_graph(gd)
    got = np_(tsd.output(feeds, out)[out])
    np.testing.assert_allclose(got, expected, atol=atol)
    np.testing.assert_allclose(got, np_(jsd.output(feeds, out)[out]),
                               atol=ATOL_PORT)
    assert [o.op_name for o in tsd.ops()] == [o.op_name for o in jsd.ops()]
    return tsd, jsd


# ------------------------------------------------------- twins of the graphs
def test_mlp_graph(tf):
    w1 = tf.constant(np.random.RandomState(0).randn(6, 8).astype("f4"))
    b1 = tf.constant(np.zeros(8, "f4"))
    w2 = tf.constant(np.random.RandomState(1).randn(8, 3).astype("f4"))

    def fn(x):
        return tf.nn.softmax(tf.matmul(tf.nn.relu(tf.matmul(x, w1) + b1), w2))

    _check(tf, fn, {"x": np.random.RandomState(2).rand(4, 6).astype("f4")})


def test_conv_pool_graph(tf):
    k = tf.constant(np.random.RandomState(0).randn(3, 3, 2, 4).astype("f4")
                    * 0.1)

    def fn(x):
        y = tf.nn.relu(tf.nn.conv2d(x, k, strides=1, padding="SAME"))
        return tf.reduce_mean(tf.nn.max_pool2d(y, 2, 2, "VALID"), axis=[1, 2])

    _check(tf, fn, {"x": np.random.RandomState(1).rand(2, 8, 8, 2)
                    .astype("f4")})


def test_elementwise_and_reshape(tf):
    def fn(x):
        y = tf.transpose(tf.reshape(x, [-1, 12]))
        y = tf.square(y) - tf.exp(y * 0.1)
        return tf.reduce_sum(y, axis=0, keepdims=True)

    _check(tf, fn, {"x": np.random.RandomState(3).rand(3, 4, 3)
                    .astype("f4")}, atol=1e-4)


def test_concat_pad_slice(tf):
    def fn(a, b):
        c = tf.pad(tf.concat([a, b], axis=1), [[0, 0], [1, 1]])
        return c[:, 1:-1]

    _check(tf, fn, {"a": np.random.RandomState(4).rand(2, 3).astype("f4"),
                    "b": np.random.RandomState(5).rand(2, 2).astype("f4")})


def test_batchnorm_inference_graph(tf):
    rs = np.random.RandomState
    g = tf.constant(rs(0).rand(5).astype("f4") + 0.5)
    be = tf.constant(rs(1).randn(5).astype("f4"))
    mu = tf.constant(rs(2).randn(5).astype("f4"))
    var = tf.constant(rs(3).rand(5).astype("f4") + 0.5)

    def fn(x):
        return tf.nn.batch_normalization(x, mu, var, be, g, 1e-3)

    _check(tf, fn, {"x": rs(6).rand(4, 5).astype("f4")}, atol=1e-4)


@pytest.mark.parametrize("case", ["rev", "last", "mid", "shrink_col"])
def test_strided_slice_negative_stride_and_shrink(tf, case):
    fns = {"rev": lambda x: x[::-1] + 1.0, "last": lambda x: x[-1] * 2.0,
           "mid": lambda x: x[1:3, ::-1], "shrink_col": lambda x: x[:, -1]}
    _check(tf, fns[case], {"x": np.arange(12, dtype="f4").reshape(4, 3)})


def test_unknown_op_raises_with_rule_hint(tf):
    gd, _ = _graph_def(tf, lambda x: tf.raw_ops.BesselI0e(x=x), [("x", (2,))])
    with pytest.raises(TFImportError, match="mapping rule"):
        TG.import_graph(gd.SerializeToString(), device="cpu")


def test_rule_whose_op_is_not_ported_raises_naming_it(tf):
    g = tf.Graph()
    with g.as_default():
        tf.raw_ops.RandomStandardNormal(shape=tf.constant([64, 8]),
                                        dtype=tf.float32, seed=5, name="rn")
    with pytest.raises(TFImportError,
                       match="random_normal_gen.*queue 1 item 9"):
        TG.import_graph(g.as_graph_def().SerializeToString(), device="cpu")
    g = tf.Graph()
    with g.as_default():
        tf.raw_ops.Sinh(x=tf.constant([1.0, 2.0]), name="s")
    # Sinh maps to the standard 'sinh': it imports
    sd = TG.import_graph(g.as_graph_def().SerializeToString(), device="cpu")
    np.testing.assert_allclose(np_(sd.output({}, "s")["s"]),
                               np.sinh([1.0, 2.0]), rtol=1e-6)
    g = tf.Graph()
    with g.as_default():
        tf.raw_ops.Expm1(x=tf.constant([1.0, 2.0]), name="e")
    with pytest.raises(TFImportError, match="'expm1'"):
        TG.import_graph(g.as_graph_def().SerializeToString(), device="cpu")


def test_stitch_and_addn_rules(tf):
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, (6, 3), name="x")
        tf.raw_ops.DynamicStitch(
            indices=[tf.constant([5, 1, 3]), tf.constant([0, 2, 4])],
            data=[x[:3], x[3:]], name="ds")
        a = tf.compat.v1.placeholder(tf.float32, (4,), name="a")
        b = tf.compat.v1.placeholder(tf.float32, (4,), name="b")
        tf.raw_ops.DynamicStitch(indices=[tf.constant(0), tf.constant(1)],
                                 data=[a, b], name="ds_scalar")
        tf.raw_ops.AddN(inputs=[a], name="addn1")
        tf.raw_ops.AddN(inputs=[a, b, a], name="addn3")
    feed = {"x": np.random.RandomState(3).randn(6, 3).astype(np.float32),
            "a": np.arange(4, dtype=np.float32),
            "b": np.arange(4, dtype=np.float32) + 10}
    names = ["ds", "ds_scalar", "addn1", "addn3"]
    with tf.compat.v1.Session(graph=g) as s:
        ref = s.run([f"{n}:0" for n in names],
                    {f"{k}:0": v for k, v in feed.items()})
    sd = TG.import_graph(g.as_graph_def().SerializeToString(), device="cpu")
    out = sd.output(feed, names)
    for n, r in zip(names, ref):
        np.testing.assert_allclose(np_(out[n]), r, atol=1e-6)


def test_imported_graph_trains_like_the_reference(tf):
    rng = np.random.RandomState(0)
    w = tf.constant(rng.randn(4, 2).astype("f4") * 0.1)
    gd, frozen = _graph_def(tf, lambda x: tf.nn.softmax(tf.matmul(x, w)),
                            [("x", (None, 4))])
    out = [op.name for op in frozen.graph.get_operations()
           if op.type == "Identity"][-1]
    X = rng.rand(32, 4).astype("f4")
    Y = np.eye(2)[(X @ [1.0, -1.0, 0.5, -0.5] > 0).astype(int)].astype("f4")
    hist = []
    for mod, upd, sd in (
            (J, JU, JG.import_graph(gd)),
            (T, TU, TG.import_graph(gd.SerializeToString(), device="cpu"))):
        (name,) = [n for n, v in sd._vars.items()
                   if v.var_type.value == "CONSTANT" and v.shape == (4, 2)]
        sd.get_variable(name).convert_to_variable()
        lab = sd.placeholder("label", (None, 2))
        sd.loss.log_loss(lab, sd.get_variable(out)).rename("loss")
        sd.set_training_config(mod.TrainingConfig(
            updater=upd.Adam(0.05), data_set_feature_mapping=["x"],
            data_set_label_mapping=["label"], loss_variables=["loss"]))
        hist.append(list(sd.fit({"x": X, "label": Y}, epochs=40)))
    np.testing.assert_allclose(hist[1], hist[0], atol=ATOL_PORT)
    assert hist[1][-1] < hist[1][0] * 0.9


# ------------------------------------------------------------- the codec
def _same(tf_msg, mine, path="GraphDef"):
    """Every field TF's message holds, held to the port's message field by
    field (fields the codec keeps raw are skipped)."""
    modeled = {name for name, _k, _r in type(mine).FIELDS.values()}
    for desc, value in tf_msg.ListFields():
        if desc.name not in modeled:
            continue
        got = getattr(mine, desc.name)
        where = f"{path}.{desc.name}"
        if desc.message_type is not None and desc.message_type.GetOptions() \
                .map_entry:
            assert sorted(value.keys()) == sorted(got.keys()), where
            for k in value:
                if hasattr(value[k], "ListFields"):
                    _same(value[k], got[k], f"{where}[{k}]")
                else:
                    assert value[k] == got[k], where
        elif desc.message_type is not None:
            items = list(value) if desc.label == desc.LABEL_REPEATED \
                else [value]
            gots = list(got) if desc.label == desc.LABEL_REPEATED else [got]
            assert len(items) == len(gots), where
            for i, (a, b) in enumerate(zip(items, gots)):
                _same(a, b, f"{where}[{i}]")
        elif desc.label == desc.LABEL_REPEATED:
            assert list(value) == list(got), where
        else:
            assert value == got, where
    for group in tf_msg.DESCRIPTOR.oneofs_by_name:
        assert tf_msg.WhichOneof(group) == mine.WhichOneof(group), path


def test_codec_reads_what_tf_serialized_field_by_field(mini_bert):
    _f, gd = mini_bert
    data = gd.SerializeToString()
    mine = tf_proto.parse_graph_def(data)
    assert len(mine.node) == len(gd.node) > 300
    _same(gd, mine)
    from tensorflow.core.framework import graph_pb2
    back = graph_pb2.GraphDef()
    back.ParseFromString(mine.SerializeToString())
    assert back == gd


def test_codec_function_library_and_while(tf):
    @tf.function
    def f(x):
        i = tf.constant(0)
        _, y = tf.while_loop(lambda i, a: i < 3,
                             lambda i, a: (i + 1, a * 2.0), [i, x])
        return tf.cond(tf.reduce_sum(y) > 0, lambda: y + 1.0, lambda: y)

    gd = f.get_concrete_function(tf.TensorSpec((2,), tf.float32, name="x")) \
        .graph.as_graph_def()
    mine = tf_proto.parse_graph_def(gd.SerializeToString())
    assert mine.HasField("library") and len(mine.library.function) >= 2
    _same(gd, mine)
    sig = mine.library.function[0].signature
    assert sig.name and sig.input_arg and sig.output_arg


# ------------------------------------------------------------- mini BERT
@pytest.fixture(scope="module")
def mini_bert(tf):
    pytest.importorskip("transformers")
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    from transformers import BertConfig, TFBertModel

    from deeplearning4j_tpu_torch.tools.bert_skeleton import PRESETS
    model = TFBertModel(BertConfig(hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0,
                                   **PRESETS["mini"]))

    @tf.function
    def f(input_ids, attention_mask):
        return model(input_ids=input_ids,
                     attention_mask=attention_mask).last_hidden_state

    frozen = convert_variables_to_constants_v2(f.get_concrete_function(
        tf.TensorSpec((2, 8), tf.int32, name="input_ids"),
        tf.TensorSpec((2, 8), tf.int32, name="attention_mask")))
    return f, frozen.graph.as_graph_def()


def _feed(seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 100, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    if ragged:
        mask[1, 5:] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _out_name(gd):
    return [n.name for n in gd.node if n.op == "Identity"][-1]


@pytest.mark.parametrize("graph_opt", ["1", "0"])
def test_mini_bert_against_live_tf_and_the_reference(mini_bert, graph_opt,
                                                     monkeypatch, tf):
    monkeypatch.setenv("DL4J_TPU_GRAPH_OPT", graph_opt)
    f, gd = mini_bert
    feed = _feed()
    tf_out = f(tf.constant(feed["input_ids"]),
               tf.constant(feed["attention_mask"])).numpy()
    tsd = TG.import_graph(gd.SerializeToString(), device="cpu")
    assert len(tsd.ops()) > 100
    out = _out_name(gd)
    got = np_(tsd.output(feed, out)[out])
    np.testing.assert_allclose(got, tf_out, atol=1e-4)
    ref = np.asarray(JG.import_graph(gd).output(feed, out)[out])
    np.testing.assert_allclose(got, ref, atol=ATOL_PORT)


def test_skeleton_filled_imports_as_the_full_graph(mini_bert):
    """The tool's strip, filled from a seed, imports to the graph the full
    GraphDef with those values imports to; the shipped mini skeleton is
    the same structure; an unfilled skeleton refuses to import."""
    from deeplearning4j_tpu_torch.tools.bert_skeleton import initializer_for
    _f, gd = mini_bert
    data = gd.SerializeToString()
    skel = tf_proto.parse_graph_def(data)
    n = tf_skeleton.strip(skel, lambda node: initializer_for(
        "x/kernel:0", 0.02))
    assert n == 15
    with pytest.raises(TFImportError, match="fill the skeleton"):
        TG.import_graph(skel, device="cpu")
    shipped = tf_skeleton.load_skeleton("bert_mini_b2_t8")
    assert sorted((x.name, x.op, list(x.input), sorted(x.attr))
                  for x in skel.node) == sorted(
        (x.name, x.op, list(x.input), sorted(x.attr)) for x in shipped.node)
    tf_skeleton.fill_skeleton(skel, seed=3)
    assert not tf_skeleton.marked_constants(skel)
    full = tf_proto.parse_graph_def(data)
    filled = {x.name: x for x in skel.node}
    for x in full.node:
        if x.op == "Const":
            x.attr["value"].tensor.tensor_content = \
                filled[x.name].attr["value"].tensor.tensor_content
    feed, out = _feed(), _out_name(gd)
    a = np_(TG.import_graph(skel, device="cpu").output(feed, out)[out])
    b = np_(TG.import_graph(full, device="cpu").output(feed, out)[out])
    np.testing.assert_array_equal(a, b)


def test_fill_raises_on_a_constant_left_empty(monkeypatch):
    """A filler that misses a marked constant is caught; so is a mark with
    an unknown initializer."""
    skel = tf_skeleton.load_skeleton("bert_mini_b2_t8")
    real = tf_skeleton.marked_constants
    calls = []

    def first_misses_one(gd):
        calls.append(1)
        found = real(gd)
        return found[:-1] if len(calls) == 1 else found

    monkeypatch.setattr(tf_skeleton, "marked_constants", first_misses_one)
    with pytest.raises(ValueError, match="left unfilled"):
        tf_skeleton.fill_skeleton(skel, seed=0)
    monkeypatch.setattr(tf_skeleton, "marked_constants", real)
    skel = tf_skeleton.load_skeleton("bert_mini_b2_t8")
    node, _init = real(skel)[0]
    node.attr[tf_skeleton.SKELETON_ATTR].s = b"uniform 0 1"
    with pytest.raises(ValueError, match="unknown skeleton initializer"):
        tf_skeleton.fill_skeleton(skel, seed=0)


# ----------------------------------- mini BERT from the shipped skeleton
def _filled_mini():
    return tf_skeleton.fill_skeleton(tf_skeleton.load_skeleton(
        "bert_mini_b2_t8"), seed=11)


def test_mini_bert_skeleton_matches_the_reference_import():
    """TF-free: the shipped skeleton filled from a seed, imported by both
    packages (the JAX importer reads the port's parsed GraphDef)."""
    gd = _filled_mini()
    feed, out = _feed(1), _out_name(gd)
    tsd = TG.import_graph(gd, device="cpu")
    jsd = JG.import_graph(gd)
    assert [o.op_name for o in tsd.ops()] == [o.op_name for o in jsd.ops()]
    np.testing.assert_allclose(np_(tsd.output(feed, out)[out]),
                               np.asarray(jsd.output(feed, out)[out]),
                               atol=ATOL_PORT)


@pytest.mark.parametrize("graph_opt", ["1", "0"])
def test_mini_bert_fine_tunes_like_the_reference(graph_opt, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_GRAPH_OPT", graph_opt)
    gd = _filled_mini()
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        f = _feed(int(rng.integers(1 << 30)))
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 2)]
        batches.append((f["input_ids"], f["attention_mask"], y))
    losses = []
    for mod, upd, graph, mds in (
            (J, JU, JG.import_graph(gd), JMDS),
            (T, TU, TG.import_graph(gd, device="cpu"), TMDS)):
        assert promote(graph, 64) > 10
        attach_head(mod, upd, graph, gd, lr=5e-3)
        losses.append(list(graph.fit([mds([i, m], [y])
                                      for i, m, y in batches])))
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-5)
    assert np.isfinite(losses[1]).all()


def test_import_without_tf_reads_bytes_and_paths(tmp_path):
    gd = _filled_mini()
    p = tmp_path / "mini.pb"
    p.write_bytes(gd.SerializeToString())
    feed, out = _feed(2), _out_name(gd)
    a = np_(TG.import_graph(str(p), device="cpu").output(feed, out)[out])
    b = np_(TG.import_graph(p.read_bytes(), device="cpu")
            .output(feed, out)[out])
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ control flow
@pytest.fixture
def v1_control_flow(tf):
    tf.compat.v1.disable_control_flow_v2()
    yield tf
    tf.compat.v1.enable_control_flow_v2()


def test_v1_while_and_cond_frames(v1_control_flow):
    """V1 frames (Enter/Merge/Switch/NextIteration/Exit) and a V1 cond,
    rebuilt as while/cond composites: the port against a v1 Session and
    the JAX import."""
    tf = v1_control_flow
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [2, 3], name="x")
        _, acc = tf.compat.v1.while_loop(
            lambda i, a: tf.less(i, 5), lambda i, a: (i + 1, a * 1.1 + 1.0),
            [tf.constant(0), x], name="loop")
        tf.identity(acc, name="out")
        y = tf.compat.v1.cond(tf.reduce_sum(x) > 0, lambda: x * 2.0,
                              lambda: x - 1.0)
        tf.identity(y, name="cond_out")
    gd = g.as_graph_def()
    assert any(n.op == "Enter" for n in gd.node)
    for seed in (0, 3):
        xv = np.random.default_rng(seed).normal(size=(2, 3)).astype(
            np.float32)
        with tf.compat.v1.Session(graph=g) as s:
            want = s.run(["out:0", "cond_out:0"], {"x:0": xv})
        tsd = TG.import_graph(gd.SerializeToString(), device="cpu")
        jsd = JG.import_graph(gd)
        for name, w in zip(("out", "cond_out"), want):
            got = np_(tsd.output({"x": xv}, name)[name])
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(
                got, np.asarray(jsd.output({"x": xv}, name)[name]),
                atol=ATOL_PORT)


def test_v2_while_rnn_imports_counts_its_trips_and_trains(tf):
    """A TF2 functional While (its body in the graph's function library)
    in the forward pass: the port against TF and the JAX import, the trip
    count proven, and the gradient through the loop against the
    reference's (jax.grad through its lax.scan lowering)."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    d, t, b = 16, 5, 3
    w = tf.Variable(tf.random.normal((2 * d, d), stddev=0.1, seed=1))

    @tf.function
    def f(x):
        def body(i, h):
            return i + 1, tf.tanh(tf.concat([x[:, i, :], h], 1) @ w)

        return tf.while_loop(lambda i, h: i < t, body,
                             [tf.constant(0), tf.zeros((b, d))])[1]

    gd = convert_variables_to_constants_v2(
        f.get_concrete_function(tf.TensorSpec((b, t, d), tf.float32,
                                              name="x")),
        lower_control_flow=False).graph.as_graph_def()
    xv = np.random.default_rng(0).normal(size=(b, t, d)).astype(np.float32)
    want = f(tf.constant(xv)).numpy()
    tsd = TG.import_graph(gd.SerializeToString(), device="cpu")
    jsd = JG.import_graph(gd)
    trips = [o.attrs.get("trip_count") for o in tsd.ops()
             if o.op_name == "__while__"]
    assert trips == [t] == [o.attrs.get("trip_count") for o in jsd.ops()
                            if o.op_name == "__while__"]
    out = _out_name(gd)
    got = np_(tsd.output({"x": xv}, out)[out])
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jsd.output({"x": xv}, out)
                                               [out]), atol=ATOL_PORT)
    grads = []
    for sd in (jsd, tsd):
        (name,) = [n for n, v in sd._vars.items()
                   if v.var_type.value == "CONSTANT" and v.shape == (2 * d, d)]
        sd.get_variable(name).convert_to_variable()
        sd.get_variable(out).sum().rename("loss")
        sd.set_loss_variables("loss")
        grads.append(np_(sd.calculate_gradients({"x": xv})[name]))
    np.testing.assert_allclose(grads[1], grads[0], atol=ATOL_PORT)
