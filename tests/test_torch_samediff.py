"""The port's SameDiff (``deeplearning4j_tpu_torch/autodiff``) against the
JAX package's, on the CPU: twins of ``tests/test_samediff.py``.

Each graph is built by one builder in both packages and run on the same
seeded numpy inputs: outputs atol 1e-5 (f32 sums in another order),
gradients atol 1e-5, 3 ``fit`` steps' losses atol 1e-5 and the params
after them atol 1e-6 (the optimizer's f32 arithmetic on near-equal
gradients). Graph-building behaviour (names, shapes, dtypes, errors) is
held equal. The graph pass (``DL4J_TPU_GRAPH_OPT``) is run on and off.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.autodiff.samediff as J
import deeplearning4j_tpu_torch.autodiff.samediff as T
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.optim import updaters as JU
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.optim import updaters as TU

ATOL_OUT = 1e-5
ATOL_GRAD = 1e-5
ATOL_LOSS = 1e-5
ATOL_PARAM = 1e-6


class Pkg:
    """One package's SameDiff, updaters and DataSet under one name."""

    def __init__(self, mod, upd, ds, device):
        self.mod, self.upd, self.ds, self.device = mod, upd, ds, device

    def sd(self):
        return (self.mod.SameDiff.create(self.device) if self.device
                else self.mod.SameDiff.create())

    def config(self, **kw):
        return self.mod.TrainingConfig(**kw)


JAX = Pkg(J, JU, JDataSet, None)
TORCH = Pkg(T, TU, TDataSet, "cpu")


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def both(build, *args):
    return build(JAX, *args), build(TORCH, *args)


def assert_outputs(jsd, tsd, feed, names, atol=ATOL_OUT):
    a = jsd.output(feed, names)
    b = tsd.output(feed, names)
    for n in names:
        np.testing.assert_allclose(np_(b[n]), np_(a[n]), atol=atol,
                                   err_msg=n)


def linear(p):
    sd = p.sd()
    x = sd.placeholder("x", (None, 3), np.float32)
    w = sd.var("w", init=np.random.default_rng(0).normal(
        size=(3, 2)).astype(np.float32))
    b = sd.var("b", init=np.zeros(2, np.float32))
    sd.nn.tanh(x.mmul(w) + b).rename("y")
    return sd


# ------------------------------------------------------------- building
def test_variables_ops_shapes_and_names():
    def build(p):
        sd = p.sd()
        x = sd.placeholder("x", (2, 3))
        w = sd.var("w", (3, 4), init=np.ones((3, 4), np.float32))
        b = sd.var("b", init=np.zeros((4,), np.float32))
        out = sd.nn.softmax(x.mmul(w) + b).rename("out")
        y = x.reshape(6)
        z = x.sum(1)
        c1, c2 = sd.constant(1.0, "c"), sd.constant(2.0, "c")
        g = x[1:2, 2]
        return sd, out, y, z, (c1, c2), g

    (j, *jv), (t, *tv) = both(build)
    assert [o.op_name for o in j.ops()] == [o.op_name for o in t.ops()]
    assert j.variable_names() == t.variable_names()
    for a, b in zip(jv, tv):
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for va, vb in pairs:
            assert va.name == vb.name and va.shape == vb.shape
    assert "PLACEHOLDER" in t.summary() and "matmul" in t.summary()
    assert tv[0].var_type == T.VariableType.ARRAY


def test_dtypes_follow_the_reference():
    def build(p):
        sd = p.sd()
        x = sd.placeholder("x", (None, 4), np.float32)
        i = sd.placeholder("i", (3,), np.int32)
        outs = [sd._op("less", x, sd.constant(np.float32(0.0))),
                sd._op("argmax", x, axis=1), sd._op("shape_of", x),
                sd.constant(np.arange(3, dtype=np.int64)),
                sd.constant(np.ones(2, np.float64)), i * 2.0, i + 1,
                sd._op("reduce_mean", i), sd._op("cast", x, dtype="float64")]
        outs.append(sd._op("boolean_and", outs[0], outs[0]))
        return outs

    for a, b in zip(*both(build)):
        assert np.dtype(a.dtype).name == T._dt.name_of(b.dtype), (a, b)
        assert a.shape == b.shape, (a, b)


def test_dynamic_dim_keeps_dtype_and_rank_through_a_chain():
    sd = TORCH.sd()
    x = sd.placeholder("x", (None, 4), np.float32)
    a = sd._op("less", x, sd.constant(np.float32(0.0)))
    b = sd._op("boolean_and", a, a)
    assert a.dtype == b.dtype == torch.bool
    assert len(b.shape) == 2 and b.shape[0] is None


# ------------------------------------------------------------ execution
def test_output_eval_cache_and_default_outputs():
    jsd, tsd = both(linear)
    xin = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)
    assert_outputs(jsd, tsd, {"x": xin}, ["y"])
    y = tsd.get_variable("y")
    np_(y.eval({"x": xin}))
    np_(y.eval({"x": xin * 2}))
    assert len(tsd._compiled_cache) == 1
    assert list(tsd.output({"x": xin}).keys()) == ["y"]
    with pytest.raises(ValueError, match="missing placeholders"):
        tsd.output({}, ["y"])


def test_getitem_multi_output_lambda_and_namespaces():
    def build(p):
        sd = p.sd()
        x = sd.placeholder("x", (4, 6))
        x[1:3, 2].rename("g")
        x[::2, -1].rename("h")
        sd.nn.relu(x).rename("r_out")
        sd.math.square(x).rename("sq_out")
        sd.loss.huber_loss(x, x * 0.5).rename("huber")
        sd.loss.log_loss(sd.nn.sigmoid(x), sd.nn.sigmoid(x * 2)).rename("ll")
        return sd

    jsd, tsd = both(build)
    xin = np.arange(24, dtype=np.float32).reshape(4, 6) / 10
    assert_outputs(jsd, tsd, {"x": xin}, ["g", "h", "r_out", "sq_out",
                                          "huber", "ll"])
    sd = TORCH.sd()
    m = sd.placeholder("m", (3, 3))
    q, r = sd.linalg.qr(m)
    mi = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
    res = sd.output({"m": mi}, [q.name, r.name])
    np.testing.assert_allclose(np_(res[q.name]) @ np_(res[r.name]), mi,
                               atol=1e-5)
    v = sd.placeholder("v", (3,))
    sd.lambda_op(lambda a: torch.flip(a, (0,)) * 2.0, v).rename("lam")
    assert sd.get_variable("lam").shape == (3,)
    np.testing.assert_allclose(np_(sd.output({"v": [1., 2., 3.]}, "lam")
                                   ["lam"]), [6, 4, 2])


def test_cnn_rnn_and_loss_namespaces():
    def build(p):
        sd = p.sd()
        x = sd.placeholder("x", (1, 8, 8, 3))
        w = sd.var("w", init=np.random.default_rng(0).normal(
            size=(3, 3, 3, 4)).astype(np.float32) * 0.1)
        h = sd.cnn.conv2d(x, w, padding="SAME")
        sd.cnn.max_pooling2d(h, kernel=(2, 2), strides=(2, 2)).rename("p")
        xr = sd.placeholder("xr", (2, 3))
        wr = sd.var("wr", init=np.random.default_rng(1).normal(
            size=(7, 16)).astype(np.float32) * 0.1)
        br = sd.var("br", init=np.zeros(16, np.float32))
        h0 = sd.constant(np.zeros((2, 4), np.float32), "h0")
        h1, c1 = sd.rnn.lstm_cell(xr, h0, h0, wr, br)
        h1.rename("h1")
        c1.rename("c1")
        lab = sd.placeholder("labels", (4, 3))
        log = sd.placeholder("logits", (4, 3))
        sd.loss.softmax_cross_entropy(lab, log).rename("l")
        return sd

    jsd, tsd = both(build)
    rng = np.random.default_rng(0)
    feed = {"x": rng.normal(size=(1, 8, 8, 3)).astype(np.float32),
            "xr": rng.normal(size=(2, 3)).astype(np.float32),
            "labels": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)],
            "logits": rng.normal(size=(4, 3)).astype(np.float32)}
    assert tsd.get_variable("p").shape == (1, 4, 4, 4)
    assert_outputs(jsd, tsd, feed, ["p", "h1", "c1", "l"])


def test_random_ops_deterministic_per_seed():
    sd = TORCH.sd()
    sd.random.normal(0.0, 1.0, (400,)).rename("r")
    sd.random.uniform(-1.0, 2.0, (400,), seed=3).rename("u")
    a = np_(sd.output({}, "r", rng_seed=7)["r"])
    b = np_(sd.output({}, "r", rng_seed=7)["r"])
    c = np_(sd.output({}, "r", rng_seed=8)["r"])
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    assert abs(a.mean()) < 0.3 and abs(a.std() - 1) < 0.2
    u = np_(sd.output({}, "u")["u"])
    assert u.min() >= -1.0 and u.max() <= 2.0


def test_namespace_registry_fallthrough_and_unported_ops_raise():
    sd = TORCH.sd()
    x = sd.constant(np.asarray([[1.0, -2.0], [3.0, -4.0]], np.float32))
    out = sd.linalg.matrix_band_part(x, lower=0, upper=0)
    np.testing.assert_allclose(np_(sd.output({}, out.name)[out.name]),
                               [[1.0, 0.0], [0.0, -4.0]])
    out = sd.nn.hard_sigmoid(x)
    assert np.isfinite(np_(sd.output({}, out.name)[out.name])).all()
    with pytest.raises(KeyError, match="rgb_to_hsv"):
        sd.image.rgb_to_hsv(x)
    with pytest.raises(KeyError, match="bitwise_and"):
        sd.bitwise.and_(x, x)
    with pytest.raises(AttributeError):
        sd.nn.no_such_op
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        sd.set_mesh(None)


def test_image_ops_that_are_standard_run():
    def build(p):
        sd = p.sd()
        x = sd.placeholder("x", (1, 4, 4, 3))
        sd.image.resize_bilinear(x, 2, 3).rename("small")
        return sd

    jsd, tsd = both(build)
    img = np.random.default_rng(0).random((1, 4, 4, 3)).astype(np.float32)
    assert_outputs(jsd, tsd, {"x": img}, ["small"])


# ------------------------------------------------------------ gradients
def test_gradients_match_reference_and_finite_differences():
    def build(p):
        sd = linear(p)
        (sd.get_variable("y") * sd.get_variable("y")).mean().rename("loss")
        sd.set_loss_variables("loss")
        return sd

    jsd, tsd = both(build)
    xin = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)
    gj = jsd.calculate_gradients({"x": xin})
    gt = tsd.calculate_gradients({"x": xin})
    assert set(gt) == {"w", "b"}
    for n in gj:
        np.testing.assert_allclose(np_(gt[n]), np_(gj[n]), atol=ATOL_GRAD)
    w0 = np_(tsd.get_variable("w").get_arr()).copy()
    eps, fd = 1e-3, np.zeros_like(w0)
    for i in range(3):
        for k in range(2):
            for s in (eps, -eps):
                wp = w0.copy()
                wp[i, k] += s
                tsd.get_variable("w").set_arr(wp)
                fd[i, k] += np.sign(s) * float(
                    tsd.output({"x": xin}, "loss")["loss"])
    tsd.get_variable("w").set_arr(w0)
    np.testing.assert_allclose(np_(gt["w"]), fd / (2 * eps), atol=1e-2)


def regression(p, updater, l1=0.0, l2=0.0):
    sd = p.sd()
    x = sd.placeholder("x", (None, 3))
    y = sd.placeholder("y", (None, 1))
    w = sd.var("w", init=np.full((3, 1), 0.1, np.float32))
    b = sd.var("b", init=np.zeros((1,), np.float32))
    sd.loss.mse(y, x.mmul(w) + b).rename("loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(p.config(
        updater=updater(p), l1=l1, l2=l2, data_set_feature_mapping=["x"],
        data_set_label_mapping=["y"]))
    return sd


@pytest.mark.parametrize("name, make, l1, l2", [
    ("adam", lambda p: p.upd.Adam(0.05), 0.0, 0.0),
    ("nesterovs_l2", lambda p: p.upd.Nesterovs(0.05, 0.9), 0.0, 0.1),
    ("sgd_l1", lambda p: p.upd.Sgd(0.05), 0.01, 0.0),
])
def test_fit_three_steps_matches_reference(name, make, l1, l2):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    Y = (X @ np.array([[1.5], [-2.0], [0.5]], np.float32) + 0.3)
    jsd, tsd = both(regression, make, l1, l2)
    lj = jsd.fit([JAX.ds(X, Y)] * 3)
    lt = tsd.fit([TORCH.ds(X, Y)] * 3)
    np.testing.assert_allclose(lt.loss_curve(), lj.loss_curve(),
                               atol=ATOL_LOSS)
    for n in ("w", "b"):
        np.testing.assert_allclose(np_(tsd._values[n]), np_(jsd._values[n]),
                                   atol=ATOL_PARAM)


def test_l2_regularization_changes_loss():
    sd = TORCH.sd()
    x = sd.placeholder("x", (2, 2))
    sd.var("w", init=np.ones((2, 2), np.float32))
    (x.mmul(sd.get_variable("w"))).mean().rename("loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(T.TrainingConfig(
        updater=TU.Sgd(0.0), l2=1.0, data_set_feature_mapping=["x"]))
    losses = sd.fit([TDataSet(np.zeros((2, 2), np.float32), None)])
    assert abs(losses[0] - 4.0) < 1e-5


def test_listeners_and_epochs():
    seen = []

    class L:
        def iteration_done(self, sd, it, loss):
            seen.append(("it", it, loss))

        def on_epoch_end(self, sd, epoch):
            seen.append(("epoch", epoch))

    sd = regression(TORCH, lambda p: p.upd.Sgd(0.01))
    sd.add_listener(L())
    X = np.ones((4, 3), np.float32)
    h = sd.fit(iter([TDataSet(X, X[:, :1])] * 2), epochs=2)
    assert len(h) == 4 and h.final_loss() == h[-1]
    assert [e for e in seen if e[0] == "epoch"] == [("epoch", 1),
                                                    ("epoch", 2)]
    assert [e[1] for e in seen if e[0] == "it"] == [1, 2, 3, 4]


def test_evaluate_classification():
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

    sd = TORCH.sd()
    x = sd.placeholder("x", (None, 2))
    w = sd.var("w", init=np.asarray([[4.0, -4.0], [0.0, 0.0]], np.float32))
    sd.nn.softmax(x.mmul(w)).rename("probs")
    sd.set_training_config(T.TrainingConfig(
        updater=TU.Adam(1e-2), data_set_feature_mapping=["x"],
        data_set_label_mapping=["label"]))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 2)).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[(X[:, 0] > 0).astype(int)]
    it = ListDataSetIterator([TDataSet(X[i:i + 16], Y[i:i + 16])
                              for i in range(0, 64, 16)])
    assert sd.evaluate(it, "probs").accuracy() < 0.2
    Y2 = np.eye(2, dtype=np.float32)[(X[:, 0] <= 0).astype(int)]
    assert sd.evaluate(ListDataSetIterator([TDataSet(X, Y2)]),
                       "probs").accuracy() > 0.95


# ---------------------------------------------------------- control flow
def test_if_cond_matches_reference_and_carries_gradients():
    def build(p):
        sd = p.sd()
        x = sd.placeholder("x", (2,), np.float32)
        w = sd.var("w", init=np.array([1.0, 2.0], np.float32))
        sd.if_cond(x.sum() > 0, lambda s, a, ww: (a * ww).sum(),
                   lambda s, a, ww: (a * ww * 2.0).sum(), x,
                   w).rename("loss")
        sd.set_loss_variables("loss")
        sd.set_training_config(p.config(updater=p.upd.Adam(0.1),
                                        data_set_feature_mapping=["x"]))
        return sd

    jsd, tsd = both(build)
    for xin in ([1., 1.], [-1., -3.]):
        feed = {"x": np.array(xin, np.float32)}
        assert_outputs(jsd, tsd, feed, ["loss"])
        np.testing.assert_allclose(np_(tsd.calculate_gradients(feed)["w"]),
                                   np_(jsd.calculate_gradients(feed)["w"]),
                                   atol=ATOL_GRAD)
    lj = jsd.fit({"x": np.array([1., 1.], np.float32)}, epochs=3)
    lt = tsd.fit({"x": np.array([1., 1.], np.float32)}, epochs=3)
    np.testing.assert_allclose(list(lt), list(lj), atol=ATOL_LOSS)
    with pytest.raises(ValueError, match="matching"):
        tsd.if_cond(tsd.get_variable("x").sum() > 0.0,
                    lambda s, a: a.sum(), lambda s, a: a * 1.0,
                    tsd.get_variable("x"))


def test_counted_while_matches_jax_grad():
    """A counted loop records its trip count and trains: its gradient is
    held against jax.grad of the reference's lax.scan lowering."""
    def build(p):
        sd = p.sd()
        i0 = sd.constant(np.int32(0), name="i0")
        w = sd.var("w", init=np.array([0.9, 1.1], np.float32))
        x = sd.placeholder("x", (2,), np.float32)
        _, acc = sd.while_loop(lambda s, i, a, ww: i < 4,
                               lambda s, i, a, ww: (i + 1, a * ww + 1.0, ww),
                               i0, x, w)[:2]
        acc.sum().rename("loss")
        sd.set_loss_variables("loss")
        return sd

    jsd, tsd = both(build)
    assert [o.attrs.get("trip_count") for o in tsd.ops()
            if o.op_name == "__while__"] == [4]
    feed = {"x": np.array([0.5, -1.0], np.float32)}
    assert_outputs(jsd, tsd, feed, ["loss"])
    np.testing.assert_allclose(np_(tsd.calculate_gradients(feed)["w"]),
                               np_(jsd.calculate_gradients(feed)["w"]),
                               atol=ATOL_GRAD)


def test_dynamic_while_over_a_dynamic_dim_placeholder():
    def build(p):
        sd = p.sd()
        x = sd.placeholder("x", (None, 3), np.float32)
        i0 = sd.constant(np.float32(0.0), name="i0")
        out = sd.while_loop(lambda s, v, i: v.sum() < 50.0,
                            lambda s, v, i: (v * 2.0, i + 1.0), x, i0)
        out[0].rename("v")
        out[1].rename("trips")
        return sd

    jsd, tsd = both(build)
    assert all("trip_count" not in o.attrs for o in tsd.ops())
    assert tsd.get_variable("v").shape == jsd.get_variable("v").shape \
        == (None, None)
    feed = {"x": np.ones((2, 3), np.float32)}
    assert_outputs(jsd, tsd, feed, ["v", "trips"])
    i0 = tsd.constant(np.int32(9), name="i9")
    with pytest.raises(ValueError, match="preserve"):
        tsd.while_loop(lambda s, i: i > 0, lambda s, i: i / 2.0, i0)


# -------------------------------------------------------- graph passes
def moments_graph(p, sg=False):
    sd = p.sd()
    x = sd.placeholder("x", (4, 8))
    w = sd.var("w", init=np.eye(8, dtype=np.float32))
    h = x.mmul(w)
    m = sd._op("Mean", h, axis=(1,), keepdims=True)
    ms = sd._op("stop_gradient" if sg else "Identity", m)
    sq = sd._op("SquaredDifference", h, ms)
    v = sd._op("Mean", sq, axis=(1,), keepdims=True).rename("var")
    yhat = (h - m) * sd._op("rsqrt", v + sd.constant(np.float32(1e-5)))
    ph = sd.placeholder("y", (4, 8))
    sd.loss.mse(ph, yhat).rename("loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(p.config(updater=p.upd.Sgd(0.05),
                                    data_set_feature_mapping=["x"],
                                    data_set_label_mapping=["y"]))
    return sd


@pytest.mark.parametrize("graph_opt", ["1", "0"])
def test_moments_pass_on_and_off_matches_reference(graph_opt, monkeypatch):
    from deeplearning4j_tpu_torch.autodiff.passes import (
        fuse_two_pass_moments)

    monkeypatch.setenv("DL4J_TPU_GRAPH_OPT", graph_opt)
    jsd, tsd = both(moments_graph)
    _, n = fuse_two_pass_moments(tsd.ops())
    assert n == 1
    assert all(o.op_name != "one_pass_variance" for o in tsd.ops())
    rng = np.random.default_rng(2)
    X = rng.normal(1.0, 1.0, (4, 8)).astype(np.float32)
    Y = rng.normal(0.0, 1.0, (4, 8)).astype(np.float32)
    assert_outputs(jsd, tsd, {"x": X, "y": Y}, ["var", "loss"])
    np.testing.assert_allclose(np_(tsd.output({"x": X}, "var")["var"]),
                               np.var(X, 1, keepdims=True), atol=1e-5)
    lj = jsd.fit([JAX.ds(X, Y)] * 3)
    lt = tsd.fit([TORCH.ds(X, Y)] * 3)
    np.testing.assert_allclose(list(lt), list(lj), atol=ATOL_LOSS)
    np.testing.assert_allclose(np_(tsd._values["w"]), np_(jsd._values["w"]),
                               atol=ATOL_PARAM)


def test_stop_gradient_fuses_on_the_mean_side_only():
    from deeplearning4j_tpu_torch.autodiff.passes import (
        fuse_two_pass_moments)

    def graph(sg_on_x):
        sd = TORCH.sd()
        x = sd.placeholder("x", (4, 8))
        m = sd._op("Mean", x, axis=(1,), keepdims=True)
        msg = sd._op("stop_gradient", m)
        xs = sd._op("stop_gradient", x) if sg_on_x else x
        sq = sd._op("SquaredDifference", xs, msg)
        sd._op("Mean", sq, axis=(1,), keep_dims=True).rename("var")
        return sd

    assert fuse_two_pass_moments(graph(False).ops())[1] == 1
    assert fuse_two_pass_moments(graph(True).ops())[1] == 0
    X = np.random.default_rng(5).normal(0, 1, (4, 8)).astype(np.float32)
    np.testing.assert_allclose(np_(graph(False).output({"x": X})["var"]),
                               np.var(X, 1, keepdims=True), atol=1e-5)


# ------------------------------------------------------------ attention
def test_attention_op_in_a_graph_matches_reference():
    """The registry's attention (K1/K2 on the card; their plain versions
    here) inside a SameDiff graph, with a ragged key mask: output and
    gradients against the reference's op."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
               for _ in range(3))
    mask = (np.arange(8)[None, :] < np.array([5, 8])[:, None])[
        :, None, None, :]
    proj = rng.standard_normal((2, 2, 8, 16)).astype(np.float32)

    def build(p):
        sd = p.sd()
        qv, kv, vv = (sd.var(n, init=a) for n, a in (("q", q), ("k", k),
                                                      ("v", v)))
        m = sd.placeholder("mask", (2, 1, 1, 8), np.bool_)
        att = sd.nn.multi_head_dot_product_attention(qv, kv, vv, m)
        att.rename("att")
        (att * sd.constant(proj)).sum().rename("loss")
        sd.set_loss_variables("loss")
        return sd

    jsd, tsd = both(build)
    assert_outputs(jsd, tsd, {"mask": mask}, ["att"])
    gj = jsd.calculate_gradients({"mask": mask})
    gt = tsd.calculate_gradients({"mask": mask})
    for n in ("q", "k", "v"):
        np.testing.assert_allclose(np_(gt[n]), np_(gj[n]), atol=ATOL_GRAD)


# ------------------------------------------------------------ persistence
def test_save_load_roundtrip_and_lambda_refusal(tmp_path):
    sd = linear(TORCH)
    sd.set_loss_variables("y")
    path = str(tmp_path / "model.sdz")
    sd.save(path)
    sd2 = T.SameDiff.load(path, device="cpu")
    xin = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_array_equal(np_(sd.output({"x": xin}, "y")["y"]),
                                  np_(sd2.output({"x": xin}, "y")["y"]))
    assert sd2._loss_variables == ["y"]
    sd.lambda_op(lambda a: a * 2, sd.get_variable("x"))
    with pytest.raises(ValueError, match="lambda"):
        sd.save(str(tmp_path / "m.sdz"))


def test_control_flow_survives_zip(tmp_path):
    sd = TORCH.sd()
    x = sd.placeholder("x", (3,), np.float32)
    sd.if_cond(x.sum() > 0.0, lambda s, a: a * 2.0, lambda s, a: a - 1.0,
               x).rename("out")
    p = str(tmp_path / "cf.zip")
    sd.save(p)
    sd2 = T.SameDiff.load(p, device="cpu")
    for xin in ([1., 2., 3.], [-1., -2., -3.]):
        feed = {"x": np.array(xin, np.float32)}
        np.testing.assert_array_equal(np_(sd2.output(feed, "out")["out"]),
                                      np_(sd.output(feed, "out")["out"]))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.SameDiff.create()


# ------------------------------------------------------------ validation
def test_grad_check_and_vjp_check_in_f64():
    """The f64 gradient checks (``autodiff/validation.py``): a correct
    gradient passes, a wrong one is caught at its element."""
    from deeplearning4j_tpu_torch.autodiff import validation

    rng = np.random.default_rng(0)
    params = {"w": torch.as_tensor(rng.normal(size=(3, 2)).astype(
        np.float32)), "b": [torch.as_tensor(np.zeros(2, np.float32))]}
    x = torch.as_tensor(rng.normal(size=(4, 3)))

    def loss(p):
        return torch.tanh(x @ p["w"] + p["b"][0]).square().mean()

    assert validation.grad_check(loss, params)

    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a.square().sum()

        @staticmethod
        def backward(ctx, g):
            return torch.ones(3, 2, dtype=torch.float64) * g

    with pytest.raises(AssertionError, match="Gradient check FAILED"):
        validation.grad_check(lambda p: Wrong.apply(p["w"]), params)
    assert validation.check_vjp(lambda a, b: torch.sin(a) * b + a @ b.T @ a,
                                x, x * 2)
