"""The port's MultiLayerNetwork and ComputationGraph against the JAX
package's, on the CPU at small sizes.

Two nets, built on each side from the same configuration:

- a narrow LeNet (``MultiLayerNetwork``): conv 5×5, max pool, conv, max
  pool, dense, softmax/mcxent output, ``convolutional_flat`` input;
- a narrow residual ``ComputationGraph`` made of ResNet-50's own pieces
  (each package's ``ResNet50`` block builders): ZeroPadding 3, the 7×7/s2
  conv without bias, BatchNormalization, ReLU, the 3×3/s2 max pool with
  padding 1, a conv block (stride 2, projection shortcut) and an identity
  block joined by ``ElementWiseVertex`` add, "same" 3×3 convs, global
  average pooling and the softmax/mcxent output, under ``Nesterovs``.

The reference's weights, BN states and optax state are carried across
(``set_param_tree``, ``set_state_tree``, ``set_updater_state_from_jax``),
then ``output``, ``score``, ``computeGradientAndScore`` and three ``fit``
steps (params, BN states, every updater-state leaf) are compared.
Tolerances (PERF.md states them):

- f32: outputs and losses atol 1e-5; each gradient leaf's relative L2
  ≤ 1e-5; after 3 steps, params and states atol 1e-5 and updater leaves
  atol 1e-5 — the same arithmetic, f32 sums in another order;
- ``data_type="bfloat16"``: losses atol 2e-2, outputs atol 2e-2, each
  gradient leaf's relative L2 ≤ 5e-2 — both sides round every hidden
  activation to bf16, at different points. Over 3 steps: every step's
  loss atol 2e-2; for the LeNet each leaf's displacement (params after −
  before) and each updater-state leaf within relative L2 1e-1 of the
  reference's. The reference sums a bf16 bias gradient in bf16
  (``lax.reduce`` in the VJP of the broadcast add: 2 % off the f32 sum on
  these shapes), the port in f32, and its jitted step rounds at other
  points than its eager ops. The residual net's bf16 gradients sit up to
  0.71 (relative L2) from its own f32 ones — leaves that are bf16 noise —
  so its trajectories separate and only its losses are held there.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.data import dataset as j_ds
from deeplearning4j_tpu.data import iterators as j_it
from deeplearning4j_tpu.models.zoo import resnet as j_resnet
from deeplearning4j_tpu.nn import graph as j_graph
from deeplearning4j_tpu.nn import graph_conf as j_gc
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu_torch.data import dataset as t_ds
from deeplearning4j_tpu_torch.data import iterators as t_it
from deeplearning4j_tpu_torch.models.zoo import resnet as t_resnet
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import graph_conf as t_gc
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.observability import numerics as t_num
from deeplearning4j_tpu_torch.optim import transforms as T
from deeplearning4j_tpu_torch.optim import updaters as t_upd

J = dict(cfg=j_cfg, L=j_layers, IT=j_inputs.InputType, U=j_upd, gc=j_gc,
         resnet=j_resnet, MLN=j_mln.MultiLayerNetwork,
         CG=j_graph.ComputationGraph)
P = dict(cfg=t_cfg, L=t_layers, IT=t_inputs.InputType, U=t_upd, gc=t_gc,
         resnet=t_resnet, MLN=t_mln.MultiLayerNetwork,
         CG=t_graph.ComputationGraph)
LR = 0.1


def lenet_conf(ns, dtype="float32", l2=None):
    L = ns["L"]
    b = (ns["cfg"].NeuralNetConfiguration.builder().seed(3)
         .updater(ns["U"].Nesterovs(LR, 0.9)).data_type(dtype)
         .weight_init("xavier"))
    if l2:
        b = b.l2(l2)
    return (b.list()
            .layer(L.ConvolutionLayer(kernel_size=(5, 5), n_out=4,
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(kernel_size=(5, 5), n_out=6,
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(n_out=16, activation="relu"))
            .layer(L.OutputLayer(n_out=10, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns["IT"].convolutional_flat(28, 28, 1))
            .build())


def residual_conf(ns, dtype="float32"):
    """ResNet-50's stem, a conv block and an identity block, narrow."""
    L, z = ns["L"], ns["resnet"].ResNet50(num_classes=5)
    g = (ns["cfg"].NeuralNetConfiguration.builder().seed(5)
         .updater(ns["U"].Nesterovs(LR, 0.9)).weight_init("relu")
         .data_type(dtype).graph_builder().add_inputs("input")
         .set_input_types(ns["IT"].convolutional(32, 32, 3)))
    g.add_layer("pad1", L.ZeroPaddingLayer(padding=(3, 3, 3, 3)), "input")
    x = z._conv_bn_act(g, "conv1", "pad1", 8, (7, 7), stride=(2, 2))
    g.add_layer("pool1", L.SubsamplingLayer(kernel_size=(3, 3),
                                            stride=(2, 2), padding=1), x)
    x = z._conv_block(g, 2, "a", "pool1", (4, 4, 8))
    x = z._identity_block(g, 2, "b", x, (4, 4, 8))
    g.add_layer("avgpool", L.GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("output", L.OutputLayer(n_out=5, activation="softmax",
                                        loss_function="mcxent"), "avgpool")
    return g.set_outputs("output").build()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _data(kind, n=6, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "lenet":
        x = rng.standard_normal((n, 784)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    else:
        x = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    return x, y


def build(kind, dtype="float32"):
    """(reference net, port net) with the reference's weights, states and
    updater state carried into the port."""
    conf = lenet_conf if kind == "lenet" else residual_conf
    cls = "MLN" if kind == "lenet" else "CG"
    ref = J[cls](conf(J, dtype)).init()
    net = P[cls](conf(P, dtype), device="cpu").init()
    carry(ref, net)
    return ref, net


def carry(ref, net):
    net.set_param_tree(_np_tree(ref.param_tree()))
    net.set_state_tree(_np_tree(ref.state_tree()))
    net.set_updater_state_from_jax(_np_tree(ref._opt_state))


def _out(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.toNumpy() if hasattr(a, "toNumpy") else a,
                      dtype=np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-12))


def _compare_trees(t_tree, j_tree, atol):
    for k in j_tree:
        for p in j_tree[k]:
            np.testing.assert_allclose(_out(t_tree[k][p]), _out(j_tree[k][p]),
                                       atol=atol, err_msg=f"{k}/{p}")


TOL = {"float32": dict(out=1e-5, loss=1e-5, grad=1e-5, step=1e-5),
       "bfloat16": dict(out=2e-2, loss=2e-2, grad=5e-2, step_rel=1e-1)}


@pytest.fixture(scope="module", params=[("lenet", "float32"),
                                        ("residual", "float32"),
                                        ("lenet", "bfloat16"),
                                        ("residual", "bfloat16")],
                ids=lambda p: "-".join(p))
def pair(request):
    kind, dtype = request.param
    return (kind, dtype) + build(kind, dtype)


def test_output_score_and_gradient_match_reference(pair):
    kind, dtype, ref, net = pair
    carry(ref, net)          # whatever the module's other tests did to ref
    tol = TOL[dtype]
    x, y = _data(kind)
    np.testing.assert_allclose(_out(net.output(x)), _out(ref.output(x)),
                               atol=tol["out"])
    # the reference's loss and gradient (graphs take input tuples): in f32
    # jitted (its eager dispatch is slow); in bf16 eager, op by op as the
    # port runs, since XLA's fusions round bf16 at other points, which this
    # residual net amplifies (0.108 in conv1's W)
    xs, ys = jnp.asarray(x), jnp.asarray(y)
    if kind == "residual":
        xs, ys = (xs,), (ys,)
    vg = jax.value_and_grad(ref._loss_fn, has_aux=True)
    (j_loss, _), j_grads = (jax.jit(vg) if dtype == "float32" else vg)(
        ref._params, ref._states, xs, ys, None, None, None)
    assert abs(net.score(t_ds.DataSet(x, y)) - float(j_loss)) <= tol["loss"]
    t_loss, t_grads = net.computeGradientAndScore(x, y)
    assert abs(t_loss - float(j_loss)) <= tol["loss"]
    assert sorted(t_grads) == sorted(j_grads)
    for k in j_grads:
        for p in j_grads[k]:
            err = _rel_l2(_out(t_grads[k][p]), _out(j_grads[k][p]))
            assert err <= tol["grad"], (k, p, err)


def test_three_fit_steps_match_reference(pair):
    kind, dtype, ref, net = pair
    carry(ref, net)
    tol = TOL[dtype]
    before = {k: {p: _out(v).copy() for p, v in layer.items()}
              for k, layer in net.param_tree().items()}
    for step in range(3):
        x, y = _data(kind, seed=10 + step)
        ref.fit(x, y)
        net.fit(x, y)
        assert abs(net.score() - ref.score()) <= tol["loss"], step
    j_state = jax.tree.leaves(ref._opt_state)
    t_state = T.state_leaves(net.updater_state())
    assert len(j_state) == len(t_state)
    counts = [b for b in t_state if isinstance(b, int)]
    assert len(counts) == 1 and counts[0] == int(
        [a for a in j_state if np.ndim(a) == 0][0]) >= 3
    # states keep their f32 dtype under the bf16 policy
    assert all(t.dtype == torch.float32 for layer in net.state_tree().values()
               for t in layer.values())
    if kind == "residual":
        # BN running stats moved off their init
        assert not torch.equal(net.state_tree()["conv1_bn"]["mean"],
                               torch.zeros(8))
    if dtype == "float32":
        _compare_trees(net.param_tree(), ref.param_tree(), tol["step"])
        _compare_trees(net.state_tree(), ref.state_tree(), tol["step"])
        for a, b in zip(j_state, t_state):
            if not isinstance(b, int):
                np.testing.assert_allclose(_out(b), _out(a),
                                           atol=tol["step"])
    elif kind == "lenet":
        for k in before:
            for p in before[k]:
                err = _rel_l2(_out(net.param_tree()[k][p]) - before[k][p],
                              _out(ref.param_tree()[k][p]) - before[k][p])
                assert err <= tol["step_rel"], (k, p, err)
        for a, b in zip(j_state, t_state):
            if not isinstance(b, int):
                assert _rel_l2(_out(b), _out(a)) <= tol["step_rel"]


@pytest.mark.parametrize("kind", ["lenet", "residual"])
def test_bf16_data_type_computes_hidden_layers_in_bf16(kind):
    """The bf16 rows above hold bf16 only from above; here the policy is
    held from below: on the same weights every hidden layer of the bf16
    net takes bf16 activations and params, the output layer f32 ones, and
    its output reads further from the f32 net's than the f32 row (1e-5)
    allows."""
    conf = lenet_conf if kind == "lenet" else residual_conf
    cls = "MLN" if kind == "lenet" else "CG"
    f32 = P[cls](conf(P), device="cpu").init()
    bf16 = P[cls](conf(P, "bfloat16"), device="cpu").init()
    bf16.set_param_tree(f32.param_tree())
    bf16.set_state_tree(f32.state_tree())
    layers = (bf16.layers if kind == "lenet" else
              [bf16.conf.nodes[n].layer for n in bf16.conf.topo_order
               if bf16.conf.nodes[n].layer is not None])
    seen = []
    for layer in layers:
        def spy(params, x, *a, _apply=layer.apply, **k):
            seen.append((x.dtype, {p.dtype for p in params.values()}))
            return _apply(params, x, *a, **k)
        layer.apply = spy
    x, _y = _data(kind)
    out = bf16.output(x)
    gap = np.abs(_out(out) - _out(f32.output(x))).max()
    assert gap > TOL["float32"]["out"], gap
    assert out.dtype == torch.float32 and len(seen) == len(layers)
    assert seen[-1] == (torch.float32, {torch.float32})
    assert {d for d, _p in seen[:-1]} == {torch.bfloat16}
    assert set().union(*(p for _d, p in seen[:-1])) == {torch.bfloat16}


def test_params_order_and_set_params_both_ways():
    ref, net = build("lenet")
    flat_j = np.asarray(ref.params().toNumpy())
    flat_t = _out(net.params())
    np.testing.assert_array_equal(flat_t, flat_j)
    assert net.numParams() == ref.numParams() == flat_t.size
    assert list(net.paramTable()) == list(ref.paramTable())
    for key in ref.paramTable():
        np.testing.assert_array_equal(_out(net.getParam(key)),
                                      _out(ref.getParam(key).toNumpy()))
    shifted = flat_j + 0.5
    net.setParams(shifted)
    ref.setParams(jnp.asarray(_out(net.params()) * 2))
    np.testing.assert_array_equal(_out(net.params()), shifted)
    np.testing.assert_array_equal(np.asarray(ref.params().toNumpy()),
                                  shifted * 2)
    net.setParams(net.params())
    np.testing.assert_array_equal(_out(net.params()), shifted)


def test_set_params_takes_the_reference_order_with_batchnorm():
    """The residual graph's flat vector in the reference's order (its
    ``flatten_params``: layer names sorted, BN's beta before gamma) loads
    into the port as the reference's param tree; the port's own round
    trip is the identity."""
    from deeplearning4j_tpu.nn import params as j_params
    ref, net = build("residual")
    other = P["CG"](residual_conf(P), device="cpu").init()
    other.setParams(np.asarray(j_params.flatten_params(ref.param_tree())))
    _compare_trees(other.param_tree(), ref.param_tree(), 0)
    np.testing.assert_array_equal(
        _out(net.params()),
        np.asarray(j_params.flatten_params(ref.param_tree())))
    before = _out(net.params())
    net.setParams(net.params())
    np.testing.assert_array_equal(_out(net.params()), before)


def _bn_mln(ns):
    L = ns["L"]
    return (ns["cfg"].NeuralNetConfiguration.builder().list()
            .layer(L.DenseLayer(n_out=3)).layer(L.BatchNormalization())
            .layer(L.OutputLayer(n_out=2))
            .set_input_type(ns["IT"].feed_forward(4)).build())


def test_reference_setparams_swaps_batchnorm_gamma_and_beta():
    """A fault of the JAX package (ROADMAP queue 3): its ``params()``
    packs in sorted order, its ``setParams`` unpacks in layer order, so
    ``setParams(params())`` swaps a BatchNormalization's gamma and beta.
    The port takes the reference's ``params()`` as its tree, and its own
    round trip is the identity."""
    ref = J["MLN"](_bn_mln(J)).init()
    net = P["MLN"](_bn_mln(P), device="cpu").init()
    ref._params["1"]["gamma"] = jnp.full((3,), 2.0)
    flat = np.asarray(ref.params().toNumpy())
    net.setParams(flat)
    _compare_trees(net.param_tree(), ref.param_tree(), 0)
    ref.setParams(jnp.asarray(flat))
    np.testing.assert_array_equal(np.asarray(ref._params["1"]["beta"]),
                                  np.full(3, 2.0, np.float32))
    net.setParams(net.params())
    np.testing.assert_array_equal(_out(net.param_tree()["1"]["gamma"]),
                                  np.full(3, 2.0, np.float32))


@pytest.mark.parametrize("kind", ["lenet", "residual"])
def test_configuration_json_loads_on_the_other_side(kind):
    conf = lenet_conf if kind == "lenet" else residual_conf
    j_conf, t_conf = conf(J), conf(P)
    if kind == "lenet":
        a = t_cfg.MultiLayerConfiguration.from_json(j_conf.to_json())
        b = j_cfg.MultiLayerConfiguration.from_json(t_conf.to_json())
    else:
        a = t_gc.ComputationGraphConfiguration.from_json(j_conf.to_json())
        b = j_gc.ComputationGraphConfiguration.from_json(t_conf.to_json())
        assert a.topo_order == j_conf.topo_order == b.topo_order
    assert a.to_json() == t_conf.to_json() == j_conf.to_json() == b.to_json()


def test_frozen_layers_match_reference():
    ref, net = build("lenet")
    ref._frozen = {"0", "4"}
    net._frozen = {"0", "4"}
    frozen_w = _out(net.getParam("0_W")).copy()
    for step in range(2):
        x, y = _data("lenet", seed=20 + step)
        ref.fit(x, y)
        net.fit(x, y)
    np.testing.assert_array_equal(_out(net.getParam("0_W")), frozen_w)
    _compare_trees(net.param_tree(), ref.param_tree(), 1e-5)


def test_l2_regularization_matches_reference():
    ref = J["MLN"](lenet_conf(J, l2=1e-2)).init()
    net = P["MLN"](lenet_conf(P, l2=1e-2), device="cpu").init()
    carry(ref, net)
    x, y = _data("lenet")
    assert abs(net.score(t_ds.DataSet(x, y))
               - ref.score(j_ds.DataSet(x, y))) <= 1e-5
    ref.fit(j_ds.DataSet(x, y))          # the fit(DataSet) form
    net.fit(t_ds.DataSet(x, y))
    _compare_trees(net.param_tree(), ref.param_tree(), 1e-5)


def test_nonfinite_step_is_skipped_with_every_tree_kept(monkeypatch):
    from deeplearning4j_tpu_torch.resilience import faults
    monkeypatch.setenv("DL4J_TPU_NUMERICS_SKIP", "1")
    _, net = build("residual")
    x, y = _data("residual")
    net.fit(x, y)
    params = {k: {p: v.clone() for p, v in layer.items()}
              for k, layer in net.param_tree().items()}
    states = {k: {p: v.clone() for p, v in layer.items()}
              for k, layer in net.state_tree().items()}
    opt = T.state_leaves(net.updater_state())
    plan = faults.FaultPlan([faults.FaultSpec("train.step", "nan",
                                              rate=1.0, count=1)])
    with faults.active(plan):
        net.fit(x, y)
    net.score()                    # the sync point publishes the health
    assert net.last_numerics["skipped"] is True
    assert net.last_numerics["loss_finite"] is False
    for k in params:
        for p in params[k]:
            assert torch.equal(net.param_tree()[k][p], params[k][p])
    for k in states:
        for p in states[k]:
            assert torch.equal(net.state_tree()[k][p], states[k][p])
    for a, b in zip(opt, T.state_leaves(net.updater_state())):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    assert t_num.tracker().snapshot()["nonfinite_events"]
    net.fit(x, y)                      # the next finite step trains again
    net.score()
    assert net.last_numerics["skipped"] is False
    assert not torch.equal(net.param_tree()["output"]["W"],
                           params["output"]["W"])


@pytest.mark.parametrize("async_on", ["1", "0"])
def test_fit_over_an_iterator_with_and_without_prefetch(monkeypatch,
                                                        async_on):
    """Two epochs over a ListDataSetIterator, with the device prefetch
    (DL4J_TPU_ASYNC=1) and without it, equal the reference's fit over its
    own iterator; ``evaluate`` sees the same predictions."""
    monkeypatch.setenv("DL4J_TPU_ASYNC", async_on)
    ref, net = build("lenet")
    x, y = _data("lenet", n=12, seed=30)
    ref.fit(j_it.ListDataSetIterator([j_ds.DataSet(x, y)], batch_size=4),
            epochs=2)
    it = t_it.ListDataSetIterator([t_ds.DataSet(x, y)], batch_size=4)
    net.fit(it, epochs=2)
    assert net.getIterationCount() == 6 and net.getEpochCount() == 2
    assert abs(net.score() - ref.score()) <= 1e-5
    _compare_trees(net.param_tree(), ref.param_tree(), 1e-5)
    ev_t = net.evaluate(it)
    ev_j = ref.evaluate(j_it.ListDataSetIterator([j_ds.DataSet(x, y)],
                                                 batch_size=4))
    np.testing.assert_array_equal(ev_t.confusion_matrix(),
                                  ev_j.confusion_matrix())


def test_prefetch_iterator_places_batches_on_the_device():
    x, y = _data("lenet", n=8)
    it = t_it.DevicePrefetchIterator(
        t_it.ListDataSetIterator([t_ds.DataSet(x, y)], batch_size=4),
        depth=2, device="cpu")
    got = list(it)
    assert len(got) == 2 and all(isinstance(d.features, torch.Tensor)
                                 for d in got)
    np.testing.assert_array_equal(got[1].features.numpy(), x[4:])
    it.close()


def test_listeners_see_every_score():
    """Every ported listener runs on the bus; the collector sees each
    iteration's float score, the metrics bridge counts them, the
    evaluative one evaluates at its frequency."""
    from deeplearning4j_tpu_torch.observability import global_registry
    from deeplearning4j_tpu_torch.optim import listeners as L
    _, net = build("lenet")
    x, y = _data("lenet", seed=40)
    collect = L.CollectScoresListener()
    evaluative = L.EvaluativeListener(
        t_it.ListDataSetIterator([t_ds.DataSet(x, y)]), frequency=2)
    net.setListeners(collect, evaluative, L.ScoreIterationListener(1),
                     L.PerformanceListener(1), L.TimeIterationListener(3),
                     L.MetricsReportingListener(prefix="test_networks"))
    for step in range(3):
        net.fit(*_data("lenet", seed=40 + step))
    assert collect.iterations == [1, 2, 3]
    assert all(np.isfinite(collect.scores))
    assert evaluative.last_evaluation.accuracy() >= 0
    text = global_registry().render_prometheus()
    assert 'test_networks_iterations_total{model="MultiLayerNetwork"} 3' \
        in text


def test_clone_and_summary():
    _, net = build("residual")
    x, _ = _data("residual")
    twin = net.clone()
    np.testing.assert_array_equal(_out(twin.output(x)), _out(net.output(x)))
    assert twin.numParams() == net.numParams()
    assert net.summary().splitlines()[-1] == \
        f"Total params: {net.numParams()}"


def test_feed_forward_and_predict():
    ref, net = build("lenet")
    x, _ = _data("lenet")
    acts = net.feedForward(x)
    ref_acts = ref.feedForward(x)
    assert len(acts) == len(ref_acts) == 7
    for a, b in zip(acts[1:], ref_acts[1:]):
        np.testing.assert_allclose(_out(a), _out(b), atol=1e-5)
    np.testing.assert_array_equal(_out(net.predict(x)).astype(int),
                                  np.asarray(ref.predict(x).toNumpy()))
    ref_g, net_g = build("residual")
    xr, _ = _data("residual")
    ff = net_g.feedForward(xr)
    ff_j = ref_g.feedForward(xr)
    assert sorted(ff) == sorted(ff_j)
    np.testing.assert_allclose(_out(ff["res2b_out"]),
                               _out(ff_j["res2b_out"]), atol=1e-5)


def test_remat_matches_plain_training():
    """``gradient_checkpointing`` recomputes activations in the backward
    and changes nothing else."""
    a = P["CG"](residual_conf(P), device="cpu").init()
    conf = residual_conf(P)
    conf.remat = True
    b = P["CG"](conf, device="cpu").init()
    b.set_param_tree(a.param_tree())
    x, y = _data("residual")
    a.fit(x, y)
    b.fit(x, y)
    _compare_trees(b.param_tree(), a.param_tree(), 1e-6)


@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_health_terms_match_reference(poison):
    """The step's numerics health against the reference's ``health_terms``
    on the same trees: norms rtol 1e-6, the finite flags equal."""
    from deeplearning4j_tpu.observability import numerics as j_num
    rng = np.random.default_rng(7)
    trees = [[rng.standard_normal(s).astype(np.float32) for s in
              ((3, 4), (4,), (2, 2, 3))] for _ in range(3)]
    if poison:
        trees[0][1][2] = float(poison)
    loss = np.float32(1.5)
    j = j_num.health_terms(jnp.asarray(loss),
                           *[[jnp.asarray(a) for a in t] for t in trees])
    t = t_num.health_terms(torch.tensor(loss),
                           *[[torch.from_numpy(a) for a in t] for t in trees])
    for k in ("loss_finite", "grads_finite", "skipped"):
        assert bool(t[k]) == bool(j[k]), k
    for k in ("grad_norm", "update_ratio"):
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-6)
