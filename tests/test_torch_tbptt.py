"""Truncated BPTT and ``rnnTimeStep`` of the port's MultiLayerNetwork and
ComputationGraph against the JAX package's, on the CPU at small sizes.

The net is a char-RNN in miniature: two LSTMs (or GravesLSTMs) of 6 and
an ``RnnOutputLayer`` (softmax, mcxent) over 5 symbols, ``Adam(1e-2)``,
TBPTT 7 over sequences of 21 (one ``fit`` is 3 chunks), as a
``MultiLayerNetwork`` and as the same layers in a ``ComputationGraph``.
The reference's weights and optax state are carried across; then one
``fit`` on each side: the iteration count, each chunk's loss (from a
listener), the params and every updater leaf after the fit. Tolerances
(PERF.md states them): f32 atol 1e-5 (the same arithmetic, sums in
another order); ``data_type="bfloat16"`` each chunk's loss atol 2e-2 and
each leaf's displacement within relative L2 1e-1 of the reference's (the
networks' bf16 rows, ``test_torch_networks.py``; the reference's compiled
step also leaves the first layer's x·W unrounded, see
``test_torch_rnn_cell.py``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import graph as j_graph
from deeplearning4j_tpu.nn import graph_conf as j_gc
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import graph_conf as t_gc
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
from deeplearning4j_tpu_torch.optim import transforms as T
from deeplearning4j_tpu_torch.optim import updaters as t_upd

J = dict(cfg=j_cfg, L=j_layers, IT=JIT, U=j_upd, gc=j_gc,
         MLN=j_mln.MultiLayerNetwork, CG=j_graph.ComputationGraph)
P = dict(cfg=t_cfg, L=t_layers, IT=TIT, U=t_upd, gc=t_gc,
         MLN=t_mln.MultiLayerNetwork, CG=t_graph.ComputationGraph)
V, HID, N, T_LEN, TBPTT = 5, 6, 3, 21, 7


def _builder(ns, dtype):
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(1)
            .updater(ns["U"].Adam(1e-2)).data_type(dtype)
            .weight_init("xavier"))


def mln_conf(ns, dtype="float32", kind="LSTM"):
    L = ns["L"]
    return (_builder(ns, dtype).list()
            .layer(getattr(L, kind)(n_in=V, n_out=HID, activation="tanh"))
            .layer(getattr(L, kind)(n_out=HID, activation="tanh"))
            .layer(L.RnnOutputLayer(n_out=V, activation="softmax",
                                    loss_function="mcxent"))
            .backprop_type("tbptt").t_bptt_length(TBPTT)
            .set_input_type(ns["IT"].recurrent(V)).build())


def graph_conf(ns, dtype="float32", kind="LSTM"):
    L = ns["L"]
    return (_builder(ns, dtype).graph_builder().add_inputs("in")
            .set_input_types(ns["IT"].recurrent(V))
            .add_layer("l0", getattr(L, kind)(n_out=HID, activation="tanh"),
                       "in")
            .add_layer("l1", getattr(L, kind)(n_out=HID, activation="tanh"),
                       "l0")
            .add_layer("out", L.RnnOutputLayer(n_out=V, activation="softmax",
                                               loss_function="mcxent"), "l1")
            .set_outputs("out").backprop_type("tbptt")
            .t_bptt_length(TBPTT).build())


class Scores:
    """A listener that keeps every iteration's score."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append(score)

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _data(seed=0, n=N, t_len=T_LEN):
    rng = np.random.default_rng(seed)
    x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (n, t_len))]
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (n, t_len))]
    return x, y


def _masks():
    """Feature and label masks (N, T): a row cut at 16 (inside chunk 2), a
    row with a gap across the first chunk boundary, a full row."""
    m = np.ones((N, T_LEN), np.float32)
    m[0, 16:] = 0
    m[1, 5:9] = 0
    return m


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


def build(net_kind, dtype, kind):
    conf = mln_conf if net_kind == "mln" else graph_conf
    cls = "MLN" if net_kind == "mln" else "CG"
    ref = J[cls](conf(J, dtype, kind)).init()
    net = P[cls](conf(P, dtype, kind), device="cpu").init()
    net.set_param_tree(_np_tree(ref.param_tree()))
    net.set_updater_state_from_jax(_np_tree(ref._opt_state))
    return ref, net


def _fit_both(ref, net, masked):
    x, y = _data()
    rs, ts = Scores(), Scores()
    ref.setListeners(rs)
    net.setListeners(ts)
    before = {k: {p: v.detach().numpy().copy() for p, v in layer.items()}
              for k, layer in net.param_tree().items()}
    if masked:
        m = _masks()
        if isinstance(ref, J["MLN"]):
            from deeplearning4j_tpu.data.dataset import DataSet as JDS
            from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS
            ref.fit(JDS(x, y, m, m))
            net.fit(TDS(x, y, m, m))
        else:
            from deeplearning4j_tpu.data.dataset import (
                MultiDataSet as JMDS)
            from deeplearning4j_tpu_torch.data.dataset import (
                MultiDataSet as TMDS)
            ref.fit(JMDS([x], [y], [m], [m]))
            net.fit(TMDS([x], [y], [m], [m]))
    else:
        ref.fit(x, y)
        net.fit(x, y)
    return rs.scores, ts.scores, before


CASES = [("mln", "float32", "LSTM", False), ("mln", "float32", "GravesLSTM",
                                             True),
         ("graph", "float32", "LSTM", True),
         ("graph", "float32", "GravesLSTM", False),
         ("mln", "bfloat16", "LSTM", False),
         ("graph", "bfloat16", "GravesLSTM", False)]


@pytest.mark.parametrize("net_kind,dtype,kind,masked", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_tbptt_fit_matches_reference(net_kind, dtype, kind, masked):
    ref, net = build(net_kind, dtype, kind)
    j_scores, t_scores, before = _fit_both(ref, net, masked)
    assert net.getIterationCount() == ref.getIterationCount() == 3
    assert len(t_scores) == len(j_scores) == 3
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(t_scores, j_scores, atol=tol)
    assert net.score() == t_scores[-1]
    jp, tp = ref.param_tree(), net.param_tree()
    assert sorted(tp) == sorted(jp)
    j_state = [a for a in jax.tree.leaves(ref._opt_state) if np.ndim(a)]
    t_state = [b for b in T.state_leaves(net.updater_state())
               if not isinstance(b, int)]
    assert len(j_state) == len(t_state)
    if dtype == "float32":
        for k in jp:
            for p in jp[k]:
                np.testing.assert_allclose(tp[k][p].numpy(),
                                           np.asarray(jp[k][p]), atol=1e-5,
                                           err_msg=f"{k}/{p}")
        for a, b in zip(j_state, t_state):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    else:
        for k in jp:
            for p in jp[k]:
                err = _rel_l2(tp[k][p].numpy() - before[k][p],
                              np.asarray(jp[k][p]) - before[k][p])
                assert err <= 1e-1, (k, p, err)
        for a, b in zip(j_state, t_state):
            assert _rel_l2(b.numpy(), np.asarray(a)) <= 1e-1


def test_tbptt_chunks_spans_and_detached_carries(monkeypatch):
    """One span and one step a chunk; every chunk after the first starts
    from the previous chunk's carries, detached (no gradient crosses a
    chunk boundary), and the first from none."""
    _, net = build("mln", "float32", "LSTM")
    seen = []
    step = net._train_step

    def spy(inputs, labels, fmasks, lmasks, carries=None):
        seen.append((inputs[0].shape[1], carries))
        return step(inputs, labels, fmasks, lmasks, carries)

    monkeypatch.setattr(net, "_train_step", spy)
    x, y = _data(1, t_len=17)          # chunks of 7, 7 and 3
    net.fit(x, y)
    assert [s for s, _ in seen] == [7, 7, 3]
    assert seen[0][1] == {}
    for _, carries in seen[1:]:
        assert sorted(carries) == ["0", "1"]
        for carry in carries.values():
            assert len(carry) == 2
            assert all(not c.requires_grad and c.grad_fn is None
                       and c.dtype == torch.float32 for c in carry)
    assert net.getIterationCount() == 3


def test_gradient_stops_at_the_chunk_boundary():
    """Chunk 2's gradient equals the gradient of chunk 2 alone started
    from chunk 1's final carries as constants, and differs from one that
    flows back through chunk 1."""
    _, net = build("mln", "float32", "LSTM")
    x, y = _data(2, t_len=2 * TBPTT)
    xt, yt = torch.tensor(x), torch.tensor(y)
    params = {k: {p: v.clone().requires_grad_() for p, v in layer.items()}
              for k, layer in net.param_tree().items()}
    loss1, _, carries = net._loss_fn(params, {}, (xt[:, :TBPTT],),
                                     (yt[:, :TBPTT],), None, None, None, {})
    detached = {k: tuple(c.detach() for c in v) for k, v in carries.items()}
    leaves = [params[k][p] for k in sorted(params) for p in sorted(params[k])]
    loss2, _, _ = net._loss_fn(params, {}, (xt[:, TBPTT:],),
                               (yt[:, TBPTT:],), None, None, None, detached)
    cut = torch.autograd.grad(loss2, leaves)
    loss2b, _, _ = net._loss_fn(params, {}, (xt[:, TBPTT:],),
                                (yt[:, TBPTT:],), None, None, None, carries)
    through = torch.autograd.grad(loss2b, leaves)
    assert torch.equal(loss2, loss2b)
    gap = max(float((a - b).abs().max()) for a, b in zip(cut, through))
    assert gap > 1e-4
    # the fit's second chunk takes the first one's carries detached
    net._gen.manual_seed(0)
    _, _, _, keys, _, grads = net._value_and_grad(
        (xt[:, TBPTT:],), (yt[:, TBPTT:],), None, None, None, detached)
    for g, want in zip(grads, cut):
        torch.testing.assert_close(g, want, rtol=0, atol=0)


@pytest.mark.parametrize("net_kind", ["mln", "graph"])
def test_rnn_time_step_streams_output(net_kind):
    ref, net = build(net_kind, "float32", "GravesLSTM")
    x, _ = _data(3)
    full = net.output(x)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(ref.output(x).toNumpy()), atol=1e-5)
    key = "0" if net_kind == "mln" else "l0"
    net.rnnClearPreviousState()
    ref.rnnClearPreviousState()
    assert net.rnnGetPreviousState(key) is None
    # the reference streams its first two steps one at a time, then the
    # rest in one call (each of its calls runs its scan op by op)
    for t in range(2):
        np.testing.assert_allclose(
            net.rnnTimeStep(x[:, t]).numpy(),
            np.asarray(ref.rnnTimeStep(x[:, t]).toNumpy()), atol=1e-5)
    steps = [full[:, 0], full[:, 1]]
    for t in range(2, T_LEN):
        out = net.rnnTimeStep(x[:, t])
        assert tuple(out.shape) == (N, V)
        steps.append(out)
    ref_rest = np.asarray(ref.rnnTimeStep(x[:, 2:]).toNumpy())
    np.testing.assert_allclose(torch.stack(steps[2:], 1).numpy(), ref_rest,
                               atol=1e-5)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=1e-5)
    h, c = net.rnnGetPreviousState(key)
    jh, jc = ref.rnnGetPreviousState(key)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    # a (N, T, C) call carries on from there, then a clear starts afresh
    more = net.rnnTimeStep(x[:, :4])
    assert tuple(more.shape) == (N, 4, V)
    net.rnnClearPreviousState()
    assert net.rnnGetPreviousState(key) is None
    again = net.rnnTimeStep(x[:, 0])
    np.testing.assert_allclose(again.numpy(), full[:, 0].numpy(), atol=1e-6)


def test_vertices_take_the_mask_where_the_reference_passes_it():
    """The reference hands a vertex the feature mask where its ``apply``
    has a ``mask`` parameter; the port's vertex classes say so with
    ``takes_mask``, the same for every vertex both packages have."""
    import inspect
    both = sorted(set(t_gc._VERTEX_TYPES) & set(j_gc._VERTEX_TYPES))
    assert "LastTimeStepVertex" in both and len(both) > 10
    for name in both:
        ref = j_gc._VERTEX_TYPES[name].apply
        want = "mask" in inspect.signature(ref).parameters
        assert t_gc._VERTEX_TYPES[name].takes_mask is want, name


def test_graph_vertices_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 5, 3)).astype(np.float32)
    vec = rng.standard_normal((4, 3)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 0, 1, 0, 0], [0, 0, 0, 0, 0],
                     [1, 1, 1, 1, 1]], np.float32)
    for m in (None, mask):
        j_out = j_gc.LastTimeStepVertex().apply(
            [jnp.asarray(x)], mask=None if m is None else jnp.asarray(m))
        t_out = t_gc.LastTimeStepVertex().apply(
            [torch.tensor(x)], mask=None if m is None else torch.tensor(m))
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(
        t_gc.DuplicateToTimeSeriesVertex().apply(
            [torch.tensor(vec), torch.tensor(x)]).numpy(),
        np.asarray(j_gc.DuplicateToTimeSeriesVertex().apply(
            [jnp.asarray(vec), jnp.asarray(x)])))
    np.testing.assert_array_equal(
        t_gc.ReverseTimeSeriesVertex().apply([torch.tensor(x)]).numpy(),
        np.asarray(j_gc.ReverseTimeSeriesVertex().apply([jnp.asarray(x)])))
    for name in ("LastTimeStepVertex", "DuplicateToTimeSeriesVertex",
                 "ReverseTimeSeriesVertex"):
        j_v, t_v = getattr(j_gc, name)(), getattr(t_gc, name)()
        assert t_v.to_dict() == j_v.to_dict()
        assert type(t_gc.vertex_from_dict(j_v.to_dict())) is type(t_v)
    types_j = [JIT.feed_forward(3), JIT.recurrent(3, 5)]
    types_t = [TIT.feed_forward(3), TIT.recurrent(3, 5)]
    assert t_gc.DuplicateToTimeSeriesVertex().output_type(
        types_t).to_dict() == j_gc.DuplicateToTimeSeriesVertex().output_type(
        types_j).to_dict()


def _seq2seq_conf(ns):
    """An encoder's last step duplicated over the decoder's time axis and
    merged with the reversed input: the three vertices inside a net."""
    L, gc = ns["L"], ns["gc"]
    return (_builder(ns, "float32").graph_builder().add_inputs("in")
            .set_input_types(ns["IT"].recurrent(V))
            .add_layer("enc", L.LSTM(n_out=HID), "in")
            .add_vertex("last", gc.LastTimeStepVertex(), "enc")
            .add_vertex("dup", gc.DuplicateToTimeSeriesVertex(), "last", "in")
            .add_vertex("rev", gc.ReverseTimeSeriesVertex(), "in")
            .add_vertex("merge", gc.MergeVertex(), "dup", "rev")
            .add_layer("dec", L.GRU(n_out=HID), "merge")
            .add_layer("out", L.RnnOutputLayer(n_out=V, activation="softmax",
                                               loss_function="mcxent"), "dec")
            .set_outputs("out").build())


def test_time_series_vertices_in_a_graph_match_reference():
    ref = J["CG"](_seq2seq_conf(J)).init()
    net = P["CG"](_seq2seq_conf(P), device="cpu").init()
    net.set_param_tree(_np_tree(ref.param_tree()))
    net.set_updater_state_from_jax(_np_tree(ref._opt_state))
    x, y = _data(5, t_len=9)
    m = np.ones((N, 9), np.float32)
    m[0, 6:] = 0
    from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet as TMDS
    np.testing.assert_allclose(
        net.output(x, masks=[m]).numpy(),
        np.asarray(ref.output(x, masks=[m]).toNumpy()), atol=1e-5)
    ref.fit(JMDS([x], [y], [m], [m]))
    net.fit(TMDS([x], [y], [m], [m]))
    assert abs(net.score() - ref.score()) <= 1e-5
    jp, tp = ref.param_tree(), net.param_tree()
    for k in jp:
        for p in jp[k]:
            np.testing.assert_allclose(tp[k][p].numpy(), np.asarray(jp[k][p]),
                                       atol=1e-5, err_msg=f"{k}/{p}")


def _bi_gru_conf(ns):
    L = ns["L"]
    return (_builder(ns, "float32").list()
            .layer(L.Bidirectional.wrap(L.GRU(n_out=HID, recurrent_bias=True),
                                        mode="add"))
            .layer(L.RnnOutputLayer(n_out=V, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(ns["IT"].recurrent(V)).build())


def test_bidirectional_gru_net_carries_the_reference_state():
    """Bidirectional's ``f_``/``b_`` leaves and GRU's ``bR`` load through
    ``set_param_tree`` and ``set_updater_state_from_jax``; ``params()``
    packs them in the reference's sorted order; a masked fit step then
    matches (f32 atol 1e-5)."""
    from deeplearning4j_tpu.data.dataset import DataSet as JDS
    from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS
    ref = J["MLN"](_bi_gru_conf(J)).init()
    net = P["MLN"](_bi_gru_conf(P), device="cpu").init()
    net.set_param_tree(_np_tree(ref.param_tree()))
    net.set_updater_state_from_jax(_np_tree(ref._opt_state))
    assert sorted(net.param_tree()["0"]) == sorted(ref.param_tree()["0"]) \
        == ["b_RW", "b_W", "b_b", "b_bR", "f_RW", "f_W", "f_b", "f_bR"]
    np.testing.assert_array_equal(net.params().toNumpy(),
                                  np.asarray(ref.params().toNumpy()))
    x, y = _data(6, t_len=9)
    m = np.ones((N, 9), np.float32)
    m[0, 5:] = 0
    np.testing.assert_allclose(
        net.output(x, mask=m).numpy(),
        np.asarray(ref.output(x, mask=m).toNumpy()), atol=1e-5)
    ref.fit(JDS(x, y, m, m))
    net.fit(TDS(x, y, m, m))
    assert abs(net.score() - ref.score()) <= 1e-5
    np.testing.assert_allclose(net.params().toNumpy(),
                               np.asarray(ref.params().toNumpy()), atol=1e-5)
