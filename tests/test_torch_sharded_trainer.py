"""The port's data-parallel ``ShardedTrainer`` against the JAX package's,
on the CPU: the port's ranks are processes over ``gloo`` (a ``FileStore``
under ``tmp_path``), the reference's replicas conftest's virtual CPU
devices.

- The dense exchange at 2 and 4 ranks against the reference's
  ``ShardedTrainer`` on as many devices: a narrow LeNet and the residual
  net with BatchNormalization of ``tests/test_torch_networks.py``, the
  reference's weights carried across, 3 ``fit`` steps on global batches of
  8. Losses, params, BN states and updater leaves atol 1e-5 (the
  networks' f32 row: f32 sums in another order). The BN statistics are
  the global batch's on both sides.
- The compressed exchange at 2 ranks against the reference's pieces (its
  ``shard_map`` step cannot run on this jax): ``value_and_grad(
  net._loss_fn)`` on each shard, ``flatten_buckets``, ``exchange_bucket``
  under ``jax.vmap(axis_name="data")``, ``algo.update``,
  ``unflatten_buckets`` and ``finish_train_step``. The masks are equal at
  step 1; over 3 steps params, each rank's residual and the thresholds
  atol 1e-5, leaving out the elements whose |acc| lay within 1e-5·t of t
  in either run at any step (counted, under 0.1 %).
- An indivisible batch runs whole on every rank, as the reference
  replicates it; under compression it takes the dense exchange and the
  residual carries over. Under dropout the ranks stay identical.
- SameDiff ``set_mesh`` at 2 ranks against the reference's ``set_mesh``
  on 2 devices: 3 Adam steps, losses and values atol 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import run_ranks, sd_graph
from deeplearning4j_tpu.autodiff import samediff as j_sd
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.zoo import resnet as j_resnet
from deeplearning4j_tpu.nn import graph as j_graph
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn._step_tail import finish_train_step
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu.parallel import compression as JC
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel.trainer import ShardedTrainer as JTrainer
from deeplearning4j_tpu_torch.models.zoo import resnet as t_resnet
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.optim import updaters as t_upd

ATOL = 1e-5
NEAR = 1e-5          # |acc| within NEAR·t of t: a mask that may flip
NEAR_SHARE = 1e-3
LR = 0.1
BATCH = 8
THRESHOLD = 3e-3

J = dict(cfg=j_cfg, L=j_layers, IT=j_inputs.InputType, U=j_upd,
         resnet=j_resnet, MLN=j_mln.MultiLayerNetwork,
         CG=j_graph.ComputationGraph)
P = dict(cfg=t_cfg, L=t_layers, IT=t_inputs.InputType, U=t_upd,
         resnet=t_resnet, MLN=t_mln.MultiLayerNetwork,
         CG=t_graph.ComputationGraph)


def lenet_conf(ns):
    L = ns["L"]
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(3)
            .updater(ns["U"].Nesterovs(LR, 0.9)).weight_init("xavier")
            .list()
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


def residual_conf(ns):
    """ResNet-50's stem, a conv block and an identity block, narrow."""
    L, z = ns["L"], ns["resnet"].ResNet50(num_classes=5)
    g = (ns["cfg"].NeuralNetConfiguration.builder().seed(5)
         .updater(ns["U"].Nesterovs(LR, 0.9)).weight_init("relu")
         .graph_builder().add_inputs("input")
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


def dropout_conf(ns):
    """A dense layer under dropout, BatchNormalization and the output."""
    L = ns["L"]
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(9)
            .updater(ns["U"].Nesterovs(LR, 0.9)).weight_init("xavier")
            .list()
            .layer(L.DenseLayer(n_out=16, activation="relu", dropout=0.5))
            .layer(L.BatchNormalization())
            .layer(L.OutputLayer(n_out=10, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns["IT"].feed_forward(784))
            .build())


CONFS = {"lenet": (lenet_conf, "MLN", "mln"),
         "residual": (residual_conf, "CG", "cg"),
         "dropout": (dropout_conf, "MLN", "mln")}


def batches(kind, sizes=(BATCH, BATCH, BATCH), seed=10):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        if kind in ("lenet", "dropout"):
            x = rng.standard_normal((n, 784)).astype(np.float32)
            y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
        else:
            x = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
            y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
        out.append((x, y))
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_net(kind):
    conf, cls, _ = CONFS[kind]
    return J[cls](conf(J)).init()


def net_spec(kind, ref):
    """What a rank needs to build the port net carrying ``ref``'s weights."""
    conf, _, tag = CONFS[kind]
    return {"kind": tag, "conf": conf(P).to_json(),
            "params": _np_tree(ref.param_tree()),
            "states": _np_tree(ref.state_tree())}


def sd_pkg_jax():
    return {"sd": j_sd.SameDiff.create, "TrainingConfig": j_sd.TrainingConfig,
            "Adam": j_upd.Adam}


SD_W = (np.random.default_rng(7).standard_normal((4, 8)).astype(np.float32),
        np.random.default_rng(8).standard_normal((8, 3)).astype(np.float32))
SD_BATCHES = [(np.random.default_rng(20 + i).standard_normal(
    (8, 4)).astype(np.float32), np.random.default_rng(30 + i)
    .standard_normal((8, 3)).astype(np.float32)) for i in range(3)]


def jobs_for(world):
    jobs = {}
    for kind in ("lenet", "residual"):
        jobs[f"dense_{kind}"] = {"kind": "fit",
                                 "net": net_spec(kind, ref_net(kind)),
                                 "batches": batches(kind)}
    if world == 2:
        jobs["compressed"] = {
            "kind": "fit", "net": net_spec("residual", ref_net("residual")),
            "batches": batches("residual"),
            "compression": f"adaptive:{THRESHOLD}"}
        jobs["indivisible"] = {
            "kind": "fit", "net": net_spec("residual", ref_net("residual")),
            "batches": batches("residual", sizes=(5,)),
            "compression": f"fixed:{THRESHOLD}"}
        jobs["dropout"] = {"kind": "fit",
                           "net": net_spec("dropout", ref_net("dropout")),
                           "batches": batches("dropout", sizes=(5, 8, 5))}
        jobs["iterator"] = {"kind": "fit",
                            "net": net_spec("lenet", ref_net("lenet")),
                            "batches": batches("lenet", sizes=(8, 8, 8, 3)),
                            "iterator": BATCH}
        jobs["samediff"] = {"kind": "samediff", "w1": SD_W[0],
                            "w2": SD_W[1], "lr": 1e-2,
                            "batches": SD_BATCHES}
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's results, one spawn of its ranks for all its jobs."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = run_ranks(world, jobs_for(world),
                                     tmp_path_factory.mktemp(f"w{world}"))
        return cache[world]
    return get


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0, err_msg=what)


def _trees_close(got, want, what):
    assert sorted(got) == sorted(want)
    for k in want:
        for p in want[k]:
            _close(got[k][p], want[k][p], f"{what} {k}/{p}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["lenet", "residual"])
def test_dense_exchange_matches_reference_trainer(ranks, world, kind):
    res = ranks(world)
    ref = ref_net(kind)
    jt = JTrainer(ref, JMeshSpec.data_parallel(world),
                  devices=jax.devices()[:world])
    scores = []
    for x, y in batches(kind):
        jt.fit(x, y)
        scores.append(jt.score())
    for r in range(world):
        out = res[r][f"dense_{kind}"]
        _close(out["scores"], scores, f"rank {r} losses")
        _trees_close(out["params"], _np_tree(ref.param_tree()),
                     f"rank {r} params")
        _trees_close(out["states"], _np_tree(ref.state_tree()),
                     f"rank {r} states")
        j_upd_leaves = jax.tree.leaves(ref._opt_state)
        assert len(out["updater"]) == len(j_upd_leaves)
        for a, b in zip(out["updater"], j_upd_leaves):
            if isinstance(a, int):
                assert a == int(b)
            else:
                _close(a, b, f"rank {r} updater")
    if kind == "residual":
        # the BN running statistics moved, by the global batch's moments
        assert not np.allclose(res[0][f"dense_{kind}"]["states"]["conv1_bn"]
                               ["mean"], 0.0)


def reference_compressed(ref, data, algo, n):
    """The reference's compressed step, from its own pieces."""
    layout = JC.build_layout(ref._params)
    state = JC.init_state(layout, algo, n)
    residual, t = state["residual"][0], state["threshold"][0]
    params, opt_state, states = ref._params, ref._opt_state, ref._states
    vg = jax.jit(jax.value_and_grad(ref._loss_fn, has_aux=True))
    ex = jax.vmap(lambda a, tt: JC.exchange_bucket(a, tt, "data", n),
                  in_axes=(0, None), axis_name="data")
    steps = []
    for x, y in data:
        b = x.shape[0] // n
        losses, new_states, gs = [], [], []
        for r in range(n):
            (loss, (ns, _)), g = vg(params, states, (x[r * b:(r + 1) * b],),
                                    (y[r * b:(r + 1) * b],), None, None, None)
            losses.append(loss)
            new_states.append(ns)
            gs.append(JC.flatten_buckets(g, layout)[0])
        acc = jnp.stack(gs) + residual
        dec, sent, fired, frac = ex(acc, t)
        steps.append({"acc": np.asarray(acc), "t": float(t),
                      "signs": np.asarray(jnp.sign(sent)).astype(np.int8)})
        loss = jnp.mean(jnp.stack(losses))
        mean_states = jax.tree.map(lambda *a: jnp.mean(jnp.stack(a), 0),
                                   *new_states)
        grads = JC.unflatten_buckets([dec[0]], layout)
        params, opt_state, (states,), _ = finish_train_step(
            ref._opt, params, opt_state, grads, loss, frozenset(),
            guarded=((mean_states, states),))
        residual = acc - sent
        t = algo.update(t, frac[0])
    return {"params": _np_tree(params), "residual": np.asarray(residual),
            "threshold": float(t), "steps": steps, "layout": layout}


def test_compressed_exchange_matches_reference_pieces(ranks):
    world = 2
    res = ranks(world)
    ref = ref_net("residual")
    algo = JC.AdaptiveThresholdAlgorithm(initial_threshold=THRESHOLD)
    want = reference_compressed(ref, batches("residual"), algo, world)
    # the elements whose |acc| lay within NEAR·t of t in either run
    near = np.zeros(want["residual"].shape[1], bool)
    for s, w in enumerate(want["steps"]):
        for r in range(world):
            got = res[r]["compressed"]["steps"][s]
            acc_t = got["g"][0] + got["residual"][0]
            for a, t in ((w["acc"][r], w["t"]), (acc_t, got["threshold"][0])):
                near |= np.abs(np.abs(a) - t) <= NEAR * t
    assert near.mean() < NEAR_SHARE, near.mean()
    for r in range(world):
        got = res[r]["compressed"]
        # the masks at step 1, exactly
        np.testing.assert_array_equal(got["steps"][0]["signs"][0],
                                      want["steps"][0]["signs"][r])
        keep = ~near
        _close(got["compression"]["residual"][0][0][keep],
               want["residual"][r][keep], f"rank {r} residual")
        _close(got["compression"]["threshold"][0], want["threshold"],
               f"rank {r} threshold")
        flat = np.concatenate([got["params"][k][p].reshape(-1)
                               for k in sorted(got["params"])
                               for p in sorted(got["params"][k])])
        flat_want = np.concatenate([want["params"][k][p].reshape(-1)
                                    for k in sorted(want["params"])
                                    for p in sorted(want["params"][k])])
        _close(flat[keep], flat_want[keep], f"rank {r} params")
    # the threshold moved (adaptive) and the ranks kept their own residuals
    assert want["threshold"] != THRESHOLD
    assert not np.array_equal(res[0]["compressed"]["compression"]
                              ["residual"][0],
                              res[1]["compressed"]["compression"]
                              ["residual"][0])


def test_indivisible_batch_runs_whole_on_every_rank(ranks):
    res = ranks(2)
    ref = ref_net("residual")
    jt = JTrainer(ref, JMeshSpec.data_parallel(2), devices=jax.devices()[:2],
                  grad_compression=f"fixed:{THRESHOLD}")
    x, y = batches("residual", sizes=(5,))[0]
    jt.fit(x, y)
    for r in range(2):
        out = res[r]["indivisible"]
        _close(out["scores"], [jt.score()], f"rank {r} loss")
        _trees_close(out["params"], _np_tree(ref.param_tree()),
                     f"rank {r} params")
        _trees_close(out["states"], _np_tree(ref.state_tree()),
                     f"rank {r} states")
        # no compressed exchange ran: the residual and threshold carry
        assert out["steps"] == []
        assert not np.any(out["compression"]["residual"][0])
        assert out["compression"]["threshold"] == [
            pytest.approx(THRESHOLD)]
    comp = ref._grad_compression_state
    assert not np.any(np.asarray(comp["residual"][0]))


def test_ranks_stay_identical_under_dropout(ranks):
    """Dropout before BatchNormalization, batches of 5, 8 and 5 at 2
    ranks: the indivisible batches run whole on every rank with one mask,
    the divisible one with a mask a rank; after each, every rank holds the
    same params, BN states and updater leaves, to the bit."""
    res = ranks(2)
    a, b = res[0]["dropout"], res[1]["dropout"]
    assert a["scores"] == b["scores"]
    for what in ("params", "states"):
        for k in a[what]:
            for p in a[what][k]:
                np.testing.assert_array_equal(
                    a[what][k][p], b[what][k][p], err_msg=f"{what} {k}/{p}")
    for x, y in zip(a["updater"], b["updater"]):
        np.testing.assert_array_equal(x, y)
    assert np.all(np.isfinite(a["scores"]))


def test_iterator_fit_shards_on_the_prefetch_thread(ranks):
    """One epoch of an iterator (three batches of 8 and a last one of 3,
    which runs whole on every rank): the prefetch thread's placement hook
    keeps each rank's rows, as the reference's shards them."""
    from deeplearning4j_tpu.data.iterators import ArrayDataSetIterator
    res = ranks(2)
    ref = ref_net("lenet")
    jt = JTrainer(ref, JMeshSpec.data_parallel(2), devices=jax.devices()[:2])
    xs, ys = zip(*batches("lenet", sizes=(8, 8, 8, 3)))
    jt.fit(ArrayDataSetIterator(np.concatenate(xs), np.concatenate(ys),
                                BATCH))
    for r in range(2):
        out = res[r]["iterator"]
        _close(out["scores"], [jt.score()], f"rank {r} loss")
        _trees_close(out["params"], _np_tree(ref.param_tree()),
                     f"rank {r} params")


def test_samediff_set_mesh_matches_reference(ranks):
    res = ranks(2)
    sd = sd_graph(sd_pkg_jax(), SD_W[0], SD_W[1], 1e-2)
    sd.set_mesh(JMeshSpec.data_parallel(2).build(jax.devices()[:2]))
    losses = list(sd.fit([JDataSet(x, y) for x, y in SD_BATCHES]))
    for r in range(2):
        out = res[r]["samediff"]
        _close(out["losses"], losses, f"rank {r} losses")
        for n in ("w1", "w2"):
            _close(out["values"][n], np.asarray(sd._values[n]),
                   f"rank {r} {n}")
