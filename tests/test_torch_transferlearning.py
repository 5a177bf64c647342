"""The port's transfer learning (``nn/transferlearning.py``) against the
JAX package's on the CPU.

The same source net (the reference's weights, states and updater state
carried into the port) goes through ``TransferLearning.Builder`` (a small
conv + BN MultiLayerNetwork: ``nout_replace``, ``set_feature_extractor``,
``remove_output_layer`` / ``add_layer``) and ``GraphBuilder`` (ResNet-50's
stem and two blocks, narrow: ``set_feature_extractor("avgpool")``,
``reinit_layer("output")``) in each package; re-initialized layers take
the reference's fresh draws. Then two steps in each: every frozen param
and its updater state bitwise unchanged; the frozen BatchNormalizations'
running statistics moving, as in the reference (its train step masks
gradients and updates only), within atol 1e-5 of it; the head within the
f32 per-step row (atol 1e-5: the same arithmetic, sums in another order).
``featurize`` equals ``feedForward`` at the frozen boundary bitwise and
the reference's featurize within atol 1e-5.
"""
import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu.data import dataset as j_ds
from deeplearning4j_tpu.models.zoo import resnet as j_resnet
from deeplearning4j_tpu.nn import graph as j_graph
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn import transferlearning as j_tl
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu_torch.data import dataset as t_ds
from deeplearning4j_tpu_torch.models.zoo import resnet as t_resnet
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn import transferlearning as t_tl
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.optim import transforms as T
from deeplearning4j_tpu_torch.optim import updaters as t_upd

J = dict(cfg=j_cfg, L=j_layers, IT=j_inputs.InputType, U=j_upd, tl=j_tl,
         resnet=j_resnet, MLN=j_mln.MultiLayerNetwork,
         CG=j_graph.ComputationGraph, ds=j_ds)
P = dict(cfg=t_cfg, L=t_layers, IT=t_inputs.InputType, U=t_upd, tl=t_tl,
         resnet=t_resnet, MLN=t_mln.MultiLayerNetwork,
         CG=t_graph.ComputationGraph, ds=t_ds)
STEP_ATOL = 1e-5


def mln_conf(ns):
    L = ns["L"]
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(3)
            .updater(ns["U"].Nesterovs(0.05, 0.9)).weight_init("xavier")
            .list()
            .layer(L.ConvolutionLayer(kernel_size=(3, 3), n_out=6,
                                      activation="relu"))
            .layer(L.BatchNormalization())
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(n_out=12, activation="relu"))
            .layer(L.OutputLayer(n_out=10, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns["IT"].convolutional(10, 10, 2)).build())


def cg_conf(ns):
    """ResNet-50's stem, a conv block and an identity block, narrow."""
    L, z = ns["L"], ns["resnet"].ResNet50(num_classes=5)
    g = (ns["cfg"].NeuralNetConfiguration.builder().seed(5)
         .updater(ns["U"].Nesterovs(0.1, 0.9)).weight_init("relu")
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


def np_tree(tree):
    return {k: {p: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for p, v in layer.items()}
            for k, layer in tree.items()}


def carry(ref, net):
    net.set_param_tree(jax.tree.map(np.asarray, ref.param_tree()))
    net.set_state_tree(jax.tree.map(np.asarray, ref.state_tree()))
    net.set_updater_state_from_jax(jax.tree.map(np.asarray, ref._opt_state))


def sources(kind):
    conf = mln_conf if kind == "mln" else cg_conf
    cls = "MLN" if kind == "mln" else "CG"
    ref = J[cls](conf(J)).init()
    net = P[cls](conf(P), device="cpu").init()
    carry(ref, net)
    return ref, net


def data(kind, n=6, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "mln":
        x = rng.standard_normal((n, 10, 10, 2)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    else:
        x = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    return x, y


def transfer(ns, kind, src):
    ftc = ns["tl"].FineTuneConfiguration(updater=ns["U"].Adam(1e-2), seed=9)
    if kind == "mln":
        return (ns["tl"].TransferLearning.Builder(src)
                .fine_tune_configuration(ftc).nout_replace(4, 5)
                .set_feature_extractor(2).build())
    return (ns["tl"].TransferLearning.GraphBuilder(src)
            .fine_tune_configuration(ftc).set_feature_extractor("avgpool")
            .reinit_layer("output").build())


@pytest.fixture(params=["mln", "cg"], scope="module")
def transferred(request):
    kind = request.param
    ref_src, src = sources(kind)
    ref = transfer(J, kind, ref_src)
    net = transfer(P, kind, src)
    return kind, ref_src, src, ref, net


def test_builders_keep_the_trunk_and_freeze_as_the_reference(transferred):
    kind, ref_src, src, ref, net = transferred
    assert net._frozen == ref._frozen and net._frozen
    assert net.conf.to_json() == ref.conf.to_json()
    want_src = np_tree(ref_src.param_tree())
    got = np_tree(net.param_tree())
    fresh = {"4"} if kind == "mln" else {"output"}
    for k in got:
        if k in fresh:
            continue
        for p in got[k]:
            np.testing.assert_array_equal(got[k][p], want_src[k][p])
    for k in fresh & set(got):
        assert {p: v.shape for p, v in got[k].items()} == {
            p: np.shape(v) for p, v in ref.param_tree()[k].items()}
    # the source net is untouched and still its own
    np.testing.assert_array_equal(np_tree(src.param_tree())["conv1"
                                  if kind == "cg" else "0"]["W"],
                                  want_src["conv1" if kind == "cg"
                                           else "0"]["W"])
    assert all(float(t.abs().sum()) == 0 for t in
               T.state_leaves(net.updater_state())
               if isinstance(t, torch.Tensor))


def test_two_frozen_steps_match_the_reference(transferred):
    kind, _, _, ref, net = transferred
    carry(ref, net)        # the reference's fresh draws of the new layers
    before = np_tree(net.param_tree())
    states0 = np_tree(net.state_tree())
    for s in range(2):
        x, y = data(kind, seed=20 + s)
        ref.fit(x, y)
        net.fit(x, y)
        assert abs(net.score() - ref.score()) <= STEP_ATOL
    got, want = np_tree(net.param_tree()), np_tree(ref.param_tree())
    moved = 0
    for k in got:
        for p in got[k]:
            if k in net._frozen:
                np.testing.assert_array_equal(got[k][p], before[k][p],
                                              err_msg=f"{k}/{p}")
            else:
                np.testing.assert_allclose(got[k][p], want[k][p],
                                           atol=STEP_ATOL, err_msg=f"{k}/{p}")
                moved += not np.array_equal(got[k][p], before[k][p])
    assert moved > 0
    # the frozen BNs' running statistics move, as the reference's do
    st, st_ref = np_tree(net.state_tree()), np_tree(ref.state_tree())
    frozen_bn = [k for k in st if k in net._frozen]
    assert frozen_bn
    for k in frozen_bn:
        for s in st[k]:
            assert not np.array_equal(st[k][s], states0[k][s]), (k, s)
            np.testing.assert_allclose(st[k][s], st_ref[k][s],
                                       atol=STEP_ATOL, err_msg=f"{k}/{s}")
    # frozen leaves' updater state stays zero, alike in both packages
    keys = [(k, p) for k in sorted(got) for p in sorted(got[k])]
    t_state = T.state_leaves(net.updater_state())
    j_state = jax.tree.leaves(ref._opt_state)
    assert len(t_state) == len(j_state)
    tensors = [t for t in t_state if isinstance(t, torch.Tensor)]
    assert len(tensors) == 2 * len(keys)
    for i, t in enumerate(tensors):
        k, p = keys[i % len(keys)]
        if k in net._frozen:
            assert float(t.abs().sum()) == 0, (k, p)


def test_remove_output_layer_and_add_layer_match_the_reference():
    ref_src, src = sources("mln")
    nets = []
    for ns, s in ((J, ref_src), (P, src)):
        nets.append(ns["tl"].TransferLearning.Builder(s)
                    .remove_output_layer()
                    .add_layer(ns["L"].OutputLayer(
                        n_out=3, activation="softmax",
                        loss_function="mcxent"))
                    .set_feature_extractor(3).build())
    ref, net = nets
    assert net.conf.to_json() == ref.conf.to_json()
    assert net._frozen == ref._frozen == {"0", "1", "2", "3"}
    carry(ref, net)
    x, _ = data("mln", seed=4)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(ref.output(x).toNumpy()),
                               atol=STEP_ATOL)


def test_featurize_is_the_frozen_boundary(transferred):
    kind, _, _, ref, net = transferred
    if kind != "mln":
        with pytest.raises(TypeError):
            t_tl.TransferLearningHelper(net)
        return
    carry(ref, net)
    x, y = data("mln", seed=7)
    helper = t_tl.TransferLearningHelper(net)
    assert helper.frozen_until == 2
    feat = helper.featurize(t_ds.DataSet(x, y))
    np.testing.assert_array_equal(feat.labels, y)
    assert torch.equal(feat.features, net.feedForward(x)[3])
    want = j_tl.TransferLearningHelper(ref).featurize(j_ds.DataSet(x, y))
    np.testing.assert_allclose(feat.features.numpy(),
                               np.asarray(want.features), atol=STEP_ATOL)


def test_builders_refuse_an_uninitialized_source():
    net = t_mln.MultiLayerNetwork(mln_conf(P), device="cpu")
    with pytest.raises(ValueError, match="initialized"):
        t_tl.TransferLearning.Builder(net)
    g = t_graph.ComputationGraph(cg_conf(P), device="cpu")
    with pytest.raises(ValueError, match="initialized"):
        t_tl.TransferLearning.GraphBuilder(g)
