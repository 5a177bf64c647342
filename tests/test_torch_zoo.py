"""The port's zoo models against the JAX package's: every model has the
same layers and vertices, names, inputs, param shapes and parameter
counts (at full size, from the confs); ResNet-50's and VGG16's analytic
FLOP counts equal hand formulas; the eight models of the last layers
(SqueezeNet, UNet, Xception, InceptionResNetV1, NASNet,
FaceNetNN4Small2, TinyYOLO, YOLO2) run forward at 32²-64² against the
JAX nets on the same params. No full-size forward runs here (too slow for
the CPU tier); the card runs the zoo at full width in ``chip_smoke.py``'s
``network_phase`` and ``detection_phase``.
"""
import numpy as np
import pytest

from deeplearning4j_tpu.models import zoo as j_zoo
from deeplearning4j_tpu_torch.models import zoo as t_zoo
from deeplearning4j_tpu_torch.nn._network import train_flops


def _graph_nodes(conf):
    return [(name, conf.nodes[name].inputs,
             type(conf.nodes[name].layer or conf.nodes[name].vertex).__name__,
             (conf.nodes[name].layer.param_shapes()
              if conf.nodes[name].layer is not None else
              conf.nodes[name].vertex.to_dict()))
            for name in conf.topo_order]


@pytest.fixture(scope="module")
def resnet_confs():
    kw = dict(num_classes=1000, data_type="bfloat16")
    return j_zoo.ResNet50(**kw).conf(), t_zoo.ResNet50(**kw).conf()


def test_resnet50_conf_equals_reference(resnet_confs):
    j, t = resnet_confs
    assert _graph_nodes(t) == _graph_nodes(j)
    assert t.network_inputs == j.network_inputs == ["input"]
    assert t.network_outputs == j.network_outputs == ["output"]
    assert t.dtype == j.dtype == "bfloat16"
    assert t.updater.to_dict() == j.updater.to_dict()
    assert t.to_json() == j.to_json()
    for name in j.activation_types:
        assert t.activation_types[name].to_dict() == \
            j.activation_types[name].to_dict()
    n_layers = sum(1 for n in t.nodes.values() if n.layer is not None)
    n_add = sum(1 for n in t.nodes.values() if n.vertex is not None)
    # 53 conv + BN pairs, pad, pool, avgpool, output; 33 ReLUs after a
    # BN, 16 after an add
    assert n_add == 16 and n_layers == 53 * 2 + 4 + 33 + 16


def test_resnet50_num_params(resnet_confs):
    j, _ = resnet_confs
    want = sum(int(np.prod(s)) for n in j.nodes.values() if n.layer is not None
               for s in n.layer.param_shapes().values())
    net = t_zoo.ResNet50().init_model(device="cpu")
    assert net.numParams() == want == 25_557_032
    assert int(net.params().buf().numel()) == want


def _resnet50_forward_flops(batch, hw=224, classes=1000):
    """2 FLOPs per multiply-add of every convolution and the classifier,
    by stage: the 7×7/2 stem, then per stage (output side, channels in,
    bottleneck width, blocks) a projection block (1×1 in→m at the stage's
    stride, 3×3 m→m, 1×1 m→4m, 1×1 shortcut in→4m) and identity blocks
    (1×1 4m→m, 3×3 m→m, 1×1 m→4m)."""
    macs = (hw // 2) ** 2 * 7 * 7 * 3 * 64
    side = hw // 4
    stages = ((side, 64, 64, 3), (side // 2, 256, 128, 4),
              (side // 4, 512, 256, 6), (side // 8, 1024, 512, 3))
    for s, c_in, m, blocks in stages:
        hw2 = s * s
        macs += hw2 * (c_in * m + 9 * m * m + m * 4 * m + c_in * 4 * m)
        macs += (blocks - 1) * hw2 * (4 * m * m + 9 * m * m + m * 4 * m)
    macs += 2048 * classes
    return 2 * batch * macs


def test_resnet50_flops_equal_a_hand_formula():
    net = t_zoo.ResNet50().init_model(device="cpu")
    fwd = net._forward_flops(32)
    assert fwd == _resnet50_forward_flops(32)
    # the paper's 3.8e9 multiply-adds an image (stride on the first 1×1,
    # as DL4J's ResNet50; torchvision's stride-on-3×3 variant has 4.1e9)
    assert 3.8e9 < fwd / 32 / 2 < 3.9e9
    flops, byts = net.step_cost(32)
    assert flops == train_flops(fwd) == 3 * fwd
    assert byts > 4 * 3 * net.numParams()
    small = t_zoo.ResNet50(num_classes=10, input_shape=(64, 64, 3)).conf()
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    assert ComputationGraph(small, device="cpu")._forward_flops(2) == \
        _resnet50_forward_flops(2, hw=64, classes=10)


NEW_MODELS = ["SqueezeNet", "UNet", "Xception", "InceptionResNetV1",
              "NASNet", "FaceNetNN4Small2", "TinyYOLO", "YOLO2"]


@pytest.mark.parametrize("name", ["LeNet", "SimpleCNN", "VGG16", "VGG19",
                                  "Darknet19", "AlexNet"] + NEW_MODELS)
def test_small_zoo_confs_equal_reference(name):
    """Node for node at the models' own input size; the parameter count of
    a net initialised at 64² with 10 classes (the 224² nets are 60-145 M
    parameters, which this tier does not allocate) equals the reference
    conf's at that size."""
    j = getattr(j_zoo, name)().conf()
    t = getattr(t_zoo, name)().conf()
    if hasattr(j, "layers"):
        assert [type(l).__name__ for l in t.layers] == \
            [type(l).__name__ for l in j.layers]
        assert [l.param_shapes() for l in t.layers] == \
            [l.param_shapes() for l in j.layers]
        assert [l.to_dict() for l in t.layers] == \
            [l.to_dict() for l in j.layers]
    else:
        assert _graph_nodes(t) == _graph_nodes(j)
    assert t.to_json() == j.to_json()
    small = ({} if name in ("LeNet", "SimpleCNN")
             else dict(input_shape=(64, 64, 3), num_classes=10))
    net = getattr(t_zoo, name)(**small).init_model(device="cpu")
    js = getattr(j_zoo, name)(**small).conf()
    layers = (js.layers if hasattr(js, "layers") else
              [n.layer for n in js.nodes.values() if n.layer is not None])
    assert net.numParams() == sum(l.n_params() for l in layers)


@pytest.mark.parametrize("name,want", [
    ("VGG16", 138357544), ("VGG19", 143667240), ("AlexNet", 62378344),
    ("Darknet19", 21843376)])
def test_zoo_param_counts_at_224(name, want):
    """At 224², 1000 classes (VGG16 and VGG19's published 138.4 M and
    143.7 M; AlexNet's one-tower 62.4 M; Darknet19 with its BN's gamma
    and beta), from the confs on both sides."""
    counts = []
    for zoo in (j_zoo, t_zoo):
        conf = getattr(zoo, name)().conf()
        layers = (conf.layers if hasattr(conf, "layers") else
                  [n.layer for n in conf.nodes.values()
                   if n.layer is not None])
        counts.append(sum(l.n_params() for l in layers))
    assert counts == [want, want]


@pytest.mark.parametrize("name,want", [
    ("SqueezeNet", 1235496), ("UNet", 31031745), ("Xception", 22855952),
    ("InceptionResNetV1", 6829320), ("NASNet", 1715548),
    ("FaceNetNN4Small2", 3986312), ("TinyYOLO", 15861773),
    ("YOLO2", 38823965)])
def test_new_zoo_param_counts_at_full_size(name, want):
    """At each model's own input size and class count (1000; UNet 1,
    TinyYOLO and YOLO2 20 VOC classes), from the confs on both sides:
    Xception's published 22.9 M, YOLO2's 50.7 M less its passthrough."""
    counts = []
    for zoo in (j_zoo, t_zoo):
        conf = getattr(zoo, name)().conf()
        counts.append(sum(n.layer.n_params() for n in conf.nodes.values()
                          if n.layer is not None))
    assert counts == [want, want]


#: the forward parity's sizes: input side, classes, depth cuts
SMALL = {"SqueezeNet": dict(input_shape=(64, 64, 3), num_classes=10),
         "UNet": dict(input_shape=(32, 32, 3)),
         "Xception": dict(input_shape=(64, 64, 3), num_classes=10),
         "InceptionResNetV1": dict(input_shape=(64, 64, 3), num_classes=10,
                                   blocks=(1, 1, 1)),
         "NASNet": dict(input_shape=(64, 64, 3), num_classes=10,
                        num_blocks=1, penultimate_filters=96),
         "FaceNetNN4Small2": dict(input_shape=(64, 64, 3), num_classes=10,
                                  width_mult=0.25),
         "TinyYOLO": dict(input_shape=(64, 64, 3), num_classes=3),
         "YOLO2": dict(input_shape=(64, 64, 3), num_classes=3)}
#: models without dropout, whose training loss is held too
NO_DROPOUT = ("Xception", "NASNet", "FaceNetNN4Small2", "TinyYOLO", "YOLO2")


def _labels_for(name, conf, n, rng):
    out = conf.activation_types[conf.nodes[conf.network_outputs[0]]
                                .inputs[0]]
    if name in ("TinyYOLO", "YOLO2"):
        h, w, c = out.height, out.width, SMALL[name]["num_classes"]
        y = np.zeros((n, h, w, 4 + c), np.float32)
        y[:, 0, 0, :4] = (0.2, 0.3, 1.4, 1.1)
        y[:, 0, 0, 4] = 1.0
        return y
    if name == "UNet":
        return rng.uniform(0, 1, (n, out.height, out.width, 1)).astype(
            np.float32)
    return np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]


@pytest.mark.parametrize("name", NEW_MODELS)
def test_new_zoo_forward_matches_reference(name):
    """The JAX net's params and BN statistics carried into the port's:
    inference outputs within relative L2 1e-4 (f32 through 20-90 layers,
    activations growing on unit running variances) and, for the models
    without dropout, the training loss within relative 1e-4."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JG
    kw = SMALL[name]
    ref = JG(getattr(j_zoo, name)(**kw).conf()).init()
    net = getattr(t_zoo, name)(**kw).init_model(device="cpu")
    net.set_param_tree(jax.tree.map(np.asarray, ref.param_tree()))
    net.set_state_tree(jax.tree.map(np.asarray, ref.state_tree()))
    assert net.numParams() == ref.numParams()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2,) + kw["input_shape"]).astype(np.float32)
    want = np.asarray(ref.output(x))
    got = net.output(x).numpy()
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= 1e-4, err
    if name in NO_DROPOUT:
        y = _labels_for(name, ref.conf, 2, rng)
        loss = jax.jit(lambda p, s, a, b: ref._loss_fn(
            p, s, (a,), (b,), None, None, None)[0])(
                ref.param_tree(), ref.state_tree(), jnp.asarray(x),
                jnp.asarray(y))
        got_loss = net.score(_dataset(x, y))
        assert abs(got_loss - float(loss)) <= 1e-4 * abs(float(loss))


def _dataset(x, y):
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    return DataSet(x, y)


def _vgg16_forward_flops(batch, hw=224, classes=1000):
    """2 a multiply-add: 3x3 "same" convolutions block by block (each
    block at a half the previous spatial size), then the three dense
    layers over the 7x7x512 map."""
    blocks = [(64, [3, 64]), (128, [64, 128]), (256, [128, 256, 256]),
              (512, [256, 512, 512]), (512, [512, 512, 512])]
    total, side = 0, hw
    for c_out, c_ins in blocks:
        total += sum(side * side * 9 * c_in * c_out for c_in in c_ins)
        side //= 2
    total += side * side * 512 * 4096 + 4096 * 4096 + 4096 * classes
    return 2 * batch * total


def test_vgg16_flops_equal_a_hand_formula():
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(t_zoo.VGG16().conf(), device="cpu")
    assert net._forward_flops(2) == _vgg16_forward_flops(2)
    assert _vgg16_forward_flops(1) == 30940528640    # 15.47 GMACs an image
    assert net.step_cost(32)[0] == train_flops(_vgg16_forward_flops(32))


def test_lenet_flops():
    net = t_zoo.LeNet().init_model(device="cpu")
    want = 2 * (24 * 24 * 25 * 1 * 20 + 8 * 8 * 25 * 20 * 50
                + 4 * 4 * 50 * 500 + 500 * 10)
    assert net._forward_flops(1) == want


def test_init_model_runs_on_the_card_unless_asked(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU contract does not apply")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_zoo.LeNet().init_model()


def test_init_pretrained_is_local_only(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_ZOO_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no network"):
        t_zoo.ResNet50().init_pretrained()
    assert not t_zoo.ResNet50().pretrained_available("imagenet")


# ------------------------------------------------------ TextGenerationLSTM
def test_text_generation_lstm_conf_equals_reference():
    j, t = j_zoo.TextGenerationLSTM().conf(), t_zoo.TextGenerationLSTM().conf()
    assert [l.to_dict() for l in t.layers] == [l.to_dict() for l in j.layers]
    assert [l.param_shapes() for l in t.layers] == \
        [l.param_shapes() for l in j.layers]
    assert t.to_json() == j.to_json()
    assert t.backprop_type == j.backprop_type == "tbptt"
    assert t.tbptt_fwd_length == j.tbptt_fwd_length == 50
    net = t_zoo.TextGenerationLSTM().init_model(device="cpu")
    assert net.numParams() == sum(l.n_params() for l in j.layers) == (
        4 * 256 * (47 + 256 + 1) + 4 * 256 * (256 + 256 + 1) + 256 * 47 + 47)
    # both LSTM(256) layers run on K11L, one launch a layer and call
    assert [l.cell_route() for l in net.layers[:2]] == ["k11_layer"] * 2


def test_text_generation_lstm_takes_one_tbptt_fit():
    m = t_zoo.TextGenerationLSTM(total_unique_characters=11, tbptt_length=4)
    net = m.init_model(device="cpu")
    rng = np.random.default_rng(0)
    eye = np.eye(11, dtype=np.float32)
    x, y = eye[rng.integers(0, 11, (2, 10))], eye[rng.integers(0, 11, (2, 10))]
    w0 = net.param_tree()["0"]["RW"].clone()
    net.fit(x, y)
    assert net.getIterationCount() == 3          # chunks of 4, 4 and 2
    assert np.isfinite(net.score())
    assert not bool((net.param_tree()["0"]["RW"] == w0).all())
    net.rnnClearPreviousState()
    out = net.rnnTimeStep(x[:, 0])
    assert tuple(out.shape) == (2, 11)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, rtol=1e-5)


def _lstm_flops(n, t, n_in, h, gates=4):
    return 2 * n * t * (n_in + h) * gates * h


@pytest.mark.parametrize("t", [None, 50, 1000])
def test_recurrent_flops_equal_a_hand_formula(t):
    """The char-RNNs' forward FLOPs: each LSTM 2·N·T·(n_in + H)·4·H, the
    RnnOutputLayer 2·N·T·H·V, per timestep (T from the call, else 1: the
    zoo's input type has no length)."""
    steps = 1 if t is None else t
    net = t_zoo.TextGenerationLSTM().init_model(device="cpu")
    want = (_lstm_flops(32, steps, 47, 256) + _lstm_flops(32, steps, 256, 256)
            + 2 * 32 * steps * 256 * 47)
    assert net._forward_flops(32, t) == want
    assert net.step_cost(32, t)[0] == train_flops(want)
    from deeplearning4j_tpu_torch.nn.conf import layers as TL
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn._network import layer_flops
    it = InputType.recurrent(200, 50)
    graves = TL.GravesLSTM(n_in=200, n_out=200)
    assert layer_flops(graves, it, 32) == _lstm_flops(32, 50, 200, 200)
    gru = TL.GRU(n_in=8, n_out=16)
    assert layer_flops(gru, it, 2, 7) == _lstm_flops(2, 7, 8, 16, gates=3)
    rnn = TL.SimpleRnn(n_in=8, n_out=16)
    assert layer_flops(rnn, it, 2, 7) == _lstm_flops(2, 7, 8, 16, gates=1)
    bi = TL.Bidirectional.wrap(TL.LSTM(n_in=8, n_out=16))
    assert layer_flops(bi, it, 2, 7) == 2 * _lstm_flops(2, 7, 8, 16)
    last = TL.LastTimeStep.wrap(TL.GRU(n_in=8, n_out=16))
    assert layer_flops(last, it, 2, 7) == _lstm_flops(2, 7, 8, 16, gates=3)
    dense = TL.DenseLayer(n_in=200, n_out=10)
    assert layer_flops(dense, it, 32) == 2 * 32 * 50 * 200 * 10
    assert layer_flops(dense, InputType.feed_forward(200), 32) == \
        2 * 32 * 200 * 10
