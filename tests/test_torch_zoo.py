"""The port's zoo models against the JAX package's: ResNet-50
(``ComputationGraph``), LeNet and SimpleCNN (``MultiLayerNetwork``) have
the same layers and vertices, names, inputs, param shapes and parameter
counts; ResNet-50's analytic FLOP count equals a hand formula. No
full-size forward runs here (too slow for the CPU tier); the card runs
ResNet-50 at full width in ``chip_smoke.py``'s ``network_phase``.
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
    assert int(net.params().numel()) == want


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


@pytest.mark.parametrize("name", ["LeNet", "SimpleCNN"])
def test_small_zoo_confs_equal_reference(name):
    j = getattr(j_zoo, name)().conf()
    t = getattr(t_zoo, name)().conf()
    assert [type(l).__name__ for l in t.layers] == \
        [type(l).__name__ for l in j.layers]
    assert [l.param_shapes() for l in t.layers] == \
        [l.param_shapes() for l in j.layers]
    assert [l.to_dict() for l in t.layers] == [l.to_dict() for l in j.layers]
    assert t.to_json() == j.to_json()
    net = getattr(t_zoo, name)().init_model(device="cpu")
    assert net.numParams() == sum(l.n_params() for l in j.layers)


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
