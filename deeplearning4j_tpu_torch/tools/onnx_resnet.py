"""Author an ONNX model (NCHW) from a port ComputationGraph of the zoo's
ResNet family, with the port's ``onnx_proto`` writer.

The graph's layers map one for one: ZeroPadding → ``Pad``, Convolution →
``Conv`` (HWIO weights to OIHW, explicit pads), BatchNormalization →
``BatchNormalization`` with the running statistics, Activation relu →
``Relu``, Subsampling → ``MaxPool`` (``AveragePool`` without counting
the padding), ElementWiseVertex add → ``Add``, GlobalPooling avg →
``GlobalAveragePool``, Output → ``Flatten`` + ``Gemm`` (output ``logits``)
+ ``Softmax`` (output ``output``). Any other layer raises. The model is
built in memory (ResNet-50's ~102 MB of f32 weights) and nothing is
written unless asked.

:func:`resnet_conf` builds the family at any depth and width from the
zoo's own block builders: ``resnet_conf()`` is ResNet-50; the tests take
a two-stage, width-16 net at 32²::

    python -m deeplearning4j_tpu_torch.tools.onnx_resnet --blocks 1 1 \\
        --width 16 --size 32 --classes 10 --batch 2 --out /tmp/resnet_mini.onnx

prints the model's node count and size and, with ``--out``, writes it
there.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.modelimport import onnx_proto as P
from deeplearning4j_tpu_torch.ops.standard import same_pads

F32 = np.float32


def resnet_conf(blocks: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                classes: int = 1000, input_shape=(224, 224, 3),
                seed: int = 123):
    """A ResNet of the zoo's structure (stem, projection block then
    identity blocks per stage, filters (w, w, 4w) doubling per stage,
    global average pooling, softmax output); ``blocks=(3, 4, 6, 3)``,
    ``width=64`` is the zoo's ResNet50."""
    from deeplearning4j_tpu_torch.models.zoo.resnet import ResNet50
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        GlobalPoolingLayer, OutputLayer, SubsamplingLayer, ZeroPaddingLayer)
    from deeplearning4j_tpu_torch.optim.updaters import Nesterovs

    zoo = ResNet50(num_classes=classes, seed=seed, input_shape=input_shape)
    h, w, c = input_shape
    g = (NeuralNetConfiguration.builder().seed(seed)
         .updater(Nesterovs(1e-1, 0.9)).weight_init("relu")
         .graph_builder().add_inputs("input")
         .set_input_types(InputType.convolutional(h, w, c)))
    g.add_layer("pad1", ZeroPaddingLayer(padding=(3, 3, 3, 3)), "input")
    x = zoo._conv_bn_act(g, "conv1", "pad1", width, (7, 7), stride=(2, 2))
    g.add_layer("pool1", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                          padding=1), x)
    x = "pool1"
    for i, n in enumerate(blocks):
        f = width * 2 ** i
        filters = (f, f, 4 * f)
        stage = i + 2
        x = zoo._conv_block(g, stage, "a", x, filters,
                            stride=(1, 1) if i == 0 else (2, 2))
        for j in range(1, n):
            x = zoo._identity_block(g, stage, "bcdefghijk"[j - 1], x,
                                    filters)
    g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("output", OutputLayer(n_out=classes, activation="softmax",
                                      loss_function="mcxent"), "avgpool")
    return g.set_outputs("output").build()


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().astype(F32)


def _explicit(padding, size_hw, kernel, stride, dilation=(1, 1)
              ) -> List[Tuple[int, int]]:
    """(lo, hi) pads of the two spatial dims of a conv or pool."""
    if isinstance(padding, str):
        if padding.lower() == "same":
            return [same_pads(s, k, st, d) for s, k, st, d in
                    zip(size_hw, kernel, stride, dilation)]
        return [(0, 0), (0, 0)]
    return [(int(p), int(p)) for p in padding]


def to_onnx(net, batch: int, opset: int = 13) -> bytes:
    """The ONNX ModelProto bytes of ``net`` (a ComputationGraph of the
    layer types above) at a fixed ``batch``: input NCHW f32, outputs
    ``logits`` and ``output``. The batch is fixed because the importers
    learn every shape from the input's (a free batch dim leaves Flatten's
    extents unknown)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ActivationLayer, BatchNormalization, ConvolutionLayer,
        GlobalPoolingLayer, OutputLayer, SubsamplingLayer, ZeroPaddingLayer)
    from deeplearning4j_tpu_torch.nn.graph_conf import ElementWiseVertex

    if not net._initialized:
        net.init()
    conf = net.conf
    if len(conf.network_inputs) != 1 or len(conf.network_outputs) != 1:
        raise ValueError("one input and one output only")
    src = conf.network_inputs[0]
    it = conf.input_types[0]
    types: Dict[str, object] = {src: it}
    nodes: List[bytes] = []
    inits: List[bytes] = []

    def init(name, arr):
        inits.append(P.make_tensor(name, np.ascontiguousarray(arr)))
        return name

    for name in conf.topo_order:
        node = conf.nodes[name]
        ins = list(node.inputs)
        layer = node.layer
        t_in = types[ins[0]]
        if layer is None:
            v = node.vertex
            if not (isinstance(v, ElementWiseVertex) and v.op == "add"):
                raise ValueError(f"{name}: vertex {type(v).__name__} "
                                 f"({getattr(v, 'op', '')}) has no mapping")
            acc = ins[0]
            for k, other in enumerate(ins[1:]):
                out = name if k == len(ins) - 2 else f"{name}/{k}"
                nodes.append(P.make_node("Add", [acc, other], [out]))
                acc = out
            types[name] = t_in
            continue
        p = net._params.get(name, {})
        if isinstance(layer, ZeroPaddingLayer):
            t, b, l, r = layer.padding
            nodes.append(P.make_node("Pad", ins, [name],
                                     pads=[0, 0, int(t), int(l),
                                           0, 0, int(b), int(r)]))
        elif isinstance(layer, ConvolutionLayer):
            if (layer.activation or "identity") != "identity":
                raise ValueError(f"{name}: fused activation {layer.activation}")
            pads = _explicit(layer.padding, (t_in.height, t_in.width),
                             layer.kernel_size, layer.stride, layer.dilation)
            args = ins + [init(f"{name}_W", _np(p["W"]).transpose(3, 2, 0, 1))]
            if "b" in p:
                args.append(init(f"{name}_b", _np(p["b"])))
            nodes.append(P.make_node(
                "Conv", args, [name], kernel_shape=list(layer.kernel_size),
                strides=list(layer.stride), dilations=list(layer.dilation),
                pads=[pads[0][0], pads[1][0], pads[0][1], pads[1][1]]))
        elif isinstance(layer, BatchNormalization):
            st = net._states[name]
            n = layer.n_out
            gamma = _np(p["gamma"]) if "gamma" in p else np.ones(n, F32)
            beta = _np(p["beta"]) if "beta" in p else np.zeros(n, F32)
            nodes.append(P.make_node(
                "BatchNormalization",
                ins + [init(f"{name}_gamma", gamma),
                       init(f"{name}_beta", beta),
                       init(f"{name}_mean", _np(st["mean"])),
                       init(f"{name}_var", _np(st["var"]))],
                [name], epsilon=float(layer.eps)))
        elif isinstance(layer, ActivationLayer):
            if layer.activation != "relu":
                raise ValueError(f"{name}: activation {layer.activation}")
            nodes.append(P.make_node("Relu", ins, [name]))
        elif isinstance(layer, SubsamplingLayer):
            kind = layer.pooling_type.lower()
            pads = _explicit(layer.padding, (t_in.height, t_in.width),
                             layer.kernel_size, layer.stride)
            kw = dict(kernel_shape=list(layer.kernel_size),
                      strides=list(layer.stride),
                      pads=[pads[0][0], pads[1][0], pads[0][1], pads[1][1]])
            if kind == "max":
                nodes.append(P.make_node("MaxPool", ins, [name], **kw))
            elif kind == "avg":
                nodes.append(P.make_node("AveragePool", ins, [name],
                                         count_include_pad=0, **kw))
            else:
                raise ValueError(f"{name}: pooling {kind}")
        elif isinstance(layer, GlobalPoolingLayer):
            if layer.pooling_type.lower() != "avg":
                raise ValueError(f"{name}: global pooling "
                                 f"{layer.pooling_type}")
            nodes.append(P.make_node("GlobalAveragePool", ins, [name]))
        elif isinstance(layer, OutputLayer):
            flat = f"{name}/flat"
            nodes.append(P.make_node("Flatten", ins, [flat], axis=1))
            args = [flat, init(f"{name}_W", _np(p["W"]))]
            if "b" in p:
                args.append(init(f"{name}_b", _np(p["b"])))
            nodes.append(P.make_node("Gemm", args, ["logits"]))
            if layer.activation not in ("softmax", "identity", None):
                raise ValueError(f"{name}: activation {layer.activation}")
            op = "Softmax" if layer.activation == "softmax" else "Identity"
            nodes.append(P.make_node(op, ["logits"], [name],
                                     **({"axis": -1} if op == "Softmax"
                                        else {})))
        else:
            raise ValueError(f"{name}: layer {type(layer).__name__} has no "
                             f"mapping")
        types[name] = layer.output_type(t_in)
    out = conf.network_outputs[0]
    k = types[out].size
    graph = P.make_graph(
        nodes, "resnet",
        inputs=[P.make_value_info(src, F32, (batch, it.channels, it.height,
                                             it.width))],
        outputs=[P.make_value_info("logits", F32, (batch, k)),
                 P.make_value_info(out, F32, (batch, k))],
        initializers=inits)
    return P.make_model(graph, opset=opset)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[3, 4, 6, 3])
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--out", help="write the model here")
    args = ap.parse_args(argv)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    net = ComputationGraph(resnet_conf(args.blocks, args.width, args.classes,
                                       (args.size, args.size, 3), args.seed),
                           device="cpu")
    net.init()
    model = to_onnx(net, args.batch)
    n_nodes = len(P.parse_model(model)["graph"]["node"])
    print(f"{n_nodes} nodes, {len(model)} bytes")
    if args.out:
        with open(args.out, "wb") as f:
            f.write(model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
