"""Transfer learning: counterpart of ``deeplearning4j_tpu/nn/transferlearning.py``
(the reference's ``org.deeplearning4j.nn.transferlearning.{TransferLearning,
TransferLearningHelper,FineTuneConfiguration}``, SURVEY D8).

Freezing is not a wrapper layer (the reference's FrozenLayer): a frozen
layer's key goes into the network's ``_frozen`` set, and the train step
zeroes its gradients and its updates (``nn/_step_tail.py``). As in the
JAX package, nothing else of the layer is frozen (ROADMAP queue 3): a
frozen BatchNormalization's running statistics go on moving in training,
and a frozen layer's dropout still fires. A built net lives on its
source's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


@dataclasses.dataclass
class FineTuneConfiguration:
    """Global overrides applied to every layer of the fine-tuned net
    (ref: transferlearning.FineTuneConfiguration)."""
    updater: object = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    seed: Optional[int] = None

    def _apply_to_conf(self, conf):
        if self.updater is not None:
            conf.updater = self.updater
        if self.seed is not None:
            conf.seed = self.seed
        for layer in getattr(conf, "layers", []) or []:
            self._apply_to_layer(layer)
        for node in getattr(conf, "nodes", {}).values():
            if getattr(node, "layer", None) is not None:
                self._apply_to_layer(node.layer)

    def _apply_to_layer(self, layer: Layer):
        for k in ("l1", "l2", "dropout", "activation"):
            v = getattr(self, k)
            if v is not None and hasattr(layer, k):
                setattr(layer, k, v)


class TransferLearning:
    """ref: TransferLearning.Builder (MultiLayerNetwork) /
    TransferLearning.GraphBuilder (ComputationGraph)."""

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            if not net._initialized:
                raise ValueError("source network must be initialized")
            self._src = net
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._nout_replace: Dict[int, tuple] = {}
            self._remove_from: Optional[int] = None
            self._appended: List[Layer] = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        fineTuneConfiguration = fine_tune_configuration

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers [0..layer_idx] inclusive (ref:
            Builder#setFeatureExtractor)."""
            self._freeze_until = layer_idx
            return self

        setFeatureExtractor = set_feature_extractor

        def nout_replace(self, layer_idx: int, n_out: int,
                         weight_init: str = "xavier"):
            """Change a layer's output width, re-initializing it and the next
            layer's inputs (ref: Builder#nOutReplace)."""
            self._nout_replace[layer_idx] = (n_out, weight_init)
            return self

        nOutReplace = nout_replace

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        removeOutputLayer = remove_output_layer

        def remove_layers_from_output(self, n: int):
            self._remove_from = len(self._src.layers) - n
            return self

        removeLayersFromOutput = remove_layers_from_output

        def add_layer(self, layer: Layer):
            self._appended.append(layer)
            return self

        addLayer = add_layer

        def build(self) -> MultiLayerNetwork:
            src = self._src
            conf = MultiLayerConfiguration.from_json(src.conf.to_json())
            layers = list(conf.layers)
            keep = (len(layers) if self._remove_from is None
                    else self._remove_from)
            layers = layers[:keep] + list(self._appended)
            reinit = set(range(keep, len(layers)))
            # nOut replacement re-inits that layer and widens the next
            for idx, (n_out, winit) in self._nout_replace.items():
                layers[idx].n_out = n_out
                layers[idx].weight_init = winit
                reinit.add(idx)
                if idx + 1 < len(layers) and hasattr(layers[idx + 1], "n_in"):
                    layers[idx + 1].n_in = None  # re-infer
                    reinit.add(idx + 1)
            conf.layers = layers
            if self._fine_tune is not None:
                self._fine_tune._apply_to_conf(conf)
            conf.recompute_shapes()
            new = MultiLayerNetwork(conf, device=src.device).init()
            # retained, un-reinitialized layers keep the source's weights
            # (set_param_tree / set_state_tree copy them)
            params, states = dict(new._params), dict(new._states)
            for i in range(min(keep, len(layers))):
                key = str(i)
                if i in reinit:
                    continue
                if src._params.get(key):
                    params[key] = src._params[key]
                if key in src._states:
                    states[key] = src._states[key]
            new.set_param_tree(params)
            new.set_state_tree(states)
            new._opt_state = new._opt.init(new._leaves())
            if self._freeze_until is not None:
                new._frozen = {str(i) for i in range(self._freeze_until + 1)}
            return new

    class GraphBuilder:
        """A graph's head keeps its classes: the reference's GraphBuilder
        has no ``nout_replace`` (ROADMAP queue 3)."""

        def __init__(self, graph: ComputationGraph):
            if not graph._initialized:
                raise ValueError("source graph must be initialized")
            self._src = graph
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._frozen: set = set()
            self._reinit: set = set()

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        fineTuneConfiguration = fine_tune_configuration

        def set_feature_extractor(self, *vertex_names: str):
            """Freeze the named vertices and everything upstream of them
            (ref: GraphBuilder#setFeatureExtractor)."""
            conf = self._src.conf
            frontier = list(vertex_names)
            while frontier:
                name = frontier.pop()
                if name in self._frozen or name in conf.network_inputs:
                    continue
                self._frozen.add(name)
                node = conf.nodes.get(name)
                if node is not None:
                    frontier.extend(node.inputs)
            return self

        setFeatureExtractor = set_feature_extractor

        def reinit_layer(self, *names: str):
            self._reinit.update(names)
            return self

        def build(self) -> ComputationGraph:
            from deeplearning4j_tpu_torch.nn.graph_conf import (
                ComputationGraphConfiguration)
            src = self._src
            conf = ComputationGraphConfiguration.from_json(src.conf.to_json())
            if self._fine_tune is not None:
                self._fine_tune._apply_to_conf(conf)
            new = ComputationGraph(conf, device=src.device).init()
            params, states = dict(new._params), dict(new._states)
            for name, p in src._params.items():
                if name not in self._reinit and p:
                    params[name] = p
            for name, st in src._states.items():
                if name not in self._reinit:
                    states[name] = st
            new.set_param_tree(params)
            new.set_state_tree(states)
            new._opt_state = new._opt.init(new._leaves())
            new._frozen = set(self._frozen)
            return new


class TransferLearningHelper:
    """Featurize through the frozen prefix once, train only the head
    (ref: transferlearning.TransferLearningHelper); a MultiLayerNetwork
    only, as in the reference."""

    def __init__(self, net, frozen_until=None):
        if not isinstance(net, MultiLayerNetwork):
            raise TypeError("TransferLearningHelper supports "
                            "MultiLayerNetwork")
        self.net = net
        self.frozen_until = (frozen_until if frozen_until is not None
                             else max((int(i) for i in net._frozen),
                                      default=-1))

    def featurize(self, dataset):
        """The frozen prefix's output for the dataset's features, with its
        labels (ref: #featurize): ``feedForward`` in inference at index
        ``frozen_until + 1``."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        x = dataset.features if hasattr(dataset, "features") else dataset
        feat = self.net.feedForward(x, train=False)[self.frozen_until + 1]
        return DataSet(feat, getattr(dataset, "labels", None))
