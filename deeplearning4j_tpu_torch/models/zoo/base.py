"""Model-zoo base: counterpart of ``deeplearning4j_tpu/models/zoo/base.py``
(the reference's ``ZooModel``). ``init_model`` builds the network on the
card unless ``device="cpu"``. Pretrained weights load only from a local
cache (``DL4J_TPU_ZOO_CACHE``), as in the reference: ``init_pretrained``
restores a zip from it through ``ModelSerializer.restore`` (either
package's zips, or a DL4J artifact) onto the card unless
``device="cpu"``, and ``save_pretrained`` writes one there.
"""
from __future__ import annotations

import os
from typing import Tuple


class PretrainedType:
    IMAGENET = "imagenet"
    IMAGENETLARGE = "imagenetlarge"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"


class ZooModel:
    """Base for programmatic zoo architectures (ref: zoo.ZooModel)."""

    #: subclasses set: default input shape (H, W, C)
    input_shape: Tuple[int, int, int] = (224, 224, 3)
    num_classes: int = 1000
    #: training-config overrides every zoo builder accepts
    updater = None
    data_type: str = "float32"

    def conf(self):
        """The network configuration (MultiLayerConfiguration or
        ComputationGraphConfiguration)."""
        raise NotImplementedError

    def init_model(self, device=None):
        """Build and init the network on ``device`` (default: the card)."""
        conf = self.conf()
        if hasattr(conf, "network_inputs"):
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
            return ComputationGraph(conf, device=device).init()
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork(conf, device=device).init()

    # reference API alias
    init = init_model

    def pretrained_cache_dir(self) -> str:
        return os.environ.get(
            "DL4J_TPU_ZOO_CACHE",
            os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu", "zoo"))

    def _pretrained_path(self, pretrained_type: str) -> str:
        return os.path.join(self.pretrained_cache_dir(),
                            f"{type(self).__name__.lower()}_{pretrained_type}.zip")

    def init_pretrained(self, pretrained_type: str = PretrainedType.IMAGENET,
                        device=None):
        """ref: ZooModel#initPretrained — local cache only."""
        path = self._pretrained_path(pretrained_type)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"No pretrained weights for {type(self).__name__} "
                f"({pretrained_type}) at {path}. This environment has no "
                f"network egress; place the checkpoint there manually.")
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer)
        return ModelSerializer.restore(path, device=device)

    initPretrained = init_pretrained

    def pretrained_available(self, pretrained_type: str) -> bool:
        return os.path.exists(self._pretrained_path(pretrained_type))

    def save_pretrained(self, net, pretrained_type: str) -> str:
        """Publish a trained net into the local pretrained cache — the
        producer side of ``init_pretrained``. Returns the written path."""
        os.makedirs(self.pretrained_cache_dir(), exist_ok=True)
        path = self._pretrained_path(pretrained_type)
        net.save(path)
        return path
