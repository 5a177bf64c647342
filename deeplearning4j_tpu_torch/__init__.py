"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

A package of its own beside the JAX one, which stays the reference: it
imports torch, numpy and the standard library, and nothing of JAX or of
``deeplearning4j_tpu``. It serves ``TransformerLM`` generation (prefill +
paged KV-cache decode through ``DecodeEngine``, continuous batching of
concurrent requests through ``parallel.generation.GenerationPipeline``)
and trains it on one NVIDIA H100 (``make_train_step`` with
``optim.adamw``), with attention, its gradient, the chunked cross-entropy,
MoE token movement and paged decode attention in hand-written CUDA kernels
(``kernels/csrc/``). It builds, trains and runs DL4J networks
(``nn.multilayer.MultiLayerNetwork``, ``nn.graph.ComputationGraph``, the
zoo's ``ResNet50``, ``LeNet`` and ``SimpleCNN``) with cuDNN convolutions,
serves them (``parallel.inference.ParallelInference``, the ``serving``
plane's scoring lane) and heals their training
(``resilience.recovery.ResilientTrainer``). ND4J's surface is the
``ndarray`` package: the ``NDArray`` over a torch tensor, the ``nd``
factory (exported here, as the reference exports it) and its ``Nd4j``
facade, ``NDArrayIndex``, and the op executioner over the registry
(``Nd4j.getExecutioner().exec(...)``); ``ops.transforms`` holds
``Transforms``.

Entry points (``TransformerLM``, ``DecodeEngine``, ``from_jax_params``,
the networks, ``ZooModel.init_model`` and the ``nd`` factory) run on the
card unless the caller passes ``device="cpu"`` (for ``nd``, or sets
``nd.setDefaultDevice("cpu")``); without CUDA they raise rather than fall
back.
"""
from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.ndarray import nd

__all__ = ["resolve_device", "nd"]
