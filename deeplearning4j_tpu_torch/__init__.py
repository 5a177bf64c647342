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
(``resilience.recovery.ResilientTrainer``).

Entry points (``TransformerLM``, ``DecodeEngine``, ``from_jax_params``,
the networks and ``ZooModel.init_model``) run on the card unless the
caller passes ``device="cpu"``; without CUDA they raise rather than fall
back.
"""
from deeplearning4j_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
