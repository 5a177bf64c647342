"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

A package of its own beside the JAX one, which stays the reference: it
imports torch, numpy and the standard library, and nothing of JAX or of
``deeplearning4j_tpu``. It serves ``TransformerLM`` generation (prefill +
paged KV-cache decode through ``DecodeEngine``) and trains it on one
NVIDIA H100 (``make_train_step`` with ``optim.adamw``), with full-sequence
attention and its gradient in hand-written CUDA flash kernels
(``kernels/csrc/``).

Entry points (``TransformerLM``, ``DecodeEngine``, ``from_jax_params``)
run on the card unless the caller passes ``device="cpu"``; without CUDA
they raise rather than fall back.
"""
from deeplearning4j_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
