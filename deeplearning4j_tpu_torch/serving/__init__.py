"""Serving layer of the port.

Counterpart of ``deeplearning4j_tpu/serving/__init__.py``, lean: only
:mod:`~deeplearning4j_tpu_torch.serving.session` (:class:`Session` +
:class:`SessionJournal`, the durable generation-session layer behind
``DL4J_TPU_SESSIONS``), which ``GenerationPipeline`` imports. The model
registry, rollout, router, front door, shared state and idempotency
journal are not ported yet (ROADMAP queue 1 item 5).
"""
from deeplearning4j_tpu_torch.serving.session import (Session,
                                                      SessionJournal,
                                                      SessionLost,
                                                      sessions_enabled)

__all__ = ["Session", "SessionJournal", "SessionLost", "sessions_enabled"]
