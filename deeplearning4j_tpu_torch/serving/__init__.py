"""Serving plane of the port: versioned generative deploys, canary
rollout, drain, the HTTP/SSE front door and the multi-process fleet.

Counterpart of ``deeplearning4j_tpu/serving/__init__.py``, with the same
exports and :func:`snapshot`. The modules are the reference's, each
serving the generative lane over the port's ``GenerationPipeline``:

- :mod:`~deeplearning4j_tpu_torch.serving.registry` — :class:`ModelRegistry`:
  ``deploy_generative(version, engine)`` builds a ``GenerationPipeline``
  and runs every prefill bucket, the slot insert and the decode step
  before the version admits traffic; ``retire(version)`` drains.
- :mod:`~deeplearning4j_tpu_torch.serving.rollout` — :class:`CanaryRollout`:
  the shadow → canary → ramp → full / rolled-back state machine, graded
  by per-version SLO rules.
- :mod:`~deeplearning4j_tpu_torch.serving.router` — :class:`ServingRouter`:
  the ``generate()`` front-end with the deterministic hash split.
- :mod:`~deeplearning4j_tpu_torch.serving.frontdoor` — :class:`FrontDoor`:
  ``POST /v1/generate`` (JSON or per-token SSE), the ``/admin`` and
  ``/debug`` surfaces, session adoption and the fleet sync loop.
- :mod:`~deeplearning4j_tpu_torch.serving.shared_state` —
  :class:`SharedStore` + :class:`SharedServingState`: the file-backed
  store N worker processes coordinate through, with lease-fenced
  leadership, digest-checked reads, quarantine and rebuild.
- :mod:`~deeplearning4j_tpu_torch.serving.idempotency` —
  :class:`ResultJournal`: the ``X-Dl4j-Idempotency-Key`` replay journal.
- :mod:`~deeplearning4j_tpu_torch.serving.session` — :class:`Session` +
  :class:`SessionJournal`: durable generation sessions.

The scoring lane — ``ModelRegistry.deploy``, the router's ``output``,
``POST /v1/classify`` — serves a DL4J network through
``ParallelInference`` and waits for it (ROADMAP queue 1 item 8); until
then ``/v1/classify`` answers 404, as the reference does with no scoring
deploy behind its door.
"""
from deeplearning4j_tpu_torch.serving.errors import (RolloutConflictError,
                                               StoreLockTimeout)
from deeplearning4j_tpu_torch.serving.frontdoor import (FrontDoor, fleet_snapshot,
                                                  frontdoor_enabled)
from deeplearning4j_tpu_torch.serving.idempotency import (IDEMPOTENCY_HEADER,
                                                    ResultJournal,
                                                    idempotency_enabled)
from deeplearning4j_tpu_torch.serving.registry import DeployedVersion, ModelRegistry
from deeplearning4j_tpu_torch.serving.rollout import (CanaryRollout, RolloutPolicy,
                                                RolloutState)
from deeplearning4j_tpu_torch.serving.router import ServingRouter, rollout_enabled
from deeplearning4j_tpu_torch.serving.session import (Session, SessionJournal,
                                                SessionLost,
                                                sessions_enabled)
from deeplearning4j_tpu_torch.serving.shared_state import (SharedServingState,
                                                     SharedStore,
                                                     fleet_fence_enabled)

__all__ = [
    "ModelRegistry", "DeployedVersion", "CanaryRollout", "RolloutPolicy",
    "RolloutState", "ServingRouter", "rollout_enabled", "snapshot",
    "FrontDoor", "frontdoor_enabled", "SharedStore", "SharedServingState",
    "RolloutConflictError", "StoreLockTimeout", "fleet_fence_enabled",
    "fleet_snapshot", "ResultJournal", "IDEMPOTENCY_HEADER",
    "idempotency_enabled", "Session", "SessionJournal", "SessionLost",
    "sessions_enabled",
]


def snapshot() -> dict:
    """The ``/debug/deploy`` + bundle ``deploy.json`` payload: every live
    registry's versions (state, warmup, traffic) and every live router's
    rollout state machine."""
    return {
        "rollout_enabled": rollout_enabled(),
        "registries": [r.snapshot() for r in list(ModelRegistry._live)],
        "routers": [r.snapshot() for r in list(ServingRouter._live)],
    }
