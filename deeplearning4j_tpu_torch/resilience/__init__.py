"""Resilience layer of the port: fault injection, deadlines, retries,
circuit breaking and multi-tenant admission control.

Counterpart of ``deeplearning4j_tpu/resilience/__init__.py``, lean:

- :mod:`~deeplearning4j_tpu_torch.resilience.faults` — seeded
  fault-injection registry (``DL4J_TPU_FAULTS`` spec / programmatic
  plans) with named points threaded through the hot paths
  (``generation.step`` in the serving loop).
- :mod:`~deeplearning4j_tpu_torch.resilience.policy` —
  :class:`RetryPolicy`, :class:`Deadline` / :class:`DeadlineExceeded`,
  :class:`CircuitBreaker` (+ :class:`CircuitOpenRule` on ``/health``),
  and the typed failure taxonomy (:class:`ShutdownError`,
  :class:`ShedError`, :class:`CircuitOpenError`, ...).
- :mod:`~deeplearning4j_tpu_torch.resilience.qos` — per-tenant fair
  queueing, quotas and priority preemption.
- :mod:`~deeplearning4j_tpu_torch.resilience.recovery` —
  :class:`ResilientTrainer` (restore newest checkpoint → fast-forward →
  resume, bounded restarts) and :class:`SkippingIterator` (quarantine
  repeatedly failing batches, ``dl4j_data_quarantined_total``), exported
  lazily as in the reference.

Admission control (bounded-queue load shedding, per-request deadlines,
fail-fast circuit gating) lives in ``parallel/inference.py`` and
``parallel/generation.py`` and publishes ``dl4j_inference_shed_total``
and ``dl4j_decode_shed_total``.

The reference's ``elastic`` layer waits for multi-GPU training (ROADMAP
queue 1 item 7B), so :func:`snapshot` has no ``elastic`` section.

Kill switch: ``DL4J_TPU_RESILIENCE=0`` disarms everything. :func:`snapshot`
feeds the flight recorder's ``resilience.json`` bundle section.
"""
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.faults import (
    FaultPlan, FaultSpec, InjectedFault, resilience_enabled)
from deeplearning4j_tpu_torch.resilience.policy import (
    CircuitBreaker, CircuitOpenError, CircuitOpenRule, Deadline,
    DeadlineExceeded, ResilienceError, RestartBudgetExhausted, RetryBudget,
    RetryPolicy, ShedError, ShutdownError, TransientError,
    default_deadline_ms, is_transient)

__all__ = [
    "faults", "FaultPlan", "FaultSpec", "InjectedFault",
    "resilience_enabled",
    "CircuitBreaker", "CircuitOpenError", "CircuitOpenRule", "Deadline",
    "DeadlineExceeded", "ResilienceError", "RestartBudgetExhausted",
    "RetryBudget", "RetryPolicy", "ShedError", "ShutdownError",
    "TransientError", "default_deadline_ms", "is_transient",
    "ResilientTrainer", "SkippingIterator", "newest_checkpoint",
    "snapshot",
]


def snapshot() -> dict:
    """Everything a postmortem needs about the resilience layer: fault
    plan + injection counts, live circuit-breaker states, the default
    deadline, the per-tenant QoS view, and the recent event ring
    (injections, retries, sheds, breaker transitions)."""
    from deeplearning4j_tpu_torch.resilience import policy, qos
    return {
        "enabled": resilience_enabled(),
        "faults": faults.snapshot(),
        "circuits": policy.circuit_snapshot(),
        "default_deadline_ms": policy.default_deadline_ms(),
        # per-tenant QoS breakdown (policies, bucket levels, counters) —
        # the tenant-shed events in the ring need this to mean anything
        "tenants": qos.snapshot(),
        "events": faults.events(),
    }


def __getattr__(name):
    # recovery imports the data/listener layers — lazy so importing the
    # resilience package from those layers' hot paths can never cycle
    if name in ("ResilientTrainer", "SkippingIterator", "newest_checkpoint"):
        from deeplearning4j_tpu_torch.resilience import recovery
        return getattr(recovery, name)
    raise AttributeError(name)
