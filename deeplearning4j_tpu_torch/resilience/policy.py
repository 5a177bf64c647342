"""Resilience policies: retries with budgets, deadlines, circuit breaking.

The serving/training hot paths gain the standard production failure
policies (the TF-Serving/gRPC posture; Abadi et al. arXiv:1605.08695 §9):

- :class:`RetryPolicy` — exponential backoff + deterministic jitter, gated
  by a shared token-bucket :class:`RetryBudget` so a failing dependency
  cannot be amplified into a retry storm (each retry spends a token; only
  successes refill them).
- :class:`Deadline` — a monotonic expiry carried by work items. Requests
  into ``ParallelInference`` may carry one: the batcher sheds already-
  expired requests before padding/dispatch, the completer fails expired
  ones with :class:`DeadlineExceeded`, and expired work never occupies an
  in-flight slot.
- :class:`CircuitBreaker` — consecutive device-execution failures open the
  circuit; callers then fail fast with :class:`CircuitOpenError` instead
  of queueing behind a dead device. After ``reset_timeout_seconds`` a
  bounded number of half-open probes may pass; one probe success closes
  it. State is published as ``dl4j_circuit_state{op}`` (0 closed,
  1 half-open, 2 open) and :class:`CircuitOpenRule` folds it into
  ``/health`` + ``/alerts``.

Typed failure taxonomy (all ``RuntimeError`` subclasses so existing
callers that catch broadly keep working):

- :class:`TransientError`   — retryable by contract (``transient=True``)
- :class:`DeadlineExceeded` — the request outlived its deadline
- :class:`ShedError`        — rejected by admission control (queue full)
- :class:`CircuitOpenError` — failed fast on an open circuit
- :class:`ShutdownError`    — the serving instance was shut down (distinct
  from device errors, for callers and error-rate accounting alike)
- :class:`RestartBudgetExhausted` — ResilientTrainer ran out of restarts

Everything here no-ops/fails open under ``DL4J_TPU_RESILIENCE=0``.
"""
from __future__ import annotations

import os
import random
import threading
import time
import weakref
from typing import Callable, Optional

from deeplearning4j_tpu_torch.observability.slo import (DEGRADED, FAILING, OK,
                                                        SLORule)
from deeplearning4j_tpu_torch.resilience import faults as _faults


# ------------------------------------------------------------------- errors
class ResilienceError(RuntimeError):
    """Base of the typed resilience outcomes."""


class TransientError(ResilienceError):
    """Marked retryable; :func:`is_transient` keys off ``transient``."""
    transient = True


class DeadlineExceeded(ResilienceError):
    pass


class ShedError(ResilienceError):
    pass


class CachePagesExhausted(ShedError):
    """The paged KV-cache pool ran out of free pages — a LOAD outcome
    (the pool admits by actual cached tokens, so a burst of long
    generations can outgrow it), shed typed at a decode step boundary
    or at admission. Retryable by the caller once resident pages drain;
    never an error-rate event (``ShedError`` subclass)."""


class CircuitOpenError(ResilienceError):
    pass


class ShutdownError(RuntimeError):
    """ParallelInference was shut down while the request was in flight —
    a lifecycle outcome, not a device error (callers can route it to
    another replica; error-rate SLOs must not page on it)."""


class RestartBudgetExhausted(ResilienceError):
    pass


#: lifecycle/admission outcomes — typed results a caller routes on, not
#: device errors. THE canonical tuple: ParallelInference and the serving
#: router both exclude exactly these from their error counters (and from
#: breaker failure accounting); a new typed outcome added here reaches
#: every accounting site at once.
TYPED_OUTCOMES = (ShedError, DeadlineExceeded, ShutdownError,
                  CircuitOpenError)


def is_transient(exc: BaseException) -> bool:
    """Retry-safe failures: anything carrying ``transient=True`` —
    :class:`TransientError` subclasses and transient
    :class:`~deeplearning4j_tpu_torch.resilience.faults.InjectedFault`."""
    return bool(getattr(exc, "transient", False))


# ----------------------------------------------------------------- deadline
class Deadline:
    """An absolute monotonic expiry a work item carries across queues."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = float(expires_at)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + max(0.0, float(seconds)))

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls.after(ms / 1e3)

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"


def default_deadline_ms() -> float:
    """``DL4J_TPU_DEADLINE_MS``: default serving deadline (0 = none).
    Read per call so tests can flip it."""
    try:
        return max(0.0, float(os.environ.get("DL4J_TPU_DEADLINE_MS", 0)))
    except (TypeError, ValueError):
        return 0.0


# -------------------------------------------------------------------- retry
class RetryBudget:
    """gRPC-style token bucket: a retry costs one token, a first-attempt
    success refills ``refill_per_success``. When the bucket is dry,
    failures surface immediately — a hard floor on retry amplification."""

    def __init__(self, max_tokens: float = 10.0,
                 refill_per_success: float = 0.1):
        self.max_tokens = float(max_tokens)
        self.refill_per_success = float(refill_per_success)
        self._tokens = self.max_tokens
        self._lock = threading.Lock()

    def allow_retry(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def on_success(self):
        with self._lock:
            self._tokens = min(self.max_tokens,
                               self._tokens + self.refill_per_success)

    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class RetryPolicy:
    """Exponential backoff with deterministic jitter under a shared
    :class:`RetryBudget`. ``call(fn, op=...)`` runs ``fn``, retrying
    failures that satisfy ``retry_on`` (default: :func:`is_transient` —
    blind retry of non-transient device errors could re-execute work whose
    donated buffers are already gone)."""

    def __init__(self, max_retries: int = 3,
                 base_delay_seconds: float = 0.02,
                 max_delay_seconds: float = 1.0, jitter: float = 0.5,
                 budget: Optional[RetryBudget] = None, seed: int = 0,
                 retry_on: Callable[[BaseException], bool] = is_transient):
        self.max_retries = max(0, int(max_retries))
        self.base_delay_seconds = float(base_delay_seconds)
        self.max_delay_seconds = float(max_delay_seconds)
        self.jitter = float(jitter)
        self.budget = budget if budget is not None else RetryBudget()
        self.retry_on = retry_on
        self._rng = random.Random(seed)

    def call(self, fn: Callable, op: str = "op",
             deadline: Optional[Deadline] = None,
             retry_on: Optional[Callable[[BaseException], bool]] = None):
        pred = retry_on if retry_on is not None else self.retry_on
        attempt = 0
        while True:
            try:
                out = fn()
            except Exception as e:
                if (not _faults.resilience_enabled() or not pred(e)
                        or attempt >= self.max_retries
                        or not self.budget.allow_retry()):
                    raise
                delay = min(self.max_delay_seconds,
                            self.base_delay_seconds * (2 ** attempt))
                delay *= 1.0 + self.jitter * self._rng.random()
                if deadline is not None and delay >= deadline.remaining():
                    raise
                attempt += 1
                _retry_counter(op).inc()
                _faults.record_event("retry", op=op, attempt=attempt,
                                     error=type(e).__name__)
                time.sleep(delay)
                continue
            if attempt == 0:
                self.budget.on_success()
            return out


# ---------------------------------------------------------- circuit breaker
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

#: live breakers by id(breaker) for /debug/resilience + bundle snapshots.
#: WEAK values: a breaker abandoned without retire() (its owner dropped on
#: an error path) must not leak here forever, nor keep pinning the shared
#: {op} gauge at OPEN — a finalizer re-publishes the op when one is GC'd
_breakers: "weakref.WeakValueDictionary[int, CircuitBreaker]" = \
    weakref.WeakValueDictionary()
# RLock: a CircuitBreaker's weakref.finalize callback re-acquires this
# lock, and cyclic GC can fire that callback on a thread ALREADY inside a
# locked region (any allocation under the lock can trigger collection) —
# a plain Lock would self-deadlock there
_breakers_lock = threading.RLock()


def _republish_op(op: str):
    """Recompute one op's worst-of-live-breakers gauge value (runs from
    CircuitBreaker finalizers after a breaker is garbage-collected)."""
    try:
        with _breakers_lock:
            states = [b._state for b in list(_breakers.values())
                      if b.op == op]
        _circuit_gauge(op).set(max(states, default=CLOSED))
    except Exception:  # graftlint: disable=typed-errors — best-effort
        pass           # gauge publish; no request outcome flows here


class CircuitBreaker:
    """Consecutive-failure circuit breaker with timed half-open probes."""

    def __init__(self, op: str, failure_threshold: int = 8,
                 reset_timeout_seconds: float = 5.0,
                 half_open_probes: int = 1):
        self.op = op
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_seconds = float(reset_timeout_seconds)
        self.half_open_probes = max(1, int(half_open_probes))
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_left = 0
        self._half_open_since = 0.0
        self._retired = False
        with _breakers_lock:
            _breakers[id(self)] = self
        weakref.finalize(self, _republish_op, op)
        self._publish()

    # state reads/writes under self._lock; the gauge publish happens
    # outside it (registry has its own locking)
    def allow(self) -> bool:
        """May a new unit of work proceed? Also drives the open→half-open
        transition once the reset timeout elapses."""
        if not _faults.resilience_enabled():
            return True
        now = time.monotonic()
        with self._lock:
            if self._retired:
                return True              # inert: the instance is gone
            if self._state == OPEN:
                if now - self._opened_at >= self.reset_timeout_seconds:
                    self._state = HALF_OPEN
                    self._probes_left = self.half_open_probes
                    self._half_open_since = now
                    self._transitioned(OPEN, HALF_OPEN)
                else:
                    return False
            if self._state == HALF_OPEN:
                if (self._probes_left <= 0
                        and now - self._half_open_since
                        >= self.reset_timeout_seconds):
                    # an admitted probe can die a typed death (shed,
                    # deadline) that reports neither success nor failure —
                    # replenish on the reset cadence so the breaker can
                    # never wedge half-open with zero probes forever
                    self._probes_left = self.half_open_probes
                    self._half_open_since = now
                if self._probes_left <= 0:
                    return False
                self._probes_left -= 1
                return True
            return True

    def record_success(self):
        with self._lock:
            if self._retired:
                return
            self._failures = 0
            if self._state != CLOSED:
                prev, self._state = self._state, CLOSED
                self._transitioned(prev, CLOSED)

    def record_failure(self):
        with self._lock:
            if self._retired:
                # a straggling serve thread outliving shutdown's join
                # timeout must not re-open a retired breaker and pin
                # /health failing with no live instance left to clear it
                return
            self._failures += 1
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._failures >= self.failure_threshold):
                prev, self._state = self._state, OPEN
                self._opened_at = time.monotonic()
                self._transitioned(prev, OPEN)

    def _transitioned(self, prev: int, new: int):
        # called with the lock held: keep it to bookkeeping + publish
        self._publish()
        _faults.record_event("circuit", op=self.op,
                             from_state=_STATE_NAMES[prev],
                             to_state=_STATE_NAMES[new],
                             consecutive_failures=self._failures)
        try:
            from deeplearning4j_tpu_torch.observability.tracing import (
                current_context, now_us, record_span)
            record_span("circuit_transition", now_us(),
                        ctx=current_context(), op=self.op,
                        to_state=_STATE_NAMES[new])
        except Exception:  # graftlint: disable=typed-errors — tracing is
            pass           # best-effort; no request outcome flows here

    def _publish(self):
        # several instances may protect the same op (one breaker per
        # ParallelInference): the shared {op} series reports the WORST
        # live state, so a fresh/retiring CLOSED breaker can never mask
        # another instance's OPEN circuit on /health
        try:
            with _breakers_lock:
                peers = [b._state for b in list(_breakers.values())
                         if b.op == self.op]
            _circuit_gauge(self.op).set(max(peers, default=self._state))
        except Exception:  # graftlint: disable=typed-errors — best-effort
            pass           # gauge publish; no request outcome flows here

    def state(self) -> int:
        return self._state

    def state_name(self) -> str:
        return _STATE_NAMES[self._state]

    def retire(self):
        """Forget this breaker (instance shutdown): it goes permanently
        inert and the {op} gauge re-publishes the worst LIVE state, so a
        dead instance's open circuit cannot pin ``/health`` failing."""
        with _breakers_lock:
            _breakers.pop(id(self), None)
        with self._lock:
            self._retired = True
            self._failures = 0
            self._state = CLOSED
        self._publish()

    def snapshot(self) -> dict:
        with self._lock:
            return {"op": self.op, "state": _STATE_NAMES[self._state],
                    "consecutive_failures": self._failures,
                    "failure_threshold": self.failure_threshold,
                    "reset_timeout_seconds": self.reset_timeout_seconds}


def circuit_snapshot() -> list:
    with _breakers_lock:
        live = list(_breakers.values())
    return [b.snapshot() for b in live]


class CircuitOpenRule(SLORule):
    """``/health``/``/alerts`` view of the breakers: any OPEN circuit ⇒
    failing (callers are being failed fast — eject the replica), any
    HALF_OPEN ⇒ degraded (recovery probing in progress)."""

    def __init__(self, name: str = "circuit_breaker",
                 metric: str = "dl4j_circuit_state"):
        super().__init__(name, "circuit-breaker state per protected op "
                               "(0 closed / 1 half-open / 2 open)")
        self.metric = metric

    def _evaluate(self, registry) -> dict:
        inst = registry.get(self.metric)
        if inst is None:
            return {"status": OK, "detail": "no data"}
        open_ops, half_open_ops = [], []
        for lvals, child in inst.series():
            if child.value >= OPEN:
                open_ops.append(",".join(lvals))
            elif child.value >= HALF_OPEN:
                half_open_ops.append(",".join(lvals))
        if open_ops:
            return {"status": FAILING, "open": sorted(open_ops),
                    "half_open": sorted(half_open_ops)}
        if half_open_ops:
            return {"status": DEGRADED, "half_open": sorted(half_open_ops)}
        return {"status": OK}


# ------------------------------------------------------------ metric handles
def _retry_counter(op: str):
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_resilience_retries_total",
            "retries performed by RetryPolicy, per protected operation",
            label_names=("op",)).labels(op=op)
    return _faults.cached_metric_handle(("retry", op), make)


def _circuit_gauge(op: str):
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().gauge(
            "dl4j_circuit_state",
            "circuit-breaker state per protected op: 0 closed, "
            "1 half-open, 2 open", label_names=("op",)).labels(op=op)
    return _faults.cached_metric_handle(("circuit", op), make)


def _on_registry_reset():
    # the shared handle cache is cleared by faults' own reset hook; this
    # one re-publishes the live breakers so the fresh registry's
    # dl4j_circuit_state series stays truthful for /health and snapshots
    with _breakers_lock:
        live = list(_breakers.values())
    for b in live:
        b._publish()


try:
    from deeplearning4j_tpu_torch.observability import on_registry_reset
    on_registry_reset(_on_registry_reset)
except Exception:            # pragma: no cover - observability always present
    pass
