"""Canary rollout: SLO-gated promotion state machine with auto-rollback.

A candidate version moves through::

    shadow ──▶ canary@p% ──▶ ramp ──▶ full (promoted)
       │           │           │
       └───────────┴───────────┴──▶ rolled_back (drained)

- **shadow** — the candidate takes no user traffic; a deterministic
  sample of requests is *also* scored on it and the outputs compared
  (divergence accounting). Catches wrong-answer regressions before a
  single user sees one.
- **canary** — a hash-stable ``canary_fraction`` of traffic is answered
  by the candidate.
- **ramp** — the share steps through ``ramp_fractions``.
- **full** — the candidate is promoted to primary and the incumbent is
  gracefully drained.

Grading reuses the SLO machinery verbatim: the rollout owns an
:class:`~deeplearning4j_tpu_torch.observability.slo.SLOEngine` whose rules
compare the candidate's live per-version series against the incumbent's
(latency-quantile ratio), against absolute bounds (error rate), and
against the shadow-comparison record (divergence). Every
``window_requests`` candidate-involved requests the engine evaluates:
``ok`` extends the healthy streak (``healthy_windows`` consecutive ok
windows advance the stage), anything else — degraded *or* failing —
rolls back immediately: traffic snaps to the incumbent, the candidate
drains (in-flight requests resolve, typed or correct, never dropped),
and ``dl4j_serving_rollbacks_total`` increments.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Tuple

from deeplearning4j_tpu_torch.observability.slo import (DEGRADED, FAILING, OK,
                                                  SLOEngine, SLORule, _grade)
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.serving.metrics import serving_metrics


class RolloutState:
    SHADOW = "shadow"
    CANARY = "canary"
    RAMP = "ramp"
    FULL = "full"
    ROLLED_BACK = "rolled_back"


_STAGE_NUM = {None: 0, RolloutState.SHADOW: 1, RolloutState.CANARY: 2,
              RolloutState.RAMP: 3, RolloutState.FULL: 4,
              RolloutState.ROLLED_BACK: 5}


@dataclasses.dataclass
class RolloutPolicy:
    """Thresholds and cadence of one rollout (constructor params, same
    posture as the SLO rules: ``None`` disables a grade)."""

    shadow_fraction: float = 0.1      # sampled for shadow scoring
    canary_fraction: float = 0.05     # first real traffic share
    ramp_fractions: Tuple[float, ...] = (0.25, 0.5)
    window_requests: int = 32         # candidate samples per evaluation
    window_seconds: Optional[float] = None
    # ^ time-based evaluation mode: when set, windows close on the
    # WALL CLOCK instead of on the candidate-sample count — a
    # low-traffic (e.g. generative) version still advances or rolls
    # back promptly instead of waiting forever for window_requests
    # samples. A timed window still needs ``window_min_requests``
    # candidate samples before it grades (zero-traffic candidates must
    # not promote on elapsed time alone).
    window_min_requests: int = 1      # candidate samples a timed window
                                      # needs before it may close
    healthy_windows: int = 2          # consecutive ok windows to advance
    latency_quantile: float = 0.5
    latency_ratio_degraded: Optional[float] = 2.0
    latency_ratio_failing: Optional[float] = 4.0
    min_latency_count: int = 16
    error_rate_degraded: Optional[float] = 0.02
    error_rate_failing: Optional[float] = 0.10
    min_requests: int = 16
    divergence_degraded: Optional[float] = 0.01
    divergence_failing: Optional[float] = 0.05
    min_shadow: int = 8
    divergence_rtol: float = 1e-4
    divergence_atol: float = 1e-5
    drain_timeout_s: float = 5.0
    start_stage: str = RolloutState.SHADOW


def _version_child(registry, metric: str, version: str):
    """A live labeled child without creating one (rules never create
    series — the same contract as the SLO engine's rules)."""
    inst = registry.get(metric)
    if inst is None:
        return None
    for lvals, child in inst.series():
        if lvals == (version,):
            return child
    return None


def _child_value(registry, metric: str, version: str) -> float:
    child = _version_child(registry, metric, version)
    return float(child.value) if child is not None else 0.0


def _child_count(registry, metric: str, version: str) -> int:
    child = _version_child(registry, metric, version)
    return int(child.count) if child is not None else 0


class CanaryLatencyRatioRule(SLORule):
    """Candidate latency quantile / incumbent latency quantile — the
    per-version comparison the global p99 rule cannot make.

    ``base_counts`` are the per-version sample counts at rollout start:
    the rule refuses to grade until ``min_count`` NEW samples landed on
    both sides, so a redeployed version's earlier life cannot trip it
    on stale data alone. (The quantile itself is reservoir-lifetime —
    the honest limit the SLO latency rule also documents.)"""

    def __init__(self, candidate: str, incumbent: str, quantile: float,
                 degraded: Optional[float], failing: Optional[float],
                 min_count: int, base_counts=(0, 0)):
        super().__init__(
            "canary_latency_ratio",
            f"p{int(quantile * 100)} latency of {candidate!r} vs "
            f"{incumbent!r}")
        self.candidate, self.incumbent = candidate, incumbent
        self.quantile = quantile
        self.degraded, self.failing = degraded, failing
        self.min_count = min_count
        self.base_counts = base_counts

    def _evaluate(self, registry) -> dict:
        metric = "dl4j_serving_version_latency_seconds"
        cand = _version_child(registry, metric, self.candidate)
        inc = _version_child(registry, metric, self.incumbent)
        if cand is None or inc is None or min(
                cand.count - self.base_counts[0],
                inc.count - self.base_counts[1]) < self.min_count:
            return {"status": OK, "detail": f"<{self.min_count} samples"}
        cq = cand.quantile(self.quantile)
        iq = inc.quantile(self.quantile)
        if not (cq == cq and iq == iq and iq > 0):
            return {"status": OK, "detail": "quantiles unavailable"}
        ratio = cq / iq
        return {"status": _grade(ratio, self.degraded, self.failing),
                "value": ratio, "quantile": self.quantile,
                "candidate_seconds": cq, "incumbent_seconds": iq,
                "degraded_above": self.degraded,
                "failing_above": self.failing}


class CanaryErrorRateRule(SLORule):
    """Candidate errors / candidate requests (typed lifecycle outcomes
    already excluded at the counting site). Graded on the DELTA since
    rollout start (``base``): the per-version counters are
    process-lifetime, and a redeployed version must not inherit a
    previous attempt's errors."""

    def __init__(self, candidate: str, degraded: Optional[float],
                 failing: Optional[float], min_requests: int,
                 base=(0.0, 0.0)):
        super().__init__("canary_error_rate",
                         f"error rate of candidate {candidate!r}")
        self.candidate = candidate
        self.degraded, self.failing = degraded, failing
        self.min_requests = min_requests
        self.base = base          # (requests_at_start, errors_at_start)

    def _evaluate(self, registry) -> dict:
        requests = _child_value(
            registry, "dl4j_serving_version_requests_total",
            self.candidate) - self.base[0]
        if requests < self.min_requests:
            return {"status": OK,
                    "detail": f"<{self.min_requests} requests"}
        errors = _child_value(
            registry, "dl4j_serving_version_errors_total",
            self.candidate) - self.base[1]
        rate = max(0.0, errors) / requests
        return {"status": _grade(rate, self.degraded, self.failing),
                "value": rate, "requests": requests,
                "degraded_above": self.degraded,
                "failing_above": self.failing}


class ShadowDivergenceRule(SLORule):
    """Fraction of shadow-scored comparisons whose outputs diverged from
    the incumbent's (or errored) — wrong answers eject before traffic."""

    def __init__(self, candidate: str, degraded: Optional[float],
                 failing: Optional[float], min_shadow: int,
                 base=None):
        super().__init__("canary_shadow_divergence",
                         f"shadow divergence of candidate {candidate!r}")
        self.candidate = candidate
        self.degraded, self.failing = degraded, failing
        self.min_shadow = min_shadow
        # outcome -> count at rollout start (delta grading, same reason
        # as CanaryErrorRateRule)
        self.base = dict(base or {})

    def _evaluate(self, registry) -> dict:
        inst = registry.get("dl4j_serving_shadow_total")
        if inst is None:
            return {"status": OK, "detail": "no data"}
        counts = {"match": 0.0, "diverged": 0.0, "error": 0.0}
        for lvals, child in inst.series():
            if lvals[0] == self.candidate and lvals[1] in counts:
                counts[lvals[1]] = max(
                    0.0, child.value - self.base.get(lvals[1], 0.0))
        total = sum(counts.values())
        if total < self.min_shadow:
            return {"status": OK,
                    "detail": f"<{self.min_shadow} shadow comparisons"}
        rate = (counts["diverged"] + counts["error"]) / total
        return {"status": _grade(rate, self.degraded, self.failing),
                "value": rate, "comparisons": total,
                "degraded_above": self.degraded,
                "failing_above": self.failing}


class CanaryRollout:
    """See module doc. Constructed by
    :meth:`~deeplearning4j_tpu_torch.serving.router.ServingRouter.begin_rollout`."""

    def __init__(self, router, registry, incumbent, candidate,
                 policy: RolloutPolicy):
        self._router = router
        self._registry = registry
        self.incumbent = incumbent
        self.candidate = candidate
        self.policy = policy
        # baseline the per-version series at rollout start: the counters
        # are process-lifetime, and a redeployed version (or a second
        # rollout attempt) must be graded on what happens DURING this
        # rollout, not on a previous attempt's record
        from deeplearning4j_tpu_torch.observability import global_registry
        reg = global_registry()
        lat = "dl4j_serving_version_latency_seconds"
        shadow_base = {}
        inst = reg.get("dl4j_serving_shadow_total")
        if inst is not None:
            for lvals, child in inst.series():
                if lvals[0] == candidate.version:
                    shadow_base[lvals[1]] = float(child.value)
        self.engine = SLOEngine(rules=[
            CanaryLatencyRatioRule(
                candidate.version, incumbent.version,
                policy.latency_quantile, policy.latency_ratio_degraded,
                policy.latency_ratio_failing, policy.min_latency_count,
                base_counts=(_child_count(reg, lat, candidate.version),
                             _child_count(reg, lat, incumbent.version))),
            CanaryErrorRateRule(
                candidate.version, policy.error_rate_degraded,
                policy.error_rate_failing, policy.min_requests,
                base=(_child_value(
                          reg, "dl4j_serving_version_requests_total",
                          candidate.version),
                      _child_value(
                          reg, "dl4j_serving_version_errors_total",
                          candidate.version))),
            ShadowDivergenceRule(
                candidate.version, policy.divergence_degraded,
                policy.divergence_failing, policy.min_shadow,
                base=shadow_base),
        ])
        self._lock = threading.RLock()
        self._window_samples = 0
        self._window_started = time.monotonic()
        self._healthy_streak = 0
        self._ramp_idx = -1
        self.active = True
        self.rollback_reason: Optional[str] = None
        self.history: List[dict] = []
        self.last_report: Optional[dict] = None
        if policy.start_stage not in (RolloutState.SHADOW,
                                      RolloutState.CANARY):
            raise ValueError("start_stage must be 'shadow' or 'canary', "
                             f"got {policy.start_stage!r}")
        self.stage = policy.start_stage
        self.share = (0.0 if self.stage == RolloutState.SHADOW
                      else policy.canary_fraction)
        self._note_stage(None, self.stage)

    # ----------------------------------------------------------- plumbing
    def _note_stage(self, prev: Optional[str], new: str,
                    reason: Optional[str] = None):
        obs = serving_metrics()
        obs.stage.set(_STAGE_NUM[new])
        obs.traffic(self.candidate.version).set(self.share)
        obs.traffic(self.incumbent.version).set(1.0 - self.share)
        event = {"at": time.time(), "from": prev, "to": new,
                 "share": self.share}
        if reason:
            event["reason"] = reason
        self.history.append(event)
        _faults.record_event("rollout_stage", candidate=self.candidate.version,
                             from_stage=prev, to_stage=new, share=self.share,
                             **({"reason": reason} if reason else {}))

    # ---------------------------------------------------------- recording
    def record_candidate_event(self):
        """One candidate-involved request (canary-served or shadow-scored)
        completed. Request-count mode: every ``window_requests`` of them
        the SLO engine grades the canary. Time mode
        (``window_seconds`` set): the window closes on the wall clock
        instead — checked here AND on every routed request
        (:meth:`maybe_timed_evaluate`), so grading never needs the
        candidate to be busy."""
        with self._lock:
            if not self.active:
                return
            self._window_samples += 1
            if self.policy.window_seconds is not None:
                if not self._timed_window_closed_locked():
                    return
            else:
                if self._window_samples < self.policy.window_requests:
                    return
                self._window_samples = 0
        self.evaluate()

    def _timed_window_closed_locked(self) -> bool:
        """Time-mode window close check (caller holds the lock): enough
        wall time elapsed AND enough candidate samples landed. Resets
        the window on close."""
        p = self.policy
        if time.monotonic() - self._window_started < p.window_seconds:
            return False
        if self._window_samples < max(1, p.window_min_requests):
            return False
        self._window_started = time.monotonic()
        self._window_samples = 0
        return True

    def maybe_timed_evaluate(self):
        """Time-mode grading tick, called by the router on EVERY routed
        request while this rollout is active (cheap: one monotonic read
        under the lock). No-op in request-count mode."""
        if self.policy.window_seconds is None:
            return
        with self._lock:
            if not self.active or not self._timed_window_closed_locked():
                return
        self.evaluate()

    # --------------------------------------------------------- evaluation
    def evaluate(self) -> dict:
        """Grade the canary now: ok extends the healthy streak (and may
        advance the stage); degraded/failing rolls back. Returns the
        engine report. State bookkeeping happens under the lock; the
        drain/promotion itself runs AFTER it releases — a drain can wait
        ``drain_timeout_s`` and must not block every other
        candidate-path request (or ``/debug/deploy``) on the lock for
        that long."""
        with self._lock:
            if not self.active:
                return self.last_report or {"status": OK, "rules": []}
            report = self.engine.evaluate()
            self.last_report = report
            if report["status"] in (DEGRADED, FAILING):
                bad = (report["failing_rules"] or report["degraded_rules"])
                action = self._rollback_locked(
                    f"slo:{','.join(bad)} ({report['status']})")
            else:
                action = None
                self._healthy_streak += 1
                if self._healthy_streak >= self.policy.healthy_windows:
                    self._healthy_streak = 0
                    action = self._advance_locked()
        self._run_action(action)
        return report

    def _run_action(self, action: Optional[str]):
        """The post-transition work that must run WITHOUT the lock. New
        traffic is already steered by the (lock-free) share/stage reads,
        so nothing routes to a version between bookkeeping and drain."""
        if action == "rollback":
            # graceful drain: the candidate stops admitting, in-flight
            # requests resolve (typed or correct), executables release
            self.candidate.drain(timeout_s=self.policy.drain_timeout_s)
        elif action == "promote":
            # the router re-points primary, then gracefully drains the
            # old incumbent
            self._router._promote(self)

    def _advance_locked(self) -> Optional[str]:
        prev = self.stage
        if self.stage == RolloutState.SHADOW:
            self.stage = RolloutState.CANARY
            self.share = self.policy.canary_fraction
        elif self.stage in (RolloutState.CANARY, RolloutState.RAMP):
            self._ramp_idx += 1
            if self._ramp_idx < len(self.policy.ramp_fractions):
                self.stage = RolloutState.RAMP
                self.share = self.policy.ramp_fractions[self._ramp_idx]
            else:
                self.stage = RolloutState.FULL
                self.share = 1.0
                self.active = False
                self._note_stage(prev, self.stage)
                return "promote"
        self._note_stage(prev, self.stage)
        return None

    # ----------------------------------------------------------- rollback
    def rollback(self, reason: str = "manual"):
        with self._lock:
            action = self._rollback_locked(reason)
        self._run_action(action)

    def _rollback_locked(self, reason: str) -> Optional[str]:
        if not self.active:
            return None
        prev = self.stage
        self.stage = RolloutState.ROLLED_BACK
        self.share = 0.0
        self.active = False
        self.rollback_reason = reason
        serving_metrics().rollbacks.inc()
        self._note_stage(prev, self.stage, reason=reason)
        return "rollback"

    # ------------------------------------------------------------ queries
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "candidate": self.candidate.version,
                "incumbent": self.incumbent.version,
                "stage": self.stage,
                "share": self.share,
                "active": self.active,
                "healthy_streak": self._healthy_streak,
                "window_samples": self._window_samples,
                "window_mode": ("time" if self.policy.window_seconds
                                is not None else "requests"),
                "window_seconds": self.policy.window_seconds,
                "rollback_reason": self.rollback_reason,
                "history": list(self.history),
                "last_report": self.last_report,
            }
