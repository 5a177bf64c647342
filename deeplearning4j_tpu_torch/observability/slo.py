"""SLO engine: declarative health rules evaluated from the metrics registry.

``/health`` used to be a hardcoded ``"ok"`` — production health must be
*measured* (the serving-SLO posture of TF-Serving-style stacks, Abadi et
al. arXiv:1605.08695 §9). A rule reads live series from the registry and
grades them ``ok`` / ``degraded`` / ``failing``; the engine folds rule
grades into one process status, tracks transitions, and feeds:

- ``UIServer GET /health`` — JSON report, HTTP 503 when any rule fails
  (load balancers eject the replica), 200 with ``status: degraded``
  otherwise (alerting without traffic loss);
- ``UIServer GET /alerts`` — currently-violated rules with since-when
  timestamps plus the recent transition history.

Rules are deliberately few and structural (thresholds are constructor
params; ``None`` disables a grade):

- :class:`LatencyQuantileRule` — a histogram quantile (reservoir-exact)
  against degraded/failing bounds; skips until ``min_count`` samples so a
  near-empty histogram cannot grade a fresh process. Note the honest
  limit: a cold-compile outlier still dominates p99 until enough traffic
  dilutes the reservoir — ``min_count`` bounds how *early* that can
  happen (default 16), it does not exclude the outlier.
- :class:`ErrorRateRule`      — errors/requests counter ratio.
- :class:`GaugeThresholdRule` — gauge bound, ``mode="above"`` (queue
  depth) or ``"below"`` (prefetch overlap ratio), optionally gated on an
  activity counter so an idle pipeline reads healthy.

Evaluation never *creates* series (rules peek at live children only) and a
rule that raises grades ``degraded`` with the error in ``detail`` — a
typo'd rule must page, not crash the probe.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.observability.registry import (Histogram,
                                                             MetricsRegistry,
                                                             global_registry,
                                                             on_registry_reset)

OK, DEGRADED, FAILING = "ok", "degraded", "failing"
_SEVERITY = {OK: 0, DEGRADED: 1, FAILING: 2}


def _children(inst):
    """Live (label_values, child) series WITHOUT creating any (the
    registry's public enumeration surface)."""
    return inst.series()


def _grade(value: float, degraded: Optional[float],
           failing: Optional[float], below: bool = False) -> str:
    if failing is not None and (value < failing if below
                                else value > failing):
        return FAILING
    if degraded is not None and (value < degraded if below
                                 else value > degraded):
        return DEGRADED
    return OK


class SLORule:
    """One named health check; subclasses implement :meth:`_evaluate`."""

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description

    def evaluate(self, registry: MetricsRegistry) -> dict:
        try:
            result = self._evaluate(registry)
        except Exception as e:
            result = {"status": DEGRADED, "detail": f"rule error: {e!r}"}
        result.setdefault("status", OK)
        result["rule"] = self.name
        if self.description:
            result.setdefault("description", self.description)
        return result

    def _evaluate(self, registry: MetricsRegistry) -> dict:
        raise NotImplementedError


class LatencyQuantileRule(SLORule):
    def __init__(self, name: str, metric: str, quantile: float = 0.99,
                 degraded: Optional[float] = 1.0,
                 failing: Optional[float] = 5.0,
                 min_count: int = 16, description: str = ""):
        super().__init__(name, description or
                         f"p{int(quantile * 100)} of {metric}")
        self.metric = metric
        self.quantile = quantile
        self.degraded = degraded
        self.failing = failing
        self.min_count = min_count

    def _evaluate(self, registry: MetricsRegistry) -> dict:
        inst = registry.get(self.metric)
        if not isinstance(inst, Histogram):
            return {"status": OK, "detail": "no data"}
        # worst child wins: a healthy INSTANT series must not mask a
        # drowning BATCHED one
        worst, worst_labels, total = None, (), 0
        for lvals, child in _children(inst):
            total += child.count
            if child.count < self.min_count:
                continue
            q = child.quantile(self.quantile)
            if q == q and (worst is None or q > worst):
                worst, worst_labels = q, lvals
        if worst is None:
            return {"status": OK, "samples": total,
                    "detail": f"<{self.min_count} samples"}
        return {"status": _grade(worst, self.degraded, self.failing),
                "value": worst, "quantile": self.quantile,
                "labels": list(worst_labels), "degraded_above": self.degraded,
                "failing_above": self.failing}


class ErrorRateRule(SLORule):
    def __init__(self, name: str, errors_metric: str, requests_metric: str,
                 degraded: Optional[float] = 0.01,
                 failing: Optional[float] = 0.05,
                 min_requests: int = 20, description: str = ""):
        super().__init__(name, description or
                         f"{errors_metric} / {requests_metric}")
        self.errors_metric = errors_metric
        self.requests_metric = requests_metric
        self.degraded = degraded
        self.failing = failing
        self.min_requests = min_requests

    @staticmethod
    def _total(registry, name) -> float:
        inst = registry.get(name)
        if inst is None:
            return 0.0
        return sum(child.value for _, child in _children(inst))

    def _evaluate(self, registry: MetricsRegistry) -> dict:
        requests = self._total(registry, self.requests_metric)
        if requests < self.min_requests:
            return {"status": OK, "requests": requests,
                    "detail": f"<{self.min_requests} requests"}
        rate = self._total(registry, self.errors_metric) / requests
        return {"status": _grade(rate, self.degraded, self.failing),
                "value": rate, "requests": requests,
                "degraded_above": self.degraded,
                "failing_above": self.failing}


class GaugeThresholdRule(SLORule):
    def __init__(self, name: str, metric: str,
                 degraded: Optional[float] = None,
                 failing: Optional[float] = None, mode: str = "above",
                 activity_metric: Optional[str] = None,
                 min_activity: float = 0, description: str = ""):
        if mode not in ("above", "below"):
            raise ValueError("mode must be 'above' or 'below'")
        super().__init__(name, description or
                         f"{metric} {mode} threshold")
        self.metric = metric
        self.degraded = degraded
        self.failing = failing
        self.mode = mode
        self.activity_metric = activity_metric
        self.min_activity = min_activity

    def _evaluate(self, registry: MetricsRegistry) -> dict:
        if self.activity_metric is not None:
            activity = ErrorRateRule._total(registry, self.activity_metric)
            if activity < self.min_activity:
                return {"status": OK,
                        "detail": f"<{self.min_activity} observations"}
        inst = registry.get(self.metric)
        if inst is None:
            return {"status": OK, "detail": "no data"}
        below = self.mode == "below"
        values = [child.value for _, child in _children(inst)]
        if not values:
            return {"status": OK, "detail": "no data"}
        worst = min(values) if below else max(values)
        key = "below" if below else "above"
        return {"status": _grade(worst, self.degraded, self.failing,
                                 below=below),
                "value": worst, f"degraded_{key}": self.degraded,
                f"failing_{key}": self.failing}


class PerfRegressionRule(SLORule):
    """Live MFU sustained below its own rolling baseline — the cost
    observatory's per-fn MFU (cost_model FLOPs / rolling-mean step time)
    is compared against the slow-EWMA reference the model keeps for each
    entry point. A sustained drop means the same program got slower:
    input starvation, a background process, a degraded interconnect, or
    a silently worse executable. Perf-only signal: degrades, never fails
    (slow is a page, not an ejection). Thin-data gated — a fn needs
    ``min_samples`` timed executions before it can grade."""

    def __init__(self, name: str = "perf_regression",
                 drop: Optional[float] = None,
                 min_samples: int = 24, description: str = ""):
        if drop is None:
            # ONE constant shared with the baseline's freeze margin
            # (cost_model) — a drop this rule flags can never erode its
            # own reference. A custom smaller drop loses that guarantee.
            from deeplearning4j_tpu_torch.observability.cost_model import (
                PERF_REGRESSION_DROP)
            drop = PERF_REGRESSION_DROP
        super().__init__(name, description or
                         f"live MFU > {drop:.0%} below its rolling baseline")
        self.drop = drop
        self.min_samples = min_samples

    def _evaluate(self, registry) -> dict:
        # lazy: cost_model imports nothing from here, but keeping the
        # import out of module scope matches the other observatory rules
        from deeplearning4j_tpu_torch.observability.cost_model import (
            global_cost_model)
        worst = None
        for fn, mfu, baseline, samples in global_cost_model(
                ).regression_view():
            if samples < self.min_samples or not baseline:
                continue
            ratio = mfu / baseline
            if worst is None or ratio < worst[1]:
                worst = (fn, ratio, mfu, baseline)
        if worst is None:
            return {"status": OK, "detail": f"<{self.min_samples} samples"}
        fn, ratio, mfu, baseline = worst
        status = DEGRADED if ratio < 1.0 - self.drop else OK
        return {"status": status, "value": ratio,
                "degraded_below": 1.0 - self.drop,
                "detail": f"{fn}: mfu {mfu:.4g} vs baseline "
                          f"{baseline:.4g}"}


def default_rules() -> List[SLORule]:
    """The serving/training SLOs every deployment cares about. Perf-only
    signals (prefetch overlap, retrace churn) cap short of ejection —
    slow is a page; divergence IS an ejection (every further step is
    wasted accelerator time)."""
    # lazy: compile_watch/numerics (and resilience.policy) import SLORule
    # from this module
    from deeplearning4j_tpu_torch.observability.compile_watch import (
        RetraceStormRule)
    from deeplearning4j_tpu_torch.observability.numerics import DivergenceRule
    from deeplearning4j_tpu_torch.resilience.policy import CircuitOpenRule
    return [
        LatencyQuantileRule(
            "inference_p99_latency_seconds",
            "dl4j_inference_latency_seconds", quantile=0.99,
            degraded=1.0, failing=5.0, min_count=16,
            description="end-to-end ParallelInference p99 latency"),
        ErrorRateRule(
            "inference_error_rate",
            "dl4j_inference_errors_total", "dl4j_inference_requests_total",
            degraded=0.01, failing=0.05, min_requests=20,
            description="fraction of ParallelInference requests that raised"),
        GaugeThresholdRule(
            "inference_queue_depth",
            "dl4j_inference_queue_depth", degraded=48, failing=256,
            mode="above",
            description="requests waiting in the serving batch queue"),
        GaugeThresholdRule(
            "prefetch_overlap_ratio",
            "dl4j_async_overlap_ratio", degraded=0.2, failing=None,
            mode="below", activity_metric="dl4j_async_prefetch_total",
            min_activity=256,
            description="fraction of batches already on device when the "
                        "step asked (transfer/compute overlap health)"),
        RetraceStormRule(),
        DivergenceRule(),
        # the same program getting slower (MFU under its own rolling
        # baseline) pages; like retrace churn it never ejects the replica
        PerfRegressionRule(),
        # per-tenant SLO: the WORST tenant's p99 grades /health (the
        # worst-child-wins rule semantics — a drowning tenant must not
        # hide behind the healthy aggregate; labels are bounded by the
        # qos tenant_label top-N helper, so this scan stays small)
        LatencyQuantileRule(
            "tenant_p99_latency_seconds",
            "dl4j_tenant_latency_seconds", quantile=0.99,
            degraded=1.0, failing=5.0, min_count=16,
            description="per-tenant end-to-end p99 latency (worst "
                        "tenant wins; multi-tenant QoS)"),
        # an OPEN circuit means callers are being failed fast — eject the
        # replica; half-open (recovery probing) is a page, not an ejection
        CircuitOpenRule(),
    ]


#: every live engine, global or privately held (FleetHealth, rollout
#: gates) — a drill/test reset must clear ALL since/transition state,
#: not just the global engine's, or fleet alert timestamps survive
#: `reset_global_slo_engine()` and the next phase starts dirty
_ALL_ENGINES: "weakref.WeakSet[SLOEngine]" = weakref.WeakSet()


class SLOEngine:
    """Evaluates a rule set against a registry and tracks transitions."""

    _HISTORY_MAX = 64

    def __init__(self, rules: Optional[Sequence[SLORule]] = None,
                 registry=None):
        self.rules: List[SLORule] = list(rules if rules is not None
                                         else default_rules())
        self._registry = registry        # None = global (resolved per eval)
        self._lock = threading.Lock()
        self._since: Dict[str, tuple] = {}     # rule -> (status, since_ts)
        self._history: List[dict] = []         # recent transitions
        _ALL_ENGINES.add(self)

    def add_rule(self, rule: SLORule) -> "SLOEngine":
        self.rules.append(rule)
        return self

    def reset_state(self):
        with self._lock:
            self._since.clear()
            self._history.clear()

    def evaluate(self) -> dict:
        reg = self._registry or global_registry()
        results = [rule.evaluate(reg) for rule in self.rules]
        now = time.time()
        with self._lock:
            for res in results:
                prev = self._since.get(res["rule"])
                if prev is None or prev[0] != res["status"]:
                    self._since[res["rule"]] = (res["status"], now)
                    if prev is not None or res["status"] != OK:
                        self._history.append(
                            {"rule": res["rule"],
                             "from": prev[0] if prev else OK,
                             "to": res["status"], "at": now})
                        del self._history[:-self._HISTORY_MAX]
                res["since"] = self._since[res["rule"]][1]
        overall = max((r["status"] for r in results),
                      key=_SEVERITY.__getitem__, default=OK)
        return {
            "status": overall,
            "rules": results,
            "degraded_rules": [r["rule"] for r in results
                               if r["status"] == DEGRADED],
            "failing_rules": [r["rule"] for r in results
                              if r["status"] == FAILING],
        }

    def alerts(self) -> dict:
        """Active violations (with since-when) + recent transitions —
        re-evaluates so the answer is current, not last-scrape."""
        report = self.evaluate()
        active = [{"rule": r["rule"], "status": r["status"],
                   "since": r["since"],
                   "value": r.get("value"),
                   "detail": r.get("detail")}
                  for r in report["rules"] if r["status"] != OK]
        with self._lock:
            history = list(self._history)
        return {"status": report["status"], "active": active,
                "history": history}


_global_engine: Optional[SLOEngine] = None
_engine_lock = threading.Lock()


def global_slo_engine() -> SLOEngine:
    """THE process-wide engine ``/health`` and ``/alerts`` consult."""
    global _global_engine
    if _global_engine is None:
        with _engine_lock:
            if _global_engine is None:
                _global_engine = SLOEngine()
    return _global_engine


def _reset_all_engine_state():
    for eng in list(_ALL_ENGINES):
        eng.reset_state()


def reset_global_slo_engine(
        rules: Optional[Sequence[SLORule]] = None) -> SLOEngine:
    global _global_engine
    with _engine_lock:
        _global_engine = SLOEngine(rules)
    # every OTHER live engine too: alert since-timestamps must not
    # survive the reset through a privately-held engine (the fleet
    # health view, a rollout gate) — drills and tests start clean
    _reset_all_engine_state()
    return _global_engine


@on_registry_reset
def _clear_engine_state():
    # a fresh registry invalidates since/transition state (tests reset the
    # registry under a long-lived engine) — for every live engine, not
    # just the global one
    _reset_all_engine_state()
