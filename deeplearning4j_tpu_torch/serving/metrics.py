"""Label-bound serving-rollout instruments (one home, registry-reset safe).

Per-version series are labeled ``{version}`` — cardinality is bounded by
the number of versions a process ever deploys (a handful), the same
tradeoff the circuit-breaker ``{op}`` gauge makes.
"""
from __future__ import annotations

import threading

from deeplearning4j_tpu_torch.observability import global_registry, on_registry_reset


class _ServingRolloutMetrics:
    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        reg = global_registry()
        self._requests = reg.counter(
            "dl4j_serving_version_requests_total",
            "ServingRouter requests routed, by model version",
            label_names=("version",))
        self._errors = reg.counter(
            "dl4j_serving_version_errors_total",
            "ServingRouter requests that raised a non-typed error, by "
            "model version (typed shed/deadline/shutdown outcomes "
            "excluded, matching the inference error-rate SLO)",
            label_names=("version",))
        self._latency = reg.histogram(
            "dl4j_serving_version_latency_seconds",
            "end-to-end routed request latency, by model version (the "
            "canary grader's latency-ratio numerator/denominator)",
            label_names=("version",))
        self._traffic = reg.gauge(
            "dl4j_serving_version_traffic_ratio",
            "configured traffic share per model version (1.0 = all "
            "traffic; the rollout state machine moves this)",
            label_names=("version",))
        self._warmup = reg.gauge(
            "dl4j_serving_version_warmup_seconds",
            "AOT warmup wall time the version paid at deploy, before "
            "becoming eligible for traffic", label_names=("version",))
        self._shadow = reg.counter(
            "dl4j_serving_shadow_total",
            "shadow-scored canary comparisons against the incumbent, by "
            "version and outcome (match / diverged / error)",
            label_names=("version", "outcome"))
        self.rollbacks = reg.counter(
            "dl4j_serving_rollbacks_total",
            "canary rollouts auto-rolled-back by the SLO gate (or rolled "
            "back explicitly)")
        self.stage = reg.gauge(
            "dl4j_serving_rollout_stage",
            "active rollout stage: 0 none, 1 shadow, 2 canary, 3 ramp, "
            "4 full, 5 rolled_back")

    def requests(self, version):
        return self._requests.labels(version=version)

    def errors(self, version):
        return self._errors.labels(version=version)

    def latency(self, version):
        return self._latency.labels(version=version)

    def traffic(self, version):
        return self._traffic.labels(version=version)

    def warmup_seconds(self, version):
        return self._warmup.labels(version=version)

    def shadow(self, version, outcome):
        return self._shadow.labels(version=version, outcome=outcome)

    @classmethod
    def get(cls) -> "_ServingRolloutMetrics":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance


def serving_metrics() -> _ServingRolloutMetrics:
    return _ServingRolloutMetrics.get()


@on_registry_reset
def _drop():
    _ServingRolloutMetrics._instance = None
