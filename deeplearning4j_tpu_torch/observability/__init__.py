"""Observability core of the port: a process-wide metrics registry and
causal tracing that the serving loop publishes into, with Prometheus
exposition and Chrome-trace JSON export for Perfetto.

Counterpart of ``deeplearning4j_tpu/observability/__init__.py``, lean: it
exports what the ported modules provide — the registry, tracing and the
trace store, the straggler detector, the flight recorder, the SLO rules,
the compile watch (first runs of engine step signatures), the host part
of numerics, device memory from ``torch.cuda.memory_stats`` and the
analytic cost model, and the fleet plane the serving tier reads — the
``timeseries`` rings, the ``watchtower``'s burn-rate and change-point
alerts, and cross-process ``federation`` of traces, metrics and health.
The reference's ``profile_capture`` and the listener-bus
``MetricsReportingListener`` are not ported yet (ROADMAP queue 1 items 6
and 8).

Quick tour::

    from deeplearning4j_tpu_torch.observability import metrics, span

    reqs = metrics().counter("my_requests_total", "requests", ("route",))
    reqs.labels(route="/infer").inc()

    with span("preprocess", batch=32):
        ...

    print(metrics().render_prometheus())      # scrape payload

Kill switches: ``DL4J_TPU_METRICS=0`` (instruments and spans become
no-ops), ``DL4J_TPU_TRACE=0`` (spans only), ``DL4J_TPU_FLIGHT_RECORDER=0``
(watchdog + crash hooks), ``DL4J_TPU_COMPILE_WATCH=0`` (first-run
accounting), ``DL4J_TPU_COST_MODEL=0`` (cost accounting).
"""
from deeplearning4j_tpu_torch.observability.registry import (
    Counter, Gauge, Histogram, MetricsRegistry, DEFAULT_BUCKETS,
    global_registry, metrics_enabled, on_registry_reset,
    reset_global_registry)
from deeplearning4j_tpu_torch.observability.tracing import (
    Span, SpanRecord, TraceContext, TraceSink, current_context,
    current_span, global_trace_sink, now_us, record_span,
    reset_global_trace_sink, span, trace_context, tracing_enabled)
from deeplearning4j_tpu_torch.observability.trace_store import (
    TraceStore, global_trace_store, reset_global_trace_store,
    store_span_close, store_span_open, trace_store_enabled)
from deeplearning4j_tpu_torch.observability.straggler import (
    StragglerDetector)
from deeplearning4j_tpu_torch.observability.flight_recorder import (
    FlightRecorder, global_flight_recorder, reset_global_flight_recorder)
from deeplearning4j_tpu_torch.observability.slo import (
    ErrorRateRule, GaugeThresholdRule, LatencyQuantileRule, SLOEngine,
    SLORule, default_rules, global_slo_engine, reset_global_slo_engine)
from deeplearning4j_tpu_torch.observability.compile_watch import (
    CompileWatch, RetraceStormRule, compile_watch_enabled,
    global_compile_watch, reset_global_compile_watch)
from deeplearning4j_tpu_torch.observability.numerics import (
    DivergenceRule)
from deeplearning4j_tpu_torch.observability import device_memory
from deeplearning4j_tpu_torch.observability.cost_model import (
    CostModel, cost_model_enabled, global_cost_model,
    reset_global_cost_model)
from deeplearning4j_tpu_torch.observability.slo import PerfRegressionRule
from deeplearning4j_tpu_torch.observability.timeseries import (
    TimeseriesStore, global_timeseries, reset_global_timeseries,
    watchtower_enabled)
from deeplearning4j_tpu_torch.observability.watchtower import (
    AlertManager, BurnRateDetector, ChangePointDetector, Detector,
    ThresholdDetector, Watchtower, default_detectors, global_watchtower,
    reset_global_watchtower)

#: ergonomic aliases
metrics = global_registry
trace_sink = global_trace_sink

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "global_registry", "metrics", "metrics_enabled", "on_registry_reset",
    "reset_global_registry",
    "Span", "SpanRecord", "TraceContext", "TraceSink", "current_context",
    "current_span", "global_trace_sink", "now_us", "record_span",
    "reset_global_trace_sink", "span", "trace_context", "tracing_enabled",
    "trace_sink",
    "TraceStore", "global_trace_store", "reset_global_trace_store",
    "store_span_close", "store_span_open", "trace_store_enabled",
    "StragglerDetector",
    "FlightRecorder", "global_flight_recorder",
    "reset_global_flight_recorder",
    "ErrorRateRule", "GaugeThresholdRule", "LatencyQuantileRule",
    "SLOEngine", "SLORule", "default_rules", "global_slo_engine",
    "reset_global_slo_engine",
    "CompileWatch", "RetraceStormRule", "compile_watch_enabled",
    "global_compile_watch", "reset_global_compile_watch",
    "DivergenceRule",
    "device_memory",
    "CostModel", "cost_model_enabled", "global_cost_model",
    "reset_global_cost_model", "PerfRegressionRule",
    "TimeseriesStore", "global_timeseries", "reset_global_timeseries",
    "watchtower_enabled",
    "AlertManager", "BurnRateDetector", "ChangePointDetector", "Detector",
    "ThresholdDetector", "Watchtower", "default_detectors",
    "global_watchtower", "reset_global_watchtower",
]
