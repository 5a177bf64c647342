"""Throughput/bandwidth tracking
(ref: org.nd4j.linalg.api.ops.performance.PerformanceTracker +
listeners.PerformanceListener internals).

Counterpart of ``deeplearning4j_tpu/profiler/performance.py``: every
recording is published into the process-wide metrics registry
(``dl4j_perf_*`` / ``dl4j_transfer_bytes_total`` series). The accessors
are INSTANCE-local windows (two trackers don't alias each other's
numbers, and an explicitly constructed tracker keeps working under
``DL4J_TPU_METRICS=0`` — the kill switch silences the export, not the
tool)."""
from __future__ import annotations

import time
from typing import Optional

from deeplearning4j_tpu_torch.observability import global_registry, on_registry_reset


class PerformanceTracker:
    """Examples/sec + host↔device byte accounting. The reference tracks
    memcpy bandwidth per device; here transfers are whatever crosses
    between the host and the card — callers report them via
    ``add_transfer_bytes``."""

    _instance: Optional["PerformanceTracker"] = None

    def __init__(self):
        self._bind()
        self.reset()

    def _bind(self):
        reg = global_registry()
        self._examples_c = reg.counter(
            "dl4j_perf_examples_total",
            "examples reported to PerformanceTracker")
        self._iterations_c = reg.counter(
            "dl4j_perf_iterations_total",
            "iterations reported to PerformanceTracker")
        tb = reg.counter("dl4j_transfer_bytes_total",
                         "host<->device transfer bytes",
                         label_names=("direction",))
        self._h2d_c = tb.labels(direction="h2d")
        self._d2h_c = tb.labels(direction="d2h")

    @classmethod
    def get_instance(cls) -> "PerformanceTracker":
        if cls._instance is None:
            cls._instance = PerformanceTracker()
        return cls._instance

    getInstance = get_instance

    def reset(self):
        self._start = time.time()
        self.examples = 0
        self.iterations = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0

    def record_iteration(self, batch_size: int):
        self.examples += batch_size
        self.iterations += 1
        self._examples_c.inc(batch_size)
        self._iterations_c.inc()

    def add_transfer_bytes(self, host_to_device: int = 0,
                           device_to_host: int = 0):
        self.h2d_bytes += host_to_device
        self.d2h_bytes += device_to_host
        if host_to_device:
            self._h2d_c.inc(host_to_device)
        if device_to_host:
            self._d2h_c.inc(device_to_host)

    addMemoryTransaction = add_transfer_bytes

    @property
    def elapsed(self) -> float:
        return max(time.time() - self._start, 1e-9)

    def examples_per_second(self) -> float:
        return self.examples / self.elapsed

    def iterations_per_second(self) -> float:
        return self.iterations / self.elapsed

    def bandwidth_mb_s(self) -> float:
        return (self.h2d_bytes + self.d2h_bytes) / self.elapsed / 1e6

    def summary(self) -> str:
        return (f"{self.examples} examples in {self.elapsed:.1f}s "
                f"({self.examples_per_second():.1f} ex/s, "
                f"{self.iterations_per_second():.2f} it/s, "
                f"{self.bandwidth_mb_s():.1f} MB/s transfers)")


@on_registry_reset
def _rebind_tracker():
    if PerformanceTracker._instance is not None:
        PerformanceTracker._instance._bind()
