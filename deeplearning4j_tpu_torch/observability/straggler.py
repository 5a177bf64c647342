"""Slow-step (straggler) detection over a rolling median.

Distributed-training throughput dies on per-step tail latency (Awan et al.
arXiv:1810.11112 characterize exactly this step-time-vs-communication
decomposition): one slow host/input shard stalls every synchronous
allreduce. The detector keeps a rolling window of recent step durations and
counts steps exceeding ``k × rolling-median`` into the registry, labeled by
phase, so a scrape shows *that* and *where* stalls happen without a trace.
"""
from __future__ import annotations

import threading
from typing import Optional

from deeplearning4j_tpu_torch.observability.registry import (MetricsRegistry,
                                                             global_registry)


class StragglerDetector:
    """Counts observations exceeding ``threshold ×`` the rolling median.

    The first ``warmup`` observations only seed the window — compile /
    cache-cold steps would otherwise poison the median and flag every
    subsequent healthy step as "fast" relative to a bogus baseline.
    """

    def __init__(self, phase: str = "train_step", threshold: float = 3.0,
                 window: int = 64, warmup: int = 3,
                 registry: Optional[MetricsRegistry] = None):
        if threshold <= 1.0:
            raise ValueError("threshold must exceed 1.0")
        self.phase = phase
        self.threshold = threshold
        self.window = max(8, window)
        self.warmup = warmup
        self._samples: list = []
        self._pos = 0
        self._seen = 0
        self._lock = threading.Lock()
        reg = registry or global_registry()
        self._slow = reg.counter(
            "dl4j_slow_steps_total",
            "steps slower than k x rolling-median step time",
            label_names=("phase",)).labels(phase=phase)
        self._total = reg.counter(
            "dl4j_straggler_checked_steps_total",
            "steps checked by the straggler detector",
            label_names=("phase",)).labels(phase=phase)

    def _median(self) -> float:
        data = sorted(self._samples)
        n = len(data)
        mid = n // 2
        return data[mid] if n % 2 else (data[mid - 1] + data[mid]) / 2.0

    def observe(self, seconds: float) -> bool:
        """Record one step duration; returns True when flagged slow."""
        slow = False
        with self._lock:
            self._seen += 1
            warm = self._seen > self.warmup and self._samples
            if warm:
                median = self._median()
                slow = median > 0 and seconds > self.threshold * median
            if self._seen > self.warmup:
                self._total.inc()
            if len(self._samples) < self.window:
                self._samples.append(seconds)
            else:
                self._samples[self._pos] = seconds
                self._pos = (self._pos + 1) % self.window
        if slow:
            self._slow.inc()
        return slow

    @property
    def slow_count(self) -> int:
        return int(self._slow.value)
