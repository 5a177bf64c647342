"""Device memory telemetry sampled at step/batch boundaries.

Counterpart of ``deeplearning4j_tpu/observability/device_memory.py``. An
OOM on an accelerator is the other silent killer next to retrace storms
and divergence: fragmentation and leak curves are invisible until the
allocator throws. ``torch.cuda.memory_stats(device)`` exposes the caching
allocator's live view; this module turns it into the reference's gauges

    ``dl4j_device_memory_bytes{device,kind}``   kind ∈ in_use|peak|limit

scraped at ``/metrics`` and snapshotted into flight-recorder bundles
(in_use = ``allocated_bytes.all.current``, peak =
``allocated_bytes.all.peak``, limit = the card's total memory). Sampling
is throttled to at most one sweep per ``_MIN_INTERVAL_S``.

On the CPU (no CUDA) nothing reports: the sampler remembers that and
stops asking (per process), as the reference does on a backend without
stats.

Rides the master kill switch ``DL4J_TPU_METRICS=0``.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.observability.registry import (
    global_registry, metrics_enabled)

_MIN_INTERVAL_S = 1.0

#: stat-dict keys → gauge ``kind`` label (the reference's PJRT naming)
_KINDS = (("bytes_in_use", "in_use"),
          ("peak_bytes_in_use", "peak"),
          ("bytes_limit", "limit"))

_lock = threading.Lock()
_last_sample_mono = 0.0
_unsupported = False


def _stats(index: int) -> dict:
    """One card's allocator stats under the reference's key names."""
    stats = torch.cuda.memory_stats(index)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                index).total_memory}


def _stats_per_device() -> List[tuple]:
    """[(device index, stats-dict)] for the cards that report stats."""
    if not torch.cuda.is_available():
        return []
    return [(i, _stats(i)) for i in range(torch.cuda.device_count())]


def sample(min_interval_s: Optional[float] = None) -> bool:
    """Sweep every card's memory stats into the gauges (throttled).
    Returns True when a sweep actually published."""
    global _last_sample_mono, _unsupported
    if not metrics_enabled() or _unsupported:
        return False
    interval = _MIN_INTERVAL_S if min_interval_s is None else min_interval_s
    now = time.monotonic()
    with _lock:
        if now - _last_sample_mono < interval:
            return False
        _last_sample_mono = now
    per_dev = _stats_per_device()
    if not per_dev:
        # nothing reports (CPU) — stop asking
        _unsupported = True
        return False
    gauge = global_registry().gauge(
        "dl4j_device_memory_bytes",
        "CUDA caching-allocator memory per card (sampled at step/batch "
        "boundaries): kind=in_use|peak|limit",
        label_names=("device", "kind"))
    for index, stats in per_dev:
        for stat_key, kind in _KINDS:
            gauge.labels(device=str(index), kind=kind).set(
                float(stats[stat_key]))
    return True


def snapshot() -> dict:
    """Unthrottled point-in-time view for postmortem bundles (no device
    listed without CUDA)."""
    return {"devices": [{
        "id": index, "platform": "gpu",
        "kind": torch.cuda.get_device_name(index),
        "memory_stats": {k: stats[k] for k in sorted(stats)}}
        for index, stats in _stats_per_device()]}


def reset_for_tests() -> None:
    """Forget the throttle and the unsupported latch (test isolation)."""
    global _last_sample_mono, _unsupported
    with _lock:
        _last_sample_mono = 0.0
        _unsupported = False
