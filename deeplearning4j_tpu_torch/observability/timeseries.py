"""Bounded in-process timeseries rings fed by a periodic registry scrape.

The registry answers "what is the value NOW"; a postmortem needs "what
were the minutes BEFORE the trip".  This module keeps a small ring of
``(ts, value)`` samples per metric name — counters and gauges as their
summed-across-children value, histograms as cumulative ``:count`` /
``:sum`` plus a point-in-time ``:p99`` — fed by a cheap throttled scrape
that rides the front door's sync beat (never the request hot path).

Consumers:

- ``GET /debug/timeseries`` on the UI server, front door, and proxy
  admin port (:func:`timeseries_payload`);
- ``timeseries.json`` in flight-recorder bundles (the minutes before
  the trip, plus the watchtower's alert state at the moment of death);
- the watchtower's change-point detectors, which read windowed rates
  and latest values instead of re-deriving them per detector.

Counters are delta-aware: :meth:`TimeseriesStore.rate` sums only
*positive* deltas between consecutive samples, so a registry reset (the
cumulative total dropping) reads as a gap, never a negative rate.

Kill switch: ``DL4J_TPU_WATCHTOWER=0`` (read live, byte-key fast path —
the trace-store idiom) makes the scrape a no-op and the HTTP surfaces
404; nothing is ringed, no ``dl4j_timeseries_*`` series are created.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.observability.registry import (Counter, Gauge,
                                                       Histogram,
                                                       global_registry,
                                                       on_registry_reset)

__all__ = [
    "watchtower_enabled", "timeseries_len", "timeseries_interval_s",
    "TimeseriesStore", "global_timeseries", "reset_global_timeseries",
    "timeseries_payload",
]

# the live-env fast path (trace_store idiom): CPython's environ._data is
# the underlying dict of bytes, so the per-call check costs one dict get
try:
    _ENV_DATA = os.environ._data          # type: ignore[attr-defined]
    _K_WATCH = os.fsencode("DL4J_TPU_WATCHTOWER")
except AttributeError:                     # non-CPython: plain getenv
    _ENV_DATA = None


def watchtower_enabled() -> bool:
    """``DL4J_TPU_WATCHTOWER`` kill switch, resolved LIVE per call —
    flipping it off restores pre-watchtower behavior (no scrape, no
    detectors, no alert routes) without a restart."""
    if _ENV_DATA is not None:
        return _ENV_DATA.get(_K_WATCH, b"1") != b"0"
    return os.environ.get("DL4J_TPU_WATCHTOWER", "1") != "0"


def timeseries_len() -> int:
    """Samples kept per series (``DL4J_TPU_TIMESERIES_LEN``, default
    240 — 20 minutes at the default 5 s scrape interval)."""
    try:
        return max(8, int(os.environ.get("DL4J_TPU_TIMESERIES_LEN", 240)))
    except (TypeError, ValueError):
        return 240


def timeseries_interval_s() -> float:
    """Minimum seconds between scrapes (``DL4J_TPU_TIMESERIES_INTERVAL_S``,
    default 5.0; drills shrink it so tests run in seconds)."""
    try:
        return max(0.05, float(os.environ.get(
            "DL4J_TPU_TIMESERIES_INTERVAL_S", 5.0)))
    except (TypeError, ValueError):
        return 5.0


#: ring-name cap — the registry is bounded by convention, but a runaway
#: metric factory must not turn the postmortem ring into the leak
_MAX_SERIES = 512

#: the point-in-time histogram quantile sampled per scrape
_HIST_QUANTILE = 0.99

# lazily-bound self-instruments, dropped on registry reset so a fresh
# registry re-binds (and so NOTHING is created while the switch is off)
_ts_obs_cache = None
_ts_obs_lock = threading.Lock()


def _ts_obs():
    global _ts_obs_cache
    obs = _ts_obs_cache
    if obs is None:
        with _ts_obs_lock:
            obs = _ts_obs_cache
            if obs is None:
                reg = global_registry()
                obs = (
                    reg.counter("dl4j_timeseries_scrapes_total",
                                "registry scrapes into the timeseries "
                                "rings"),
                    reg.gauge("dl4j_timeseries_series",
                              "live timeseries ring count"),
                )
                _ts_obs_cache = obs
    return obs


@on_registry_reset
def _drop_ts_obs():
    global _ts_obs_cache
    _ts_obs_cache = None


class TimeseriesStore:
    """Bounded per-metric rings of ``(ts, value)`` samples."""

    def __init__(self, maxlen: Optional[int] = None):
        self._maxlen_override = maxlen
        self._rings: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._last_scrape = 0.0
        self.scrapes = 0

    # ------------------------------------------------------------ scraping
    def _ring(self, name: str) -> Optional[deque]:
        ring = self._rings.get(name)
        if ring is None:
            if len(self._rings) >= _MAX_SERIES:
                return None              # bounded: first-come keeps its ring
            ring = deque(maxlen=(self._maxlen_override
                                 if self._maxlen_override is not None
                                 else timeseries_len()))
            self._rings[name] = ring
        return ring

    def _append(self, name: str, now: float, value: float):
        ring = self._ring(name)
        if ring is not None:
            ring.append((now, float(value)))

    def scrape(self, registry=None, now: Optional[float] = None) -> int:
        """One pass over every registry instrument; returns the number
        of series sampled.  No-op (0) with the watchtower off."""
        if not watchtower_enabled():
            return 0
        reg = registry if registry is not None else global_registry()
        if now is None:
            now = time.time()
        sampled = 0
        with self._lock:
            for name in reg.names():
                inst = reg.get(name)
                if inst is None:
                    continue
                try:
                    if isinstance(inst, Histogram):
                        count = total = 0.0
                        worst_q = None
                        for _lvals, child in inst.series():
                            count += child.count
                            total += child.sum
                            q = child.quantile(_HIST_QUANTILE)
                            if q == q and (worst_q is None or q > worst_q):
                                worst_q = q
                        self._append(name + ":count", now, count)
                        self._append(name + ":sum", now, total)
                        if worst_q is not None:
                            self._append(name + ":p99", now, worst_q)
                        sampled += 3
                    elif isinstance(inst, (Counter, Gauge)):
                        self._append(name, now, sum(
                            child.value for _l, child in inst.series()))
                        sampled += 1
                # graftlint: disable=typed-errors — one torn instrument
                # must not veto the rest of the scrape
                except Exception:
                    continue
            self._last_scrape = now
            self.scrapes += 1
        obs = _ts_obs()
        obs[0].inc()
        obs[1].set(len(self._rings))
        return sampled

    def maybe_scrape(self, now: Optional[float] = None) -> bool:
        """Throttled :meth:`scrape` — at most one per
        ``DL4J_TPU_TIMESERIES_INTERVAL_S``."""
        if not watchtower_enabled():
            return False
        if now is None:
            now = time.time()
        with self._lock:
            if now - self._last_scrape < timeseries_interval_s():
                return False
        self.scrape(now=now)
        return True

    # ------------------------------------------------------------- queries
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def window(self, name: str, seconds: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Samples of ``name`` from the last ``seconds``, oldest first."""
        if now is None:
            now = time.time()
        cutoff = now - max(0.0, seconds)
        with self._lock:
            ring = self._rings.get(name)
            if ring is None:
                return []
            return [(ts, v) for ts, v in ring if ts >= cutoff]

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            ring = self._rings.get(name)
            if not ring:
                return None
            return ring[-1][1]

    def delta(self, name: str, seconds: float,
              now: Optional[float] = None) -> Optional[float]:
        """Reset-aware cumulative increase of ``name`` over the window:
        the sum of POSITIVE deltas between consecutive samples (a
        registry reset reads as a gap, never a negative delta).  None
        with fewer than two samples in the window."""
        samples = self.window(name, seconds, now)
        if len(samples) < 2:
            return None
        total = 0.0
        prev = samples[0][1]
        for _ts, v in samples[1:]:
            if v > prev:
                total += v - prev
            prev = v
        return total

    def rate(self, name: str, seconds: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second reset-aware rate of a cumulative series over the
        window (None with <2 samples or a zero-length span)."""
        samples = self.window(name, seconds, now)
        if len(samples) < 2:
            return None
        span = samples[-1][0] - samples[0][0]
        if span <= 0:
            return None
        inc = self.delta(name, seconds, now)
        return None if inc is None else inc / span

    def snapshot(self, names: Optional[List[str]] = None,
                 last: Optional[int] = None) -> dict:
        """The ``/debug/timeseries`` / bundle payload: every ring (or
        the requested names), newest ``last`` samples each."""
        with self._lock:
            keys = sorted(self._rings)
        if names:
            wanted = set(names)
            keys = [k for k in keys
                    if k in wanted or any(k.startswith(n) for n in wanted)]
        out: Dict[str, list] = {}
        with self._lock:
            for k in keys:
                ring = self._rings.get(k)
                if ring is None:
                    continue
                samples = list(ring)
                if last is not None:
                    samples = samples[-max(1, int(last)):]
                out[k] = [[round(ts, 3), v] for ts, v in samples]
        return {"enabled": watchtower_enabled(),
                "interval_s": timeseries_interval_s(),
                "maxlen": (self._maxlen_override
                           if self._maxlen_override is not None
                           else timeseries_len()),
                "scrapes": self.scrapes,
                "series": out}

    def clear(self):
        with self._lock:
            self._rings.clear()
            self._last_scrape = 0.0


_global_store: Optional[TimeseriesStore] = None
_store_lock = threading.Lock()


def global_timeseries() -> TimeseriesStore:
    """THE process-wide ring store the scrape beat and detectors use."""
    global _global_store
    if _global_store is None:
        with _store_lock:
            if _global_store is None:
                _global_store = TimeseriesStore()
    return _global_store


def reset_global_timeseries(**kw) -> TimeseriesStore:
    global _global_store
    with _store_lock:
        _global_store = TimeseriesStore(**kw)
    return _global_store


@on_registry_reset
def _clear_rings():
    # a fresh registry restarts every cumulative total; stale rings
    # would make windowed deltas span two registry lifetimes
    if _global_store is not None:
        _global_store.clear()


def timeseries_payload(query: Optional[Dict[str, list]] = None,
                       local_worker: str = "local") -> dict:
    """Shared ``GET /debug/timeseries`` payload for all three HTTP
    surfaces: ``?name=<prefix>`` filters series, ``?last=N`` bounds
    samples per series.  Callers gate on :func:`watchtower_enabled`."""
    q = query or {}
    names = [n for n in q.get("name", []) if n] or None
    last = None
    try:
        raw = (q.get("last", []) or [None])[0]
        if raw is not None:
            last = max(1, int(raw))
    except (TypeError, ValueError):
        last = None
    payload = global_timeseries().snapshot(names=names, last=last)
    payload["worker"] = local_worker
    return payload
