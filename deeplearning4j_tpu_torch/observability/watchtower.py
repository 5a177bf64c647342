"""Watchtower: continuous burn-rate + anomaly detection over the live
registry, feeding an alert lifecycle that closes the detect→capture loop.

Before this module, incidents only opened when the flight-recorder
watchdog tripped on a *hang*, and ``SLOEngine.alerts()`` was a stateless
point-in-time scrape — a latency regression, error burst, or MFU slide
under live traffic went unnoticed until a human read ``/debug/fleet``.
The watchtower is the machine operator (the continuous watch-and-alarm
posture of Abadi et al. arXiv:1605.08695 §9 at serving scale): detectors
run on the sync beat (never the request hot path), alerts walk an
explicit lifecycle, and a firing page-severity alert pins the offending
traces, opens the trace store's incident retention window, and dumps a
flight-recorder bundle whose publisher hook fans the capture fleet-wide
under ONE incident id.

Three detector shapes:

- :class:`BurnRateDetector` — multi-window error-budget burn (the SRE
  fast+slow window pair, env-scaled via ``DL4J_TPU_WATCHTOWER_FAST_S`` /
  ``_SLOW_S`` so drills run in seconds).  Delta-aware over cumulative
  counters; fires only when BOTH windows burn above threshold, so a
  transient blip (fast window only) and a long-ago burst still inside
  the slow window (slow only) both stay quiet.
- :class:`ChangePointDetector` — rolling EWMA mean/variance z-score
  over any sampled value (throughput, p99, shed rate, queue depth,
  train/decode MFU).  The baseline freezes (tiny adoption rate) while
  anomalous so the anomaly cannot absorb itself into the mean, and the
  detector needs ``sustain`` consecutive anomalous samples to fire.
- :class:`ThresholdDetector` — a plain bound on a live value.

Alert lifecycle (:class:`AlertManager`): pending → firing → resolved.
A detector must hold for ``DL4J_TPU_WATCHTOWER_HOLD_S`` before its
pending alert promotes to firing (hold-down), and must stay quiet for
``DL4J_TPU_WATCHTOWER_CLEAR_S`` before a firing alert resolves (flap
damping).  Alerts dedup on their literal rule name (graftlint's
``detector-rule-names`` checker keeps the name set closed); transitions
bump ``dl4j_alerts_total{rule,state}``.

Kill switch: ``DL4J_TPU_WATCHTOWER=0`` (read live, shared with
``timeseries.py``) makes every beat a no-op and restores pre-watchtower
behavior byte-identically.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.observability.registry import (global_registry,
                                                       on_registry_reset)
from deeplearning4j_tpu_torch.observability.timeseries import (global_timeseries,
                                                         watchtower_enabled)
from deeplearning4j_tpu_torch.observability.trace_store import (
    global_trace_store, trace_store_enabled)

__all__ = [
    "PAGE", "WARN", "PENDING", "FIRING", "RESOLVED",
    "watchtower_enabled", "watchtower_interval_s", "fast_window_s",
    "slow_window_s", "hold_s", "clear_s", "incident_cooldown_s",
    "Detector", "BurnRateDetector", "ChangePointDetector",
    "ThresholdDetector", "AlertManager", "Watchtower",
    "default_detectors", "global_watchtower", "reset_global_watchtower",
]

#: alert severities — a firing PAGE alert opens an incident (pin traces,
#: open the retention window, dump bundles fleet-wide); WARN only alerts
PAGE, WARN = "page", "warn"

#: alert lifecycle states
PENDING, FIRING, RESOLVED = "pending", "firing", "resolved"


def _env_float(name: str, default: float, floor: float) -> float:
    try:
        return max(floor, float(os.environ.get(name, default)))
    except (TypeError, ValueError):
        return default


def watchtower_interval_s() -> float:
    """Seconds between detector evaluations (rides the sync beat)."""
    return _env_float("DL4J_TPU_WATCHTOWER_INTERVAL_S", 1.0, 0.05)


def fast_window_s() -> float:
    """Burn-rate FAST window (``DL4J_TPU_WATCHTOWER_FAST_S``)."""
    return _env_float("DL4J_TPU_WATCHTOWER_FAST_S", 60.0, 0.5)


def slow_window_s() -> float:
    """Burn-rate SLOW window (``DL4J_TPU_WATCHTOWER_SLOW_S``)."""
    return _env_float("DL4J_TPU_WATCHTOWER_SLOW_S", 300.0, 1.0)


def hold_s() -> float:
    """Hold-down: continuous firing required before pending → firing."""
    return _env_float("DL4J_TPU_WATCHTOWER_HOLD_S", 5.0, 0.0)


def clear_s() -> float:
    """Flap damping: continuous quiet required before firing → resolved."""
    return _env_float("DL4J_TPU_WATCHTOWER_CLEAR_S", 30.0, 0.0)


def incident_cooldown_s() -> float:
    """Minimum seconds between alert-opened incidents on one process —
    page alerts firing inside this window coalesce onto the first
    incident instead of dump-storming the fleet."""
    return _env_float("DL4J_TPU_WATCHTOWER_COOLDOWN_S", 120.0, 0.0)


# lazily-bound alert transition counter (registry-reset safe; created
# only on the first transition, so the OFF path makes no series)
_alert_obs_cache = None
_alert_obs_lock = threading.Lock()
_alert_children: Dict[Tuple[str, str], object] = {}


def _alert_total(rule: str, state: str):
    global _alert_obs_cache
    child = _alert_children.get((rule, state))
    if child is None:
        inst = _alert_obs_cache
        if inst is None:
            with _alert_obs_lock:
                inst = _alert_obs_cache
                if inst is None:
                    inst = global_registry().counter(
                        "dl4j_alerts_total",
                        "watchtower alert lifecycle transitions, by rule "
                        "and entered state",
                        label_names=("rule", "state"))
                    _alert_obs_cache = inst
        child = inst.labels(rule=rule, state=state)
        _alert_children[(rule, state)] = child
    return child


@on_registry_reset
def _drop_alert_obs():
    global _alert_obs_cache
    _alert_obs_cache = None
    _alert_children.clear()


# ------------------------------------------------------------- detectors

class Detector:
    """One named watch rule; subclasses implement :meth:`_evaluate`
    returning ``{"firing": bool, "value": float|None, "detail": str}``.
    The rule name is a LITERAL at every construction site (lint:
    ``detector-rule-names``) — dedup keys and drill grading depend on a
    closed name set."""

    def __init__(self, rule: str, description: str = "",
                 severity: str = WARN):
        if severity not in (PAGE, WARN):
            raise ValueError(f"severity must be {PAGE!r} or {WARN!r}")
        self.rule = rule
        self.description = description
        self.severity = severity

    def observe(self, now: float) -> dict:
        try:
            result = self._evaluate(now)
        # graftlint: disable=typed-errors — a typo'd detector must keep
        # alerting the others, not crash the beat
        except Exception as e:
            result = {"firing": False, "detail": f"detector error: {e!r}"}
        result.setdefault("firing", False)
        result["rule"] = self.rule
        result["severity"] = self.severity
        if self.description:
            result.setdefault("description", self.description)
        return result

    def _evaluate(self, now: float) -> dict:
        raise NotImplementedError


class BurnRateDetector(Detector):
    """Multi-window error-budget burn over cumulative counters.

    Each evaluation samples ``(errors_cum, requests_cum)`` — by default
    the 5xx children vs all children of ``requests_metric``, or a
    custom ``totals_fn`` (the fleet detectors sum a federated scrape) —
    into an internal ring, then grades the windowed error ratio against
    ``budget`` for the fast AND slow windows.  ``burn = ratio/budget``;
    both windows must burn ≥ ``threshold`` with ≥ ``min_requests`` in
    the fast window to fire."""

    def __init__(self, rule: str, requests_metric: str =
                 "dl4j_http_requests_total",
                 errors_metric: Optional[str] = None,
                 totals_fn: Optional[Callable[[], Tuple[float, float]]]
                 = None,
                 budget: float = 0.02, threshold: float = 10.0,
                 fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None,
                 min_requests: float = 10.0,
                 description: str = "", severity: str = PAGE):
        super().__init__(rule, description or
                         f"error-budget burn of {requests_metric} "
                         f"(budget {budget:.2%})", severity)
        self.requests_metric = requests_metric
        self.errors_metric = errors_metric
        self.totals_fn = totals_fn
        self.budget = float(budget)
        self.threshold = float(threshold)
        self._fast_s = fast_s
        self._slow_s = slow_s
        self.min_requests = float(min_requests)
        self._ring: deque = deque(maxlen=4096)

    @staticmethod
    def _counter_total(registry, name: str,
                       only_5xx: bool = False) -> float:
        inst = registry.get(name)
        if inst is None:
            return 0.0
        total = 0.0
        if only_5xx:
            idx = (inst.label_names.index("code")
                   if "code" in inst.label_names else None)
            for lvals, child in inst.series():
                if idx is not None and str(lvals[idx]).startswith("5"):
                    total += child.value
            return total
        return sum(child.value for _l, child in inst.series())

    def _totals(self) -> Tuple[float, float]:
        if self.totals_fn is not None:
            return self.totals_fn()
        reg = global_registry()
        requests = self._counter_total(reg, self.requests_metric)
        if self.errors_metric is not None:
            errors = self._counter_total(reg, self.errors_metric)
        else:
            errors = self._counter_total(reg, self.requests_metric,
                                         only_5xx=True)
        return errors, requests

    def _window_ratio(self, seconds: float,
                      now: float) -> Tuple[Optional[float], float]:
        """(error_ratio, request_delta) over the window, reset-aware:
        a cumulative total dropping (registry reset) truncates the
        window at the reset point."""
        cutoff = now - seconds
        samples = [s for s in self._ring if s[0] >= cutoff]
        if len(samples) < 2:
            return None, 0.0
        base_e, base_r = samples[0][1], samples[0][2]
        d_err = d_req = 0.0
        prev_e, prev_r = base_e, base_r
        for _ts, e, r in samples[1:]:
            if r >= prev_r and e >= prev_e:
                d_err += e - prev_e
                d_req += r - prev_r
            prev_e, prev_r = e, r
        if d_req <= 0:
            return None, 0.0
        return d_err / d_req, d_req

    def _evaluate(self, now: float) -> dict:
        errors, requests = self._totals()
        self._ring.append((now, float(errors), float(requests)))
        slow = self._slow_s if self._slow_s is not None else slow_window_s()
        fast = self._fast_s if self._fast_s is not None else fast_window_s()
        while self._ring and self._ring[0][0] < now - 2 * slow:
            self._ring.popleft()
        fast_ratio, fast_req = self._window_ratio(fast, now)
        slow_ratio, _slow_req = self._window_ratio(slow, now)
        if fast_ratio is None or slow_ratio is None \
                or fast_req < self.min_requests:
            return {"firing": False, "detail": "insufficient data"}
        fast_burn = fast_ratio / self.budget
        slow_burn = slow_ratio / self.budget
        firing = (fast_burn >= self.threshold
                  and slow_burn >= self.threshold)
        return {"firing": firing, "value": fast_burn,
                "fast_burn": round(fast_burn, 3),
                "slow_burn": round(slow_burn, 3),
                "threshold": self.threshold,
                "detail": f"burn fast={fast_burn:.1f}x "
                          f"slow={slow_burn:.1f}x of {self.budget:.2%} "
                          f"budget"}


class ChangePointDetector(Detector):
    """Rolling EWMA z-score change-point over any sampled value.

    ``value_fn`` returns the current value (None = no data this beat).
    After ``min_samples`` warmup, a sample more than ``z`` deviations
    from the EWMA mean in ``direction`` is anomalous; ``sustain``
    consecutive anomalous samples fire.  While anomalous the baseline
    adopts at ``alpha/20`` so a step change cannot absorb itself into
    the mean before the alert fires — but a genuinely new regime is
    eventually adopted and the alert resolves."""

    def __init__(self, rule: str, value_fn: Callable[[float],
                                                     Optional[float]],
                 direction: str = "up", z: float = 4.0,
                 alpha: float = 0.25, min_samples: int = 12,
                 sustain: int = 3, min_sigma: float = 1e-9,
                 rel_floor: float = 0.05,
                 description: str = "", severity: str = WARN):
        if direction not in ("up", "down"):
            raise ValueError("direction must be 'up' or 'down'")
        super().__init__(rule, description, severity)
        self.value_fn = value_fn
        self.direction = direction
        self.z = float(z)
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.sustain = int(sustain)
        self.min_sigma = float(min_sigma)
        self.rel_floor = float(rel_floor)
        self._mean: Optional[float] = None
        self._var = 0.0
        self._n = 0
        self._streak = 0

    def _evaluate(self, now: float) -> dict:
        value = self.value_fn(now)
        if value is None or value != value:
            return {"firing": False, "detail": "no data"}
        value = float(value)
        if self._mean is None:
            self._mean, self._var, self._n = value, 0.0, 1
            return {"firing": False, "value": value, "detail": "warmup"}
        sigma = max(self._var ** 0.5, self.rel_floor * abs(self._mean),
                    self.min_sigma)
        score = (value - self._mean) / sigma
        anomalous = (self._n >= self.min_samples
                     and (score >= self.z if self.direction == "up"
                          else score <= -self.z))
        # EWMA update — frozen to a trickle while anomalous so the
        # anomaly cannot vote itself into the baseline
        alpha = self.alpha / 20.0 if anomalous else self.alpha
        delta = value - self._mean
        self._mean += alpha * delta
        self._var = (1 - alpha) * (self._var + alpha * delta * delta)
        self._n += 1
        self._streak = self._streak + 1 if anomalous else 0
        firing = self._streak >= self.sustain
        return {"firing": firing, "value": value,
                "zscore": round(score, 2), "mean": self._mean,
                "streak": self._streak,
                "detail": f"value {value:.4g} vs EWMA {self._mean:.4g} "
                          f"(z={score:+.1f}, {self.direction})"}


class ThresholdDetector(Detector):
    """A plain live-value bound: fires while the value crosses it."""

    def __init__(self, rule: str, value_fn: Callable[[float],
                                                     Optional[float]],
                 firing_above: Optional[float] = None,
                 firing_below: Optional[float] = None,
                 description: str = "", severity: str = WARN):
        if (firing_above is None) == (firing_below is None):
            raise ValueError("exactly one of firing_above/firing_below")
        super().__init__(rule, description, severity)
        self.value_fn = value_fn
        self.firing_above = firing_above
        self.firing_below = firing_below

    def _evaluate(self, now: float) -> dict:
        value = self.value_fn(now)
        if value is None or value != value:
            return {"firing": False, "detail": "no data"}
        value = float(value)
        if self.firing_above is not None:
            firing = value > self.firing_above
            bound = f"> {self.firing_above:g}"
        else:
            firing = value < self.firing_below
            bound = f"< {self.firing_below:g}"
        return {"firing": firing, "value": value,
                "detail": f"value {value:.4g} (fires {bound})"}


# --------------------------------------------------------- default rules

def _http_p99(now: float) -> Optional[float]:
    return global_timeseries().latest("dl4j_http_latency_seconds:p99")


def _http_throughput(now: float) -> Optional[float]:
    return global_timeseries().rate("dl4j_http_requests_total",
                                    slow_window_s(), now)


def _shed_rate(now: float) -> Optional[float]:
    ts = global_timeseries()
    window = fast_window_s()
    shed = sum(filter(None, (
        ts.delta("dl4j_http_shed_total", window, now),
        ts.delta("dl4j_inference_shed_total", window, now),
        ts.delta("dl4j_decode_shed_total", window, now))))
    req = ts.delta("dl4j_http_requests_total", window, now)
    if req is None or req + shed <= 0:
        return None
    return shed / (req + shed)


def _queue_depth(now: float) -> Optional[float]:
    ts = global_timeseries()
    depths = [d for d in (ts.latest("dl4j_inference_queue_depth"),
                          ts.latest("dl4j_decode_queue_depth"))
              if d is not None]
    return max(depths) if depths else None


def _worst_mfu_ratio(now: float) -> Optional[float]:
    """Worst live-MFU / rolling-baseline ratio across timed entry points
    (train steps and decode loops both land here via the cost model)."""
    from deeplearning4j_tpu_torch.observability.cost_model import (
        global_cost_model)
    worst = None
    for _fn, mfu, baseline, samples in global_cost_model(
            ).regression_view():
        if samples < 8 or not baseline:
            continue
        ratio = mfu / baseline
        if worst is None or ratio < worst:
            worst = ratio
    return worst


def default_detectors() -> List[Detector]:
    """The per-process watch rules every serving worker runs: the HTTP
    error-budget burn (page), change-points on throughput / p99 / shed
    rate / queue depth / MFU, and a hard queue-depth threshold."""
    return [
        BurnRateDetector(
            "watch_http_error_burn",
            description="front-door 5xx burn over the fast+slow window "
                        "pair (2% error budget)",
            severity=PAGE),
        ChangePointDetector(
            "watch_p99_shift", _http_p99, direction="up",
            description="front-door p99 latency step change vs its own "
                        "rolling baseline",
            severity=PAGE),
        ChangePointDetector(
            "watch_throughput_drop", _http_throughput, direction="down",
            description="front-door request rate collapsed vs its own "
                        "rolling baseline",
            severity=WARN),
        ChangePointDetector(
            "watch_shed_rate_spike", _shed_rate, direction="up",
            description="admission sheds (door + serving queue + decode "
                        "queue) spiking vs baseline",
            severity=WARN),
        ChangePointDetector(
            "watch_queue_depth_spike", _queue_depth, direction="up",
            description="serving/decode queue depth step change",
            severity=WARN),
        ChangePointDetector(
            "watch_mfu_slide", _worst_mfu_ratio, direction="down",
            description="worst entry-point MFU sliding under its rolling "
                        "baseline (train/decode perf regression)",
            severity=WARN),
        ThresholdDetector(
            "watch_queue_depth_limit", _queue_depth, firing_above=256,
            description="serving/decode queue depth past the hard bound "
                        "(the SLO failing threshold)",
            severity=WARN),
    ]


# --------------------------------------------------------- alert lifecycle

class AlertManager:
    """The pending → firing → resolved state machine, dedup-keyed on
    the literal rule name, with hold-down and flap damping."""

    _RESOLVED_KEEP = 16
    _TRANSITIONS_KEEP = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._active: Dict[str, dict] = {}     # rule -> alert record
        self._resolved: deque = deque(maxlen=self._RESOLVED_KEEP)
        self._transitions: deque = deque(maxlen=self._TRANSITIONS_KEEP)

    def _transition(self, alert: dict, to: str, now: float) -> dict:
        rec = {"rule": alert["rule"], "from": alert.get("state"),
               "to": to, "at": now, "severity": alert["severity"]}
        alert["state"] = to
        alert["since"] = now
        self._transitions.append(rec)
        try:
            _alert_total(alert["rule"], to).inc()
        # graftlint: disable=typed-errors — metrics must never break the
        # lifecycle walk
        except Exception:
            pass
        return rec

    def observe(self, results: Sequence[dict],
                now: Optional[float] = None) -> List[dict]:
        """Feed one beat of detector results; returns the transitions
        that happened this beat."""
        if now is None:
            now = time.time()
        out: List[dict] = []
        with self._lock:
            for res in results:
                rule = res.get("rule")
                if not rule:
                    continue
                firing = bool(res.get("firing"))
                alert = self._active.get(rule)
                if alert is None:
                    if not firing:
                        continue
                    alert = {"rule": rule, "state": None,
                             "severity": res.get("severity", WARN),
                             "started": now, "last_firing": now}
                    self._active[rule] = alert
                    out.append(self._transition(alert, PENDING, now))
                alert["value"] = res.get("value")
                alert["detail"] = res.get("detail")
                if res.get("description"):
                    alert["description"] = res["description"]
                if firing:
                    alert["last_firing"] = now
                state = alert["state"]
                if state == PENDING:
                    if not firing:
                        # blip shorter than the hold-down: drop silently
                        del self._active[rule]
                    elif now - alert["started"] >= hold_s():
                        out.append(self._transition(alert, FIRING, now))
                elif state == FIRING:
                    if not firing and \
                            now - alert["last_firing"] >= clear_s():
                        out.append(self._transition(alert, RESOLVED, now))
                        alert["resolved_at"] = now
                        self._resolved.append(alert)
                        del self._active[rule]
        return out

    def firing(self) -> List[dict]:
        with self._lock:
            return [dict(a) for a in self._active.values()
                    if a["state"] == FIRING]

    def snapshot(self) -> dict:
        with self._lock:
            active = [dict(a) for a in self._active.values()]
            return {
                "firing": [a for a in active if a["state"] == FIRING],
                "pending": [a for a in active if a["state"] == PENDING],
                "resolved": [dict(a) for a in self._resolved],
                "transitions": list(self._transitions),
            }

    def clear(self):
        with self._lock:
            self._active.clear()
            self._resolved.clear()
            self._transitions.clear()


# -------------------------------------------------------------- watchtower

class Watchtower:
    """Detectors + alert lifecycle + the detect→capture closure.

    ``beat()`` rides the front door's sync loop (and the alert routes,
    throttled) — it scrapes the timeseries rings, evaluates every
    detector, walks the alert lifecycle, and on a page-severity alert
    entering ``firing`` pins the offending retained traces, opens the
    trace store's incident window, and dumps a flight-recorder bundle
    with ``reason="alert:<rule>"`` — the recorder's incident-publisher
    hook (fleet mode) turns that into ONE shared incident the leader
    fans out."""

    def __init__(self, detectors: Optional[Sequence[Detector]] = None,
                 scrape: bool = True):
        self.detectors: List[Detector] = list(
            detectors if detectors is not None else default_detectors())
        self.alerts = AlertManager()
        self._scrape = bool(scrape)
        self._beat_lock = threading.Lock()
        self._last_beat = 0.0
        self._incident_at = 0.0
        self.last_incident_reason: Optional[str] = None

    def beat(self, now: Optional[float] = None,
             force: bool = False) -> List[dict]:
        """One throttled evaluation pass; returns this beat's alert
        transitions (empty when throttled or killed)."""
        if not watchtower_enabled():
            return []
        if now is None:
            now = time.time()
        with self._beat_lock:
            if not force and now - self._last_beat \
                    < watchtower_interval_s():
                return []
            self._last_beat = now
        if self._scrape:
            global_timeseries().maybe_scrape(now)
        results = [d.observe(now) for d in self.detectors]
        transitions = self.alerts.observe(results, now)
        self._close_loop(transitions, now)
        return transitions

    # ------------------------------------------------ detect→capture loop
    def _offending_trace_ids(self, limit: int = 8) -> List[str]:
        """Recent retained traces kept for cause (error / slow / tail —
        anything but a plain sample): the evidence a page should pin."""
        ids: List[str] = []
        for rec in global_trace_store().recent(limit=64):
            reason = str(rec.get("reason") or "")
            if rec.get("error") or reason.startswith(("error", "slow",
                                                      "tail")):
                ids.append(rec["trace_id"])
                if len(ids) >= limit:
                    break
        return ids

    def _close_loop(self, transitions: List[dict], now: float):
        pages = [t for t in transitions
                 if t["to"] == FIRING and t.get("severity") == PAGE]
        if not pages:
            return
        if now - self._incident_at < incident_cooldown_s():
            return                      # coalesce onto the open incident
        self._incident_at = now
        reason = "alert:" + pages[0]["rule"]
        self.last_incident_reason = reason
        if trace_store_enabled():
            st = global_trace_store()
            for tid in self._offending_trace_ids():
                st.pin(tid)
            st.open_incident_window()
        try:
            from deeplearning4j_tpu_torch.observability.flight_recorder import (
                global_flight_recorder, recorder_enabled)
            if recorder_enabled():
                global_flight_recorder().dump(reason)
        # graftlint: disable=typed-errors — an unwritable postmortem dir
        # must not break the alert lifecycle
        except Exception:
            pass

    # ------------------------------------------------------------- queries
    def snapshot(self) -> dict:
        return {
            "enabled": watchtower_enabled(),
            "interval_s": watchtower_interval_s(),
            "detectors": [{"rule": d.rule, "severity": d.severity,
                           "description": d.description}
                          for d in self.detectors],
            "last_incident_reason": self.last_incident_reason,
            **self.alerts.snapshot(),
        }


_global_tower: Optional[Watchtower] = None
_tower_lock = threading.Lock()


def global_watchtower() -> Watchtower:
    """THE process-wide watchtower the sync beat and alert routes use."""
    global _global_tower
    if _global_tower is None:
        with _tower_lock:
            if _global_tower is None:
                _global_tower = Watchtower()
    return _global_tower


def reset_global_watchtower(**kw) -> Watchtower:
    global _global_tower
    with _tower_lock:
        _global_tower = Watchtower(**kw)
    return _global_tower


@on_registry_reset
def _clear_tower_state():
    # fresh registry = fresh cumulative totals; stale detector baselines
    # and alert since-timestamps would span two lifetimes
    if _global_tower is not None:
        _global_tower.alerts.clear()
