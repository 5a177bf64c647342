"""Numerics health, host part: the divergence rule.

Counterpart of the host half of ``deeplearning4j_tpu/observability/
numerics.py``. The reference computes non-finite and norm terms inside
its jitted train step (``health_terms``, ``select``) and publishes them at
the fit loop's sync points (``stamp_step``, ``publish``); those in-step
checks are not ported yet (ROADMAP queue 1 item 6), and with them the
reference's switches ``DL4J_TPU_NUMERICS`` and ``DL4J_TPU_NUMERICS_SKIP``,
which only those checks read. What the serving stack imports is here: the
divergence tracker and :class:`DivergenceRule`, which
``slo.default_rules`` puts on ``/health``. With nothing in the port
recording non-finite steps yet, the rule grades OK.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

from deeplearning4j_tpu_torch.observability.registry import (
    on_registry_reset)
from deeplearning4j_tpu_torch.observability.slo import FAILING, OK, SLORule


# --------------------------------------------------------- host-side state
class _DivergenceTracker:
    """Recent non-finite events on both clocks (step index + wall time),
    the state :class:`DivergenceRule` grades from."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[dict] = []    # {step, unix_ts, kind, model}
        self._last: Dict[str, dict] = {}  # model kind -> last published

    def record_nonfinite(self, model_kind: str, kind: str, step: int):
        with self._lock:
            self._events.append({"model": model_kind, "kind": kind,
                                 "step": step, "unix_ts": time.time()})
            del self._events[:-64]

    def note_publish(self, model_kind: str, values: dict):
        with self._lock:
            self._last[model_kind] = values

    def recent(self, window_steps: int, window_seconds: float,
               current_step: int) -> List[dict]:
        now = time.time()
        with self._lock:
            return [dict(e) for e in self._events
                    if current_step - e["step"] <= window_steps
                    and now - e["unix_ts"] <= window_seconds]

    def snapshot(self) -> dict:
        with self._lock:
            return {"nonfinite_events": [dict(e) for e in self._events],
                    "last_published": {k: dict(v)
                                       for k, v in self._last.items()}}

    def clear(self):
        with self._lock:
            self._events.clear()
            self._last.clear()


_tracker = _DivergenceTracker()


def tracker() -> _DivergenceTracker:
    return _tracker


def _current_step() -> int:
    """The shared fit-iteration clock (train_metrics.total_iterations) —
    the same clock the divergence window ages against."""
    from deeplearning4j_tpu_torch.observability.train_metrics import (
        total_iterations)
    return total_iterations()


class DivergenceRule(SLORule):
    """Non-finite loss/gradients recently ⇒ ``failing`` — a diverged
    trainer must page immediately (every further step is wasted hours).
    Recovers once the event ages out of BOTH windows (or after a registry
    reset / fresh process)."""

    def __init__(self, name: str = "numerics_divergence",
                 window_steps: int = 200, window_seconds: float = 600.0,
                 description: str = ""):
        super().__init__(name, description or
                         "non-finite loss/gradients in the recent window")
        self.window_steps = window_steps
        self.window_seconds = window_seconds

    def _evaluate(self, registry) -> dict:
        recent = _tracker.recent(self.window_steps, self.window_seconds,
                                 _current_step())
        if not recent:
            return {"status": OK, "value": 0}
        worst = recent[-1]
        return {"status": FAILING, "value": len(recent),
                "detail": f"last: non-finite {worst['kind']} "
                          f"({worst['model']}) at step {worst['step']}"}


def snapshot() -> dict:
    """Bundle payload: recent non-finite events + last published health
    per model kind (the numerics half of a postmortem)."""
    return _tracker.snapshot()


@on_registry_reset
def _clear_tracker():
    # a fresh registry restarts the step clock (test isolation)
    _tracker.clear()
