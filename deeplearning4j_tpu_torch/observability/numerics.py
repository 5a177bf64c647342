"""Numerics health: non-finite detection, gradient norms and
update-to-weight ratios computed in the train step.

Counterpart of ``deeplearning4j_tpu/observability/numerics.py``. The
health terms (``health_terms``) are a handful of device reductions taken
after the optimizer transform; the fit loops keep the per-step device
scalars (``stamp_step``) and materialize them only at the sync points
where the deferred loss fetch already blocks (``publish``), so they add
no host sync of their own.

Published series (per model kind): ``dl4j_numerics_nonfinite_total{model,
kind}``, ``dl4j_numerics_grad_norm`` and ``dl4j_numerics_update_ratio``
histograms, ``dl4j_numerics_skipped_steps_total{model}``. Divergence feeds
:class:`DivergenceRule`, which ``slo.default_rules`` puts on ``/health``.

Skip policy (opt-in, ``DL4J_TPU_NUMERICS_SKIP=1``): on a non-finite loss
or gradient the step keeps its params, optimizer state and layer states
(``select``). The reference selects inside its compiled step; here the
verdict is read on the host, one sync a step, only under this policy.

Kill switches: ``DL4J_TPU_NUMERICS=0`` (no health terms at all) under the
``DL4J_TPU_METRICS=0`` master.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observability.registry import (
    global_registry, metrics_enabled, on_registry_reset)
from deeplearning4j_tpu_torch.observability.slo import FAILING, OK, SLORule


def numerics_enabled() -> bool:
    """Kill switch, read at each step."""
    return (metrics_enabled()
            and os.environ.get("DL4J_TPU_NUMERICS", "1") != "0")


def skip_on_nonfinite() -> bool:
    """Opt-in policy: skip the optimizer update on non-finite grads."""
    return os.environ.get("DL4J_TPU_NUMERICS_SKIP", "0") == "1"


def health_terms(loss, grads, params, updates) -> Dict[str, object]:
    """The health scalars, 0-d device tensors (no host sync), over lists
    of leaves. Taken after the optimizer transform, so ``updates`` shows
    clipping while ``grads`` is the raw signal. Gradient finiteness comes
    from the L2 norm: any NaN or Inf leaf reaches it. Each norm is one
    multi-tensor ``_foreach_norm`` over the leaves (f32) and the norm of
    those norms, a few launches a step, where a reduction per leaf would
    be hundreds."""
    import torch

    def _norm(leaves):
        if not leaves:
            return torch.zeros((), dtype=torch.float32, device=loss.device)
        parts = torch._foreach_norm([t.float() for t in leaves])
        return torch.linalg.vector_norm(torch.stack(parts))

    grad_norm = _norm(grads)
    update_norm = _norm(updates)
    param_norm = _norm(params)
    return {
        "loss_finite": torch.all(torch.isfinite(loss)),
        "grads_finite": torch.isfinite(grad_norm),
        "grad_norm": grad_norm,
        "update_ratio": update_norm / (param_norm + 1e-12),
        "skipped": torch.zeros((), dtype=torch.bool, device=loss.device),
    }


def select(ok, new_tree, old_tree):
    """``new_tree`` when ``ok``, else ``old_tree`` (whole trees: every
    tensor and step count). ``ok`` is read on the host."""
    return new_tree if bool(ok) else old_tree


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


def stamp_step(health: Dict[str, object]) -> Dict[str, object]:
    """Stamp the CURRENT step index onto a just-produced health dict, so
    an event carries the step it happened at, not the later publish's."""
    health["step"] = _current_step()
    return health


def publish(model, pending: List[Dict[str, object]]) -> Optional[dict]:
    """Materialize and publish a batch of per-step health dicts (device
    scalars accumulated since the last sync point). Returns the LAST
    step's values as floats, also stored on ``model.last_numerics``."""
    if not pending:
        return None
    import torch

    model_kind = type(model).__name__
    keys = ("loss_finite", "grads_finite", "grad_norm", "update_ratio",
            "skipped")
    # one device->host copy for the whole batch
    stacked = torch.stack([torch.stack([h[k].float() for k in keys])
                           for h in pending]).cpu().tolist()
    reg = global_registry()
    nonfinite = reg.counter(
        "dl4j_numerics_nonfinite_total",
        "train steps with a non-finite loss or gradient, by kind",
        label_names=("model", "kind"))
    skipped_c = reg.counter(
        "dl4j_numerics_skipped_steps_total",
        "optimizer updates skipped by DL4J_TPU_NUMERICS_SKIP on "
        "non-finite gradients",
        label_names=("model",))
    grad_h = reg.histogram(
        "dl4j_numerics_grad_norm",
        "global L2 norm of the gradients, per train step",
        label_names=("model",),
        buckets=(1e-4, 1e-3, 1e-2, 0.1, 0.3, 1.0, 3.0, 10.0, 100.0, 1e4))
    ratio_h = reg.histogram(
        "dl4j_numerics_update_ratio",
        "update L2 norm / param L2 norm, per train step (healthy nets "
        "sit around 1e-3)",
        label_names=("model",),
        buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0))
    fallback_step = _current_step()
    last = None
    for h, vals in zip(pending, stacked):
        step = int(h.get("step", fallback_step))
        loss_ok, grads_ok = bool(vals[0]), bool(vals[1])
        gn, ur, skipped = float(vals[2]), float(vals[3]), bool(vals[4])
        if not loss_ok:
            nonfinite.labels(model=model_kind, kind="loss").inc()
            _tracker.record_nonfinite(model_kind, "loss", step)
        if not grads_ok:
            nonfinite.labels(model=model_kind, kind="grad").inc()
            _tracker.record_nonfinite(model_kind, "grad", step)
        if gn == gn:                                   # NaN-safe observe
            grad_h.labels(model=model_kind).observe(gn)
        if ur == ur:
            ratio_h.labels(model=model_kind).observe(ur)
        if skipped:
            skipped_c.labels(model=model_kind).inc()
            from deeplearning4j_tpu_torch.observability.tracing import (
                now_us, record_span)
            t = now_us()
            record_span("numerics_skip", t, t, model=model_kind,
                        loss_finite=loss_ok, grads_finite=grads_ok)
        last = {"loss_finite": loss_ok, "grads_finite": grads_ok,
                "grad_norm": gn, "update_ratio": ur, "skipped": skipped}
    if last is not None:
        _tracker.note_publish(model_kind, last)
        model.last_numerics = last
    return last


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
    return {"enabled": numerics_enabled(),
            "skip_on_nonfinite": skip_on_nonfinite(),
            **_tracker.snapshot()}


@on_registry_reset
def _clear_tracker():
    # a fresh registry restarts the step clock (test isolation)
    _tracker.clear()
