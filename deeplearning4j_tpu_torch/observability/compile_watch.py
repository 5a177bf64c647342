"""Compile watch: first-run accounting of the engine's step signatures.

Counterpart of ``deeplearning4j_tpu/observability/compile_watch.py``.
The JAX package counts XLA traces: its jitted bodies call
:func:`note_trace` as their first statement, so each call is one
(re)trace of that entry point. PyTorch runs eagerly and compiles nothing,
so the port counts the event that stands in for a trace: the FIRST run of
an engine step at a signature it has not run before — (function name,
mode, slots or batch, prefill bucket or window W, page dtype). The
engine keeps the signatures it has seen and calls :func:`note_trace`
once for each new one, so the "zero steady-state retraces" assertions
keep their meaning: a steady-state step at a seen signature notes
nothing. A CUDA-graph capture of a step registers here, one event per
captured signature.

Each event lands in a bounded ring (``compiles.json`` in postmortem
bundles) stamped with the training iteration count, which is what makes
:class:`RetraceStormRule` possible: *recompiles* (per-fn events beyond
the fn's first) inside the last ``window_steps`` training steps AND
``window_seconds`` grade degraded/failing on ``/health`` + ``/alerts``.
A caller may declare why the next event will happen with
:func:`note_cause`; the event then carries it.

The reference's ``jax.monitoring`` compile-duration listener has no
counterpart: there is no backend compile to time, so ``compile_seconds``
stays None.

Metric: ``dl4j_compile_total{fn}``. Kill switches:
``DL4J_TPU_COMPILE_WATCH=0`` under the ``DL4J_TPU_METRICS=0`` master.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.observability.registry import (global_registry,
                                                             metrics_enabled,
                                                             on_registry_reset)
from deeplearning4j_tpu_torch.observability.slo import (DEGRADED, FAILING, OK,
                                                        SLORule)
from deeplearning4j_tpu_torch.tree import tree_leaves

#: retained compile events (a storm of thousands keeps only the tail —
#: the counts survive in dl4j_compile_total either way)
_RING_CAPACITY = 256

#: how long a noted cause (bucket miss, sharded placement) stays eligible
#: to be claimed by the next trace — compiles follow their cause within
#: the same dispatch, so seconds suffice
_CAUSE_TTL_S = 5.0


def compile_watch_enabled() -> bool:
    """Kill switch (read per call so tests can flip it; probes only fire
    at trace time, so the per-step cost of the check is zero)."""
    return (metrics_enabled()
            and os.environ.get("DL4J_TPU_COMPILE_WATCH", "1") != "0")


def _signature(trees) -> str:
    """shape/dtype signature of the args of a step that ran at a new
    signature, e.g. ``bf16[1,1024], i64[4], None``: the leaves of nested
    tuples, lists and dicts (dict keys sorted, as ``jax.tree.leaves``
    walks them), tensors and numpy arrays by dtype and shape, other
    leaves by type name."""
    parts: List[str] = []
    for tree in trees:
        leaves = [] if tree is None else tree_leaves(tree)
        if not leaves:
            parts.append("None" if tree is None else "{}")
            continue
        for leaf in leaves:
            dt = getattr(leaf, "dtype", None)
            shape = getattr(leaf, "shape", None)
            if dt is None or shape is None:
                parts.append(type(leaf).__name__)
            else:
                name = getattr(dt, "name", None) or str(dt).replace(
                    "torch.", "")
                short = (name.replace("float", "f").replace("uint", "u")
                         .replace("int", "i").replace("complex", "c")
                         .replace("bool", "pred"))
                parts.append(f"{short}[{','.join(str(d) for d in shape)}]")
    return ", ".join(parts)


def _current_training_step() -> int:
    """The shared fit-iteration clock the retrace-storm window counts
    against (see train_metrics.total_iterations)."""
    from deeplearning4j_tpu_torch.observability.train_metrics import (
        total_iterations)
    return total_iterations()


def _compile_counter(fn: str):
    """The one registration site for the per-fn compile counter."""
    return global_registry().counter(
        "dl4j_compile_total",
        "first runs of an engine step at a new signature (the port's "
        "stand-in for an XLA trace), by function",
        label_names=("fn",)).labels(fn=fn)


class CompileWatch:
    """Bounded ring of first-run events + the correlation state.

    One process-wide instance via :func:`global_compile_watch`; tests
    construct their own and pass it to probes explicitly if needed.
    """

    def __init__(self, capacity: int = _RING_CAPACITY):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._seen_fns: set = set()      # fns that have compiled ≥once
        self._counts: Dict[str, int] = {}
        self._seq = 0
        self._pending_cause: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ probes
    def note_trace(self, fn: str, *arg_trees, **attrs) -> None:
        """Record one first run of ``fn`` at a new signature. The caller
        keeps the signatures it has seen and calls this once for each."""
        if not compile_watch_enabled():
            return
        sig = _signature(arg_trees)
        now = time.time()
        mono = time.monotonic()
        with self._lock:
            self._seq += 1
            cause = None
            pc = self._pending_cause
            if pc is not None and mono - pc["noted_mono"] <= _CAUSE_TTL_S:
                cause = {k: v for k, v in pc.items() if k != "noted_mono"}
                self._pending_cause = None
            first = fn not in self._seen_fns
            self._seen_fns.add(fn)
            self._counts[fn] = self._counts.get(fn, 0) + 1
            event = {
                "seq": self._seq,
                "fn": fn,
                "signature": sig,
                "unix_ts": now,
                "step": _current_training_step(),
                "first_compile_of_fn": first,
                "compile_seconds": None,   # eager: nothing compiles
                "cause": cause,
            }
            if attrs:
                event["attrs"] = {k: (v if isinstance(
                    v, (int, float, bool, str)) or v is None else str(v))
                    for k, v in attrs.items()}
            self._ring.append(event)
        _compile_counter(fn).inc()

    def note_cause(self, cause: str, **attrs) -> None:
        """Declare WHY the next trace (within a few seconds) will happen —
        e.g. the serving batcher's shape-bucket miss, or a ShardedTrainer
        re-homing params onto a mesh. Best-effort: claimed by the next
        :meth:`note_trace`, expires unclaimed."""
        if not compile_watch_enabled():
            return
        with self._lock:
            self._pending_cause = {"cause": cause,
                                   "noted_mono": time.monotonic(), **attrs}

    # ---------------------------------------------------------- queries
    def events(self, limit: Optional[int] = None) -> List[dict]:
        """Retained events, oldest first (``compiles.json`` payload)."""
        with self._lock:
            out = [dict(e) for e in self._ring]
        return out[-limit:] if limit else out

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    @property
    def total(self) -> int:
        with self._lock:
            return self._seq

    def count_for(self, fn: str) -> int:
        with self._lock:
            return self._counts.get(fn, 0)

    def recompiles_in_window(self, window_steps: int,
                             window_seconds: float) -> List[dict]:
        """RE-compiles (events past each fn's first-ever compile) recent
        on BOTH clocks: within ``window_steps`` of the current training
        iteration count AND ``window_seconds`` of now. A serving-only
        process never advances the step clock (diff 0), so the time
        window alone decays its storms; a training process ages events
        out by steps long before wall time."""
        cur = _current_training_step()
        now = time.time()
        with self._lock:
            return [dict(e) for e in self._ring
                    if not e["first_compile_of_fn"]
                    and cur - e["step"] <= window_steps
                    and now - e["unix_ts"] <= window_seconds]

    def snapshot(self) -> dict:
        """The bundle/endpoint payload."""
        return {
            "enabled": compile_watch_enabled(),
            "total_traces": self.total,
            "by_fn": self.counts(),
            "events": self.events(),
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seen_fns.clear()
            self._counts.clear()
            self._seq = 0
            self._pending_cause = None


class RetraceStormRule(SLORule):
    """Retrace storm: recompiles of already-compiled entry points keep
    landing inside the recent step window — shape/signature churn is
    burning accelerator time on the compiler instead of the model.
    First-ever compiles per fn are free (cold start is not a storm)."""

    def __init__(self, name: str = "retrace_storm",
                 window_steps: int = 50, window_seconds: float = 600.0,
                 degraded: Optional[int] = 3, failing: Optional[int] = 8,
                 description: str = ""):
        super().__init__(name, description or
                         f"recompiles in the last {window_steps} steps / "
                         f"{window_seconds:.0f}s")
        self.window_steps = window_steps
        self.window_seconds = window_seconds
        self.degraded = degraded
        self.failing = failing

    def _evaluate(self, registry) -> dict:
        watch = global_compile_watch()
        recent = watch.recompiles_in_window(self.window_steps,
                                            self.window_seconds)
        n = len(recent)
        status = OK
        if self.failing is not None and n >= self.failing:
            status = FAILING
        elif self.degraded is not None and n >= self.degraded:
            status = DEGRADED
        out = {"status": status, "value": n,
               "window_steps": self.window_steps,
               "degraded_at": self.degraded, "failing_at": self.failing}
        if recent:
            worst = max(recent, key=lambda e: e["seq"])
            out["detail"] = (f"last: {worst['fn']}({worst['signature']})"
                             + (f" cause={worst['cause']['cause']}"
                                if worst.get("cause") else ""))
        return out


# --------------------------------------------------------- process wiring
_global_watch: Optional[CompileWatch] = None
_watch_lock = threading.Lock()


def global_compile_watch() -> CompileWatch:
    """THE process-wide watch every built-in probe records into."""
    global _global_watch
    if _global_watch is None:
        with _watch_lock:
            if _global_watch is None:
                _global_watch = CompileWatch()
    return _global_watch


def reset_global_compile_watch() -> CompileWatch:
    global _global_watch
    with _watch_lock:
        _global_watch = CompileWatch()
    return _global_watch


def note_trace(fn: str, *arg_trees, **attrs) -> None:
    """Module-level probe the engine's steps call (see CompileWatch)."""
    if not compile_watch_enabled():
        return
    global_compile_watch().note_trace(fn, *arg_trees, **attrs)


def note_cause(cause: str, **attrs) -> None:
    """Module-level cause hint (see CompileWatch.note_cause)."""
    global_compile_watch().note_cause(cause, **attrs)


@on_registry_reset
def _clear_watch():
    # a fresh registry restarts the step clock — events stamped against
    # the old clock would all read "recent" forever (test isolation)
    if _global_watch is not None:
        _global_watch.clear()
