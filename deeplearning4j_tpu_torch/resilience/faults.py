"""Deterministic, seeded fault injection for chaos testing the hot paths.

The reference stack's fault-tolerance story is "Spark task retry plus
periodic checkpoints" (SURVEY §5.3) and is only ever exercised by *real*
failures. Production systems treat failure as a first-class input
(fault-tolerant execution is a design axis of TensorFlow, Abadi et al.
arXiv:1605.08695 §3.3/§4.2; straggler/fault characterization dominates at
scale, Awan et al. arXiv:1810.11112): every failure-handling path must be
drivable on demand, deterministically, in tests and in staging chaos runs.

Named injection points are threaded through the hot paths:

=========================== =================================================
``data.next_batch``         DataSetIterator ``__next__`` (all iterators)
``inference.dispatch``      ParallelInference dispatcher, before the forward
``inference.device_execute``ParallelInference completer / sync serve loop
``serving.canary``          ServingRouter, on the canary version's path only
``generation.step``         GenerationPipeline decode loop, once per step
                            boundary (prefill joins + the decode step)
``generation.adopt``        FrontDoor orphan-session adoption (the lease-
                            fenced store takeover before a resume)
``http.request``            FrontDoor, at the door of every ``/v1/*``
                            request (after admission, before routing)
``store.read``              SharedStore document read (routing falls back
                            to its cached view; sync retries next beat)
``store.write``             SharedStore atomic commit (sync merges its
                            window counters back and retries)
``train.step``              MLN/CG ``_fit_batch`` before the train step
``checkpoint.save``         CheckpointListener / preemption / recovery saves
``checkpoint.restore``      ResilientTrainer checkpoint restore
``allreduce``               ShardedTrainer sharded step entry
=========================== =================================================

Fault kinds:

- ``error``   — raise a *transient* :class:`InjectedFault` (retryable)
- ``crash``   — raise a *non-transient* :class:`InjectedFault` (forces the
  restore-from-checkpoint path instead of in-place retry)
- ``latency`` — sleep ``latency_seconds`` (default 0.05)
- ``nan``     — corrupt the batch/inputs to NaN (composes with
  ``DL4J_TPU_NUMERICS_SKIP=1``, which then skips that step's update).
  Only valid at the points that own an array (``data.next_batch``,
  ``train.step``) — specs naming other points are rejected at parse

Configuration: ``DL4J_TPU_FAULTS="point:kind:rate[:count]"`` (comma-
separated specs; ``rate`` is the per-call injection probability, ``count``
caps total injections), or programmatically for tests::

    from deeplearning4j_tpu_torch.resilience import faults
    plan = faults.FaultPlan([faults.FaultSpec("train.step", "crash",
                                              rate=1.0, count=1)], seed=7)
    with faults.active(plan):
        ...

Determinism: each spec owns a ``random.Random`` seeded from
``(plan.seed, point, kind, index)`` — the same call sequence injects the
same faults. Every injection is counted
(``dl4j_faults_injected_total{point,kind}``), recorded in the resilience
event ring (→ flight-recorder ``resilience.json``), and traced as a
``fault_injected`` span parented into the caller's live trace, so chaos
runs are auditable end to end.

Kill switch: ``DL4J_TPU_RESILIENCE=0`` disarms all injection AND the
policy layer (deadlines, shedding, circuit breaking, self-healing) —
behavior is byte-identical to the pre-resilience tree.
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("deeplearning4j_tpu")

POINTS = ("data.next_batch", "inference.dispatch", "inference.device_execute",
          "serving.canary", "generation.step", "generation.adopt",
          "http.request", "train.step",
          "checkpoint.save", "checkpoint.restore", "checkpoint.manifest",
          "store.read", "store.write", "allreduce")
KINDS = ("error", "crash", "latency", "nan", "host_loss")
# nan corrupts a batch, so it only fires at points that own an array —
# accepting it elsewhere would validate a chaos spec that never injects
NAN_POINTS = ("data.next_batch", "train.step")
# host_loss simulates losing devices mid-step, so it only fires at the
# points a sharded step actually crosses; it needs the elastic layer to
# mean anything (DL4J_TPU_ELASTIC=0 disarms it — pre-elastic behavior)
HOST_LOSS_POINTS = ("train.step", "allreduce")


def resilience_enabled() -> bool:
    """THE resilience kill switch (read per call so tests can flip it).
    ``0`` disarms fault injection and every policy the layer adds."""
    return os.environ.get("DL4J_TPU_RESILIENCE", "1") != "0"


class InjectedFault(RuntimeError):
    """A deliberately injected failure. ``transient`` marks it retryable
    (kind ``error``); kind ``crash`` is non-transient and must take the
    restore-from-checkpoint path."""

    def __init__(self, point: str, kind: str = "error",
                 transient: Optional[bool] = None):
        self.point = point
        self.kind = kind
        self.transient = (kind == "error") if transient is None else transient
        super().__init__(f"injected fault at {point!r} (kind={kind}, "
                         f"transient={self.transient})")


class FaultSpec:
    """One injection rule: at ``point``, inject ``kind`` with probability
    ``rate`` per call, at most ``count`` times (None = unbounded)."""

    __slots__ = ("point", "kind", "rate", "count", "latency_seconds")

    def __init__(self, point: str, kind: str, rate: float = 1.0,
                 count: Optional[int] = None,
                 latency_seconds: float = 0.05):
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}; "
                             f"one of {POINTS}")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
        if kind == "nan" and point not in NAN_POINTS:
            raise ValueError(
                f"kind 'nan' corrupts a batch and only fires at "
                f"{NAN_POINTS}; point {point!r} owns no array — use "
                "'error', 'crash', or 'latency' there")
        if kind == "host_loss" and point not in HOST_LOSS_POINTS:
            raise ValueError(
                f"kind 'host_loss' loses devices mid-step and only fires "
                f"at {HOST_LOSS_POINTS}; point {point!r} never crosses "
                "the mesh")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.point = point
        self.kind = kind
        self.rate = float(rate)
        self.count = None if count is None else int(count)
        self.latency_seconds = float(latency_seconds)

    def __repr__(self):
        return (f"FaultSpec({self.point}:{self.kind}:{self.rate}"
                + (f":{self.count}" if self.count is not None else "") + ")")


class FaultPlan:
    """A set of specs plus the seed their draw sequences derive from."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """``"point:kind:rate[:count][,point:kind:rate[:count]...]"`` —
        the ``DL4J_TPU_FAULTS`` wire format."""
        specs = []
        for part in (p.strip() for p in text.split(",") if p.strip()):
            fields = part.split(":")
            if len(fields) < 2:
                raise ValueError(f"fault spec {part!r}: need point:kind")
            point, kind = fields[0], fields[1]
            rate = float(fields[2]) if len(fields) > 2 else 1.0
            count = int(fields[3]) if len(fields) > 3 else None
            specs.append(FaultSpec(point, kind, rate=rate, count=count))
        return cls(specs, seed=seed)


class _SpecState:
    """Per-spec live state: the seeded draw stream + injections so far."""

    __slots__ = ("spec", "rng", "fired")

    def __init__(self, spec: FaultSpec, seed: int, index: int):
        self.spec = spec
        self.rng = random.Random(f"{seed}:{spec.point}:{spec.kind}:{index}")
        self.fired = 0


# ---------------------------------------------------------------- event ring
# ONE bounded ring for the whole resilience layer (injections, retries,
# sheds, breaker transitions, restores, quarantines) — the flight recorder
# folds it into each postmortem bundle as resilience.json, and
# UIServer GET /debug/resilience serves it live.
_events: deque = deque(maxlen=256)
_events_lock = threading.Lock()


def record_event(category: str, **attrs):
    evt = {"t": time.time(), "category": category}
    evt.update(attrs)
    with _events_lock:
        _events.append(evt)


def events() -> List[dict]:
    with _events_lock:
        return list(_events)


def clear_events():
    with _events_lock:
        _events.clear()


# ------------------------------------------------------------------ registry
class FaultRegistry:
    """Resolves the active plan (programmatic wins over the env spec),
    draws deterministically, and fires faults at the named points."""

    def __init__(self):
        self._lock = threading.RLock()
        self._plan: Optional[FaultPlan] = None
        self._states: Dict[str, List[_SpecState]] = {}
        # cumulative process-lifetime injections ("point:kind" -> n): the
        # postmortem view must survive plans being cleared/replaced
        self._injected_total: Dict[str, int] = {}
        # env-spec cache: (raw env string, states-by-point); rebuilt only
        # when the string changes so check() stays cheap per call
        self._env_raw: Optional[str] = None
        self._env_states: Dict[str, List[_SpecState]] = {}
        self._env_warned: Optional[str] = None

    # -------------------------------------------------------- plan control
    def install(self, plan: FaultPlan):
        with self._lock:
            self._plan = plan
            self._states = self._build_states(plan)

    def clear(self):
        with self._lock:
            self._plan = None
            self._states = {}

    @staticmethod
    def _build_states(plan: FaultPlan) -> Dict[str, List[_SpecState]]:
        out: Dict[str, List[_SpecState]] = {}
        for i, spec in enumerate(plan.specs):
            out.setdefault(spec.point, []).append(
                _SpecState(spec, plan.seed, i))
        return out

    def _active_states(self) -> Dict[str, List[_SpecState]]:
        if self._plan is not None:
            return self._states
        raw = os.environ.get("DL4J_TPU_FAULTS", "")
        if raw != self._env_raw:
            with self._lock:
                if raw != self._env_raw:
                    states: Dict[str, List[_SpecState]] = {}
                    if raw:
                        try:
                            states = self._build_states(FaultPlan.parse(raw))
                        except ValueError as e:
                            # a typo'd chaos spec must not crash training —
                            # warn once per distinct bad value and inject
                            # nothing
                            if raw != self._env_warned:
                                self._env_warned = raw
                                log.warning("ignoring malformed "
                                            "DL4J_TPU_FAULTS=%r: %s", raw, e)
                    self._env_states = states
                    self._env_raw = raw
        return self._env_states

    def armed(self) -> bool:
        """Fast path for the hot-path call sites: False unless resilience
        is on AND some fault plan (programmatic or env) exists."""
        if not resilience_enabled():
            return False
        if self._plan is not None:
            return True
        return bool(os.environ.get("DL4J_TPU_FAULTS"))

    # ------------------------------------------------------------- drawing
    def _draw(self, st: _SpecState) -> bool:
        spec = st.spec
        if spec.count is not None and st.fired >= spec.count:
            return False
        fire = spec.rate >= 1.0 or st.rng.random() < spec.rate
        if fire:
            st.fired += 1
        return fire

    def _note(self, point: str, kind: str):
        key = f"{point}:{kind}"
        with self._lock:
            self._injected_total[key] = self._injected_total.get(key, 0) + 1
        _injected_counter(point, kind).inc()
        record_event("fault_injected", point=point, kind=kind)
        try:
            from deeplearning4j_tpu_torch.observability.tracing import (
                current_context, now_us, record_span)
            record_span("fault_injected", now_us(), ctx=current_context(),
                        point=point, kind=kind)
        except Exception:  # graftlint: disable=typed-errors — tracing is
            pass           # best-effort; no request outcome flows here

    def check(self, point: str):
        """Fire error/crash/latency faults configured at ``point``.
        Raises :class:`InjectedFault` or sleeps; nan faults are handled by
        :meth:`corrupt` at the sites that own an array."""
        if not self.armed():
            return
        for st in self._active_states().get(point, ()):
            kind = st.spec.kind
            if kind == "nan":
                continue
            if kind == "host_loss":
                # a host-loss fault only means something when the elastic
                # layer can act on it; the port has no elastic layer yet
                # (ROADMAP queue 1 item 7), so the spec is inert, as the
                # reference's is under DL4J_TPU_ELASTIC=0
                continue
            with self._lock:
                fire = self._draw(st)
            if not fire:
                continue
            self._note(point, kind)
            if kind == "latency":
                time.sleep(st.spec.latency_seconds)
            else:
                raise InjectedFault(point, kind)

    def corrupt(self, point: str, value):
        """Apply any nan fault configured at ``point`` to ``value`` (an
        array, or a tuple/list of arrays). Returns the possibly-poisoned
        value; non-float arrays pass through untouched."""
        if not self.armed():
            return value
        for st in self._active_states().get(point, ()):
            if st.spec.kind != "nan":
                continue
            with self._lock:
                fire = self._draw(st)
            if fire:
                if not _nanifiable(value):
                    # nothing to poison (e.g. integer token ids): counting
                    # the injection would report a corruption that never
                    # happened
                    return value
                self._note(point, "nan")
                return _nanify(value)
        return value

    def corrupt_dataset(self, point: str, ds):
        """nan-corrupt a DataSet/MultiDataSet's features in place of the
        original (shallow copy — the caller's object is never mutated)."""
        if not self.armed():
            return ds
        for st in self._active_states().get(point, ()):
            if st.spec.kind != "nan":
                continue
            with self._lock:
                fire = self._draw(st)
            if fire:
                if not _nanifiable(ds.features):
                    return ds
                self._note(point, "nan")
                import copy
                out = copy.copy(ds)
                out.features = _nanify(out.features)
                return out
        return ds

    def snapshot(self) -> dict:
        with self._lock:
            # process-lifetime totals, NOT the live plan's counters — a
            # postmortem taken after a chaos plan was cleared must still
            # name what was injected
            injected = dict(self._injected_total)
        return {
            "enabled": resilience_enabled(),
            "env_spec": os.environ.get("DL4J_TPU_FAULTS", ""),
            "programmatic_plan": self._plan is not None,
            "injected": injected,
        }


def _nanify(value):
    if isinstance(value, (tuple, list)):
        return type(value)(_nanify(v) for v in value)
    if _is_tensor(value):
        return (value.new_full(value.shape, float("nan"))
                if value.is_floating_point() else value)
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.floating):
        return np.full(arr.shape, np.nan, arr.dtype)
    return value


def _nanifiable(value) -> bool:
    """True when ``value`` holds at least one float array ``_nanify``
    would actually poison."""
    if isinstance(value, (tuple, list)):
        return any(_nanifiable(v) for v in value)
    if _is_tensor(value):
        return value.is_floating_point()
    return np.issubdtype(np.asarray(value).dtype, np.floating)


def _is_tensor(value) -> bool:
    """A torch tensor (on any device), without importing torch here."""
    return type(value).__module__.startswith("torch") and hasattr(
        value, "is_floating_point")


# ------------------------------------------------------------ metric handles
# ONE label-bound-handle cache for the whole resilience layer (policy and
# recovery register through it too) — a registry reset drops every handle
# in one place instead of three private caches drifting apart
_handle_cache: Dict[Tuple, object] = {}
_handle_lock = threading.Lock()


def cached_metric_handle(key: Tuple, make):
    """Double-checked cache of a label-bound instrument handle; ``make``
    runs at most once per key per registry generation."""
    handle = _handle_cache.get(key)
    if handle is None:
        with _handle_lock:
            handle = _handle_cache.get(key)
            if handle is None:
                handle = _handle_cache[key] = make()
    return handle


def _injected_counter(point: str, kind: str):
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_faults_injected_total",
            "faults injected by the chaos registry, by injection point "
            "and kind", label_names=("point", "kind")).labels(
                point=point, kind=kind)
    return cached_metric_handle(("faults", point, kind), make)


def _on_registry_reset():
    with _handle_lock:
        _handle_cache.clear()


try:
    from deeplearning4j_tpu_torch.observability import on_registry_reset
    on_registry_reset(_on_registry_reset)
except Exception:            # pragma: no cover - observability always present
    pass


# --------------------------------------------------------- module-level API
_registry = FaultRegistry()


def install(plan: FaultPlan):
    _registry.install(plan)


def clear():
    _registry.clear()


def reset():
    """Full test-isolation reset: uninstall the plan AND forget the
    process-lifetime injection totals + event ring (production code never
    calls this — postmortems rely on the totals surviving clears)."""
    with _registry._lock:
        _registry.clear()
        _registry._injected_total.clear()
    clear_events()


@contextmanager
def active(plan: FaultPlan):
    """``with faults.active(plan): ...`` — scoped programmatic injection."""
    install(plan)
    try:
        yield _registry
    finally:
        clear()


def armed() -> bool:
    return _registry.armed()


def check(point: str):
    _registry.check(point)


def corrupt(point: str, value):
    return _registry.corrupt(point, value)


def corrupt_dataset(point: str, ds):
    return _registry.corrupt_dataset(point, ds)


def snapshot() -> dict:
    return _registry.snapshot()
