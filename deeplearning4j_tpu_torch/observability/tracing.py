"""Structured tracing: nested ``span()`` context managers, causal trace
context, and Chrome-trace export (tentpole of the observability PRs).

Spans record wall-clock duration with host thread + nesting depth, buffer
into a process-wide ring (bounded memory — a week-long trainer cannot OOM
the host by tracing), and export as Chrome trace-event JSON: complete
events (``ph: "X"`` with ``ts``/``dur`` in microseconds) plus flow events
(``ph: "s"/"f"``) that load directly in Perfetto / ``chrome://tracing``.
This is the portable twin of the device timeline ``profiler.xprof``
captures — host phases (data wait, dispatch, callbacks) live here, XLA
kernels live there.

Causal context (the production-tracing model of TF-Serving-style systems,
Abadi et al. arXiv:1605.08695 §9): every span carries
``trace_id``/``span_id``/``parent_id``. Within one thread, nesting on the
thread-local stack parents spans automatically. ACROSS threads and queues
the context is explicit: capture :func:`current_context` where a request
is enqueued, attach it to the queue item, and either open spans under
:func:`trace_context` on the consuming thread or stamp externally-timed
sections with :func:`record_span`. A request that crosses the
batcher→dispatcher→completer serving pipeline (or the device-prefetch
thread) then shares ONE trace_id, and the Chrome export emits flow events
so Perfetto draws the request arrows between threads.

Usage::

    from deeplearning4j_tpu_torch.observability import span

    with span("fit.step", iteration=i):
        with span("data_wait"):
            batch = next(it)
        ...

    # cross-thread: producer side
    ctx = current_context()
    queue.put((work, ctx))
    # consumer side
    work, ctx = queue.get()
    with trace_context(ctx), span("consume"):
        ...

Kill switches: ``DL4J_TPU_METRICS=0`` (everything no-ops) and
``DL4J_TPU_TRACE=0`` (spans no-op, metrics stay live — isolates the
trace-propagation cost, see benchmarks/obs_overhead.py).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

from deeplearning4j_tpu_torch.observability.registry import (global_registry,
                                                             metrics_enabled,
                                                             on_registry_reset)
# cycle-safe: trace_store imports only registry, never tracing
from deeplearning4j_tpu_torch.observability.trace_store import (store_span_close,
                                                                store_span_open)

#: default ring capacity — ~200k spans at <100 bytes each stays tens of MB
_DEFAULT_CAPACITY = 65536

# trace clock: perf_counter is monotonic; anchor it once so ts values are
# comparable across threads and roughly epoch-aligned
_EPOCH_ANCHOR = time.time() - time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() + _EPOCH_ANCHOR) * 1e6


#: public alias — callers timing cross-thread sections (queue waits) use
#: the same clock so their spans line up with ``with span(...)`` records
now_us = _now_us


def tracing_enabled() -> bool:
    """Spans record only when metrics are on AND ``DL4J_TPU_TRACE`` != 0
    (the latter keeps metrics live while isolating tracing's cost)."""
    return metrics_enabled() and os.environ.get("DL4J_TPU_TRACE", "1") != "0"


def _new_id() -> str:
    """16-hex-char random id (64 bits — the W3C trace-context span-id
    size; cheap enough for one or two per span on a hot fit loop)."""
    return os.urandom(8).hex()


class TraceContext(NamedTuple):
    """The portable half of a span: what a queue item must carry so work
    executed on another thread parents into the originating trace."""

    trace_id: str
    span_id: str


class SpanRecord:
    """One finished span (complete event)."""

    __slots__ = ("name", "ts_us", "dur_us", "tid", "depth", "attrs",
                 "trace_id", "span_id", "parent_id", "error", "error_type")

    def __init__(self, name: str, ts_us: float, dur_us: float, tid: int,
                 depth: int, attrs: Optional[Dict[str, Any]],
                 trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 error: bool = False, error_type: Optional[str] = None):
        self.name = name
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.tid = tid
        self.depth = depth
        self.attrs = attrs
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.error = error
        self.error_type = error_type

    def to_chrome_event(self) -> Dict[str, Any]:
        ev = {"name": self.name, "ph": "X", "ts": self.ts_us,
              "dur": self.dur_us, "pid": os.getpid(), "tid": self.tid,
              "cat": "host"}
        args: Dict[str, Any] = {}
        if self.attrs:
            args.update({k: (v if isinstance(v, (int, float, bool, str)
                                            ) or v is None else str(v))
                         for k, v in self.attrs.items()})
        if self.trace_id is not None:
            args["trace_id"] = self.trace_id
            args["span_id"] = self.span_id
            if self.parent_id is not None:
                args["parent_id"] = self.parent_id
        if self.error:
            args["error"] = True
            if self.error_type:
                args["error_type"] = self.error_type
        if args:
            ev["args"] = args
        return ev


# lazily-bound ring instruments (satellite: silent overflow made traces lie
# by omission — drops and occupancy are now scrapeable)
_ring_obs_cache: Optional[tuple] = None
_err_children: Dict[str, Any] = {}


def _ring_obs():
    global _ring_obs_cache
    if _ring_obs_cache is None:
        reg = global_registry()
        _ring_obs_cache = (
            reg.counter("dl4j_trace_spans_dropped_total",
                        "spans overwritten in the global trace ring before "
                        "export (raise TraceSink capacity if nonzero)"),
            reg.gauge("dl4j_trace_ring_fill_ratio",
                      "occupancy of the global trace ring (1.0 = full, "
                      "oldest spans are being dropped)"))
    return _ring_obs_cache


def _span_errors(name: str):
    child = _err_children.get(name)
    if child is None:
        child = _err_children[name] = global_registry().counter(
            "dl4j_span_errors_total",
            "spans that exited with an exception, by span name",
            label_names=("name",)).labels(name=name)
    return child


@on_registry_reset
def _drop_tracing_obs():
    global _ring_obs_cache
    _ring_obs_cache = None
    _err_children.clear()


class TraceSink:
    """Ring-buffered in-memory span store with Chrome-trace export."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._buf: List[Optional[SpanRecord]] = [None] * capacity
        self._head = 0          # next write slot
        self._total = 0         # spans ever recorded (drops = total - kept)
        self._drops_pending = 0  # overwrites not yet flushed to the counter
        self._lock = threading.Lock()

    def record(self, rec: SpanRecord):
        with self._lock:
            if self._buf[self._head] is not None:
                self._drops_pending += 1
            self._buf[self._head] = rec
            self._head = (self._head + 1) % self.capacity
            self._total += 1
            total = self._total
            publish = total % 64 == 0 or total == self.capacity
            flush, self._drops_pending = (
                (self._drops_pending, 0) if publish else (0,
                                                          self._drops_pending))
        if self is _global_sink and publish:
            # only THE process sink publishes ring health — per-test local
            # sinks would clobber each other's gauge. Both the fill gauge
            # and the drop counter flush every 64 records (once the ring
            # wraps, EVERY record overwrites — per-record instrument locks
            # on the span-exit hot path are exactly what this avoids; the
            # counter lags reality by <64 drops, scrape-time telemetry)
            dropped, fill_g = _ring_obs()
            if flush:
                dropped.inc(flush)
            fill_g.set(min(total, self.capacity) / self.capacity)

    def __len__(self) -> int:
        return min(self._total, self.capacity)

    @property
    def total_recorded(self) -> int:
        return self._total

    @property
    def dropped(self) -> int:
        return max(0, self._total - self.capacity)

    def spans(self) -> List[SpanRecord]:
        """Retained spans, oldest first."""
        with self._lock:
            if self._total <= self.capacity:
                out = self._buf[:self._head]
            else:
                out = self._buf[self._head:] + self._buf[:self._head]
            return [r for r in out if r is not None]

    def clear(self):
        with self._lock:
            self._buf = [None] * self.capacity
            self._head = 0
            self._total = 0
            flush, self._drops_pending = self._drops_pending, 0
        if self is _global_sink:
            # flush unreported drops and keep the occupancy gauge truthful
            # across a manual clear — a stale 1.0 would read as "currently
            # dropping spans"
            dropped, fill_g = _ring_obs()
            if flush:
                dropped.inc(flush)
            fill_g.set(0.0)

    # ------------------------------------------------------------- export
    def to_chrome_trace(self, flow_events: bool = True) -> List[Dict[str, Any]]:
        """The JSON-array flavor of the chrome trace format (what Perfetto
        and chrome://tracing load): complete events (``ph:"X"``) plus, for
        every parent→child edge that crosses threads, a flow-event pair
        (``ph:"s"`` on the parent's thread, ``ph:"f"`` on the child's) so
        the UI draws the request arrows across the pipeline."""
        spans = self.spans()
        events = [r.to_chrome_event() for r in spans]
        if not flow_events:
            return events
        by_id = {r.span_id: r for r in spans if r.span_id}
        pid = os.getpid()
        for r in spans:
            parent = by_id.get(r.parent_id) if r.parent_id else None
            if parent is None or parent.tid == r.tid:
                continue        # same-thread nesting needs no arrow
            # bind the arrow to the parent's slice start and the child's
            # slice start; Chrome requires s.ts <= f.ts
            s_ts = min(parent.ts_us, r.ts_us)
            events.append({"name": "handoff", "cat": "flow", "ph": "s",
                           "id": r.span_id, "ts": s_ts, "pid": pid,
                           "tid": parent.tid})
            events.append({"name": "handoff", "cat": "flow", "ph": "f",
                           "bp": "e", "id": r.span_id,
                           "ts": max(r.ts_us, s_ts), "pid": pid,
                           "tid": r.tid})
        return events

    def export_json(self, path: Optional[str] = None) -> str:
        payload = json.dumps(self.to_chrome_trace())
        if path is not None:
            with open(path, "w") as f:
                f.write(payload)
        return payload


_global_sink: Optional[TraceSink] = None
_sink_lock = threading.Lock()
_tls = threading.local()


def global_trace_sink() -> TraceSink:
    global _global_sink
    if _global_sink is None:
        with _sink_lock:
            if _global_sink is None:
                _global_sink = TraceSink()
    return _global_sink


def reset_global_trace_sink(capacity: int = _DEFAULT_CAPACITY) -> TraceSink:
    global _global_sink
    with _sink_lock:
        _global_sink = TraceSink(capacity)
    return _global_sink


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_context() -> Optional[TraceContext]:
    """The context new work on THIS thread would parent under: the
    innermost open span, else a context attached via :func:`trace_context`,
    else None. Capture it at an enqueue site and ship it with the item."""
    st = getattr(_tls, "stack", None)
    if st:
        top = st[-1]
        return TraceContext(top.trace_id, top.span_id)
    return getattr(_tls, "ctx", None)


class trace_context:
    """Attach a captured :class:`TraceContext` to the current thread for
    the duration of the block — spans opened inside parent under it, so a
    worker thread's sections join the enqueuing request's trace::

        with trace_context(ctx), span("prefetch_place"):
            ...

    ``None`` is accepted and leaves the thread context unchanged-in-effect
    (callers need no conditional around the handoff)."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx if self.ctx is not None else self._prev
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


class Span:
    """Context manager measuring one named section; nests via a
    thread-local stack so ``depth`` reflects the live call structure, and
    carries trace context (see module doc) so cross-thread work links."""

    __slots__ = ("name", "attrs", "sink", "_ts", "depth",
                 "trace_id", "span_id", "parent_id")

    def __init__(self, name: str, sink: Optional[TraceSink] = None,
                 **attrs):
        self.name = name
        self.attrs = attrs or None
        self.sink = sink

    def set_attr(self, key: str, value):
        """Attach/overwrite an attribute while the span is open."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __enter__(self):
        st = _stack()
        self.depth = len(st)
        if st:                          # nested: parent is the open span
            parent = st[-1]
            self.trace_id, self.parent_id = parent.trace_id, parent.span_id
        else:
            ctx = getattr(_tls, "ctx", None)
            if ctx is not None:         # cross-thread attached context
                self.trace_id, self.parent_id = ctx.trace_id, ctx.span_id
            else:                       # root: new trace
                self.trace_id, self.parent_id = _new_id(), None
        self.span_id = _new_id()
        if self.sink is None:
            # global-sink spans also feed the completed-trace store: the
            # open/close balance tells it when a trace's last span closed
            store_span_open(self.trace_id)
        st.append(self)
        self._ts = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        # dur shares self._ts's clock read: a second perf_counter
        # capture at enter left a preemption window that could make a
        # child's end time exceed its parent's (ts + dur must nest)
        dur = _now_us() - self._ts
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        else:                       # tolerate out-of-order exits
            try:
                st.remove(self)
            except ValueError:
                pass
        # satellite fix: the exception triple is no longer ignored —
        # failing sections are visible in traces AND as a counter series
        error = exc_type is not None
        # explicit None check: an EMPTY TraceSink is falsy (__len__ == 0),
        # so `or` would silently reroute the first span to the global sink
        sink = self.sink if self.sink is not None else global_trace_sink()
        rec = SpanRecord(
            self.name, self._ts, dur, threading.get_ident(), self.depth,
            self.attrs, trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self.parent_id, error=error,
            error_type=exc_type.__name__ if error else None)
        sink.record(rec)
        if self.sink is None:
            store_span_close(rec, True)
        if error:
            _span_errors(self.name).inc()
        return False


class _NoopSpan:
    __slots__ = ()

    def set_attr(self, key, value):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def span(name: str, sink: Optional[TraceSink] = None, **attrs):
    """``with span("name", **attrs):`` — the one tracing entry point."""
    if not tracing_enabled():
        return _NOOP
    return Span(name, sink, **attrs)


def record_span(name: str, start_us: float, end_us: Optional[float] = None,
                ctx: Optional[TraceContext] = None,
                sink: Optional[TraceSink] = None,
                **attrs) -> Optional[SpanRecord]:
    """Record an externally-timed span — a section whose start and end were
    observed on different sides of a queue (e.g. a request's queue_wait:
    enqueue stamped on the producer, dequeue observed by the batcher).

    ``ctx`` parents the record into the originating trace; timestamps use
    the :func:`now_us` clock. Returns the record (None when tracing is
    off)."""
    if not tracing_enabled():
        return None
    end = end_us if end_us is not None else _now_us()
    rec = SpanRecord(
        name, start_us, max(0.0, end - start_us), threading.get_ident(), 0,
        attrs or None,
        trace_id=ctx.trace_id if ctx is not None else _new_id(),
        span_id=_new_id(),
        parent_id=ctx.span_id if ctx is not None else None)
    if sink is not None:
        sink.record(rec)
    else:
        global_trace_sink().record(rec)
        # externally-timed spans never opened on a stack; they complete a
        # trace only when it has no still-open span() blocks
        store_span_close(rec, False)
    return rec


def current_span() -> Optional[Span]:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None
