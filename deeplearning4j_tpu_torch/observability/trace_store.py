"""Trace intelligence: a bounded-bytes per-process store of *completed*
traces with head sampling plus tail-based retention.

PR 16 carried one trace id across the whole fleet, but the spans behind
that id still died in per-process :class:`TraceSink` ring buffers — by
the time a p99 or failed request was noticed, its trace had usually been
overwritten.  This store sits BEHIND the span ring (the ring stays the
raw recent-everything view): every span recorded into the *global* sink
is also fed here, grouped by ``trace_id``, and when a trace completes
(its last open span closes) a keep/discard decision runs:

1. **error** — the trace's root span ended in an exception, a typed shed
   / deadline outcome, or an HTTP error status (the front door stamps
   ``error_type``/``status`` attrs on its root span).
2. **latency_tail** — the root's duration exceeds a rolling per-endpoint
   quantile threshold (``DL4J_TPU_TRACE_TAIL_Q``, default p95 over the
   endpoint's recent window) — tail-based sampling: the traces worth
   keeping are exactly the ones the head sampler would have missed.
3. **incident** — the trace id was pinned (flight-recorder incident
   protocol) or the trace completed inside an active incident window.
4. **head_sample** — a uniform coin at ``DL4J_TPU_TRACE_SAMPLE`` keeps a
   bounded baseline of boring traces for comparison.

Retained traces are indexed by id with their why-kept reason
(``dl4j_trace_retained_total{reason}`` / ``dl4j_trace_discarded_total``)
inside a bytes budget (``DL4J_TPU_TRACE_STORE_BYTES``): oldest
unpinned traces evict first, and the store-bytes gauges make the budget
scrapeable.  ``federation.py`` assembles any retained id fleet-wide
(``GET /debug/trace/<id>``) into one cross-worker waterfall.

Kill switch: ``DL4J_TPU_TRACE_STORE=0`` (read live per call) restores
byte-identical pre-store behavior — no feeds, no instruments, no debug
endpoints.  The store only sees spans at all when tracing is on
(``DL4J_TPU_METRICS`` / ``DL4J_TPU_TRACE``).
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.observability.registry import (global_registry,
                                                             on_registry_reset)

#: default bytes budget for retained traces (~8 MiB ≈ thousands of
#: request-sized traces; a week-long server cannot OOM the host keeping
#: its own postmortems)
DEFAULT_BUDGET_BYTES = 8 << 20

#: default head-sampling probability for traces no tail rule kept
DEFAULT_SAMPLE = 0.01

#: default rolling-quantile threshold for the latency-tail rule
DEFAULT_TAIL_QUANTILE = 0.95

#: per-endpoint rolling window length and the minimum samples before the
#: tail rule activates (an empty window has no p95 to exceed)
_TAIL_WINDOW = 128
_TAIL_MIN_SAMPLES = 16

#: bounded in-progress state: open traces beyond this evict oldest-first
#: (a leaked trace context must not grow the pending map forever), and a
#: single trace buffers at most this many spans (a fit loop's thousands
#: of nested spans truncate, keeping the root + earliest structure)
_MAX_PENDING = 512
_MAX_SPANS_PER_TRACE = 256

#: incident pins are a tiny set — one per coordinated capture, not one
#: per request
_MAX_PINS = 32

#: bounded hook queue: span hooks append here (one lock-free deque
#: append on the hot path) and a daemon drainer runs the retention
#: machinery off the request's critical path; overflow drops oldest
_QUEUE_MAX = 8192

#: drainer poll interval — also the worst-case retention-decision lag
#: (queries drain synchronously, so reads never see it)
_DRAIN_INTERVAL_S = 0.05

#: default incident window: traces completing this long after an
#: incident trips are kept (the requests AROUND a death explain it)
INCIDENT_WINDOW_S = 30.0

#: root-span names whose error/latency decide retention for serving
#: traffic; attrs stamped by the front door / proxy ride on these
_TYPED_ERROR_OUTCOMES = ("reset", "no_backend")


# The hooks run on EVERY span open/close, and os.environ's Mapping +
# key-encode machinery is a measured ~2.5us per read — a third of the
# whole hook budget.  os.environ._data is the live dict the Mapping
# mutates (setenv/monkeypatch write through to it), so reading it with a
# precomputed byte key is exactly as live at plain-dict speed.  Parses
# are cached keyed on the RAW value, so flipping a knob mid-process
# still takes effect on the very next span.
try:
    _ENV_DATA = os.environ._data          # CPython; keys are fsencoded
    _K_STORE = os.fsencode("DL4J_TPU_TRACE_STORE")
    _K_SAMPLE = os.fsencode("DL4J_TPU_TRACE_SAMPLE")
    _K_TAIL_Q = os.fsencode("DL4J_TPU_TRACE_TAIL_Q")
    _K_BYTES = os.fsencode("DL4J_TPU_TRACE_STORE_BYTES")
except AttributeError:                    # non-CPython fallback
    _ENV_DATA = None


def _raw_knob(key_bytes, name: str):
    if _ENV_DATA is not None:
        v = _ENV_DATA.get(key_bytes)
        return None if v is None else os.fsdecode(v)
    return os.environ.get(name)


def trace_store_enabled() -> bool:
    """``DL4J_TPU_TRACE_STORE`` kill switch, resolved LIVE per call —
    with it off the span-close hook is inert and behavior is
    byte-identical to the pre-store code."""
    if _ENV_DATA is not None:
        return _ENV_DATA.get(_K_STORE, b"1") != b"0"
    return os.environ.get("DL4J_TPU_TRACE_STORE", "1") != "0"


_sample_cache = (None, DEFAULT_SAMPLE)
_tail_q_cache = (None, DEFAULT_TAIL_QUANTILE)
_budget_cache = (None, DEFAULT_BUDGET_BYTES)


def sample_rate() -> float:
    """``DL4J_TPU_TRACE_SAMPLE`` — head-sampling probability in [0, 1]
    for traces no tail rule retained."""
    global _sample_cache
    raw = _raw_knob(_K_SAMPLE, "DL4J_TPU_TRACE_SAMPLE")
    if raw == _sample_cache[0]:
        return _sample_cache[1]
    try:
        v = min(1.0, max(0.0, float(raw)))
    except (TypeError, ValueError):
        v = DEFAULT_SAMPLE
    _sample_cache = (raw, v)
    return v


def tail_quantile() -> float:
    """``DL4J_TPU_TRACE_TAIL_Q`` — the rolling per-endpoint latency
    quantile a root must exceed to be tail-retained."""
    global _tail_q_cache
    raw = _raw_knob(_K_TAIL_Q, "DL4J_TPU_TRACE_TAIL_Q")
    if raw == _tail_q_cache[0]:
        return _tail_q_cache[1]
    try:
        v = min(0.999, max(0.5, float(raw)))
    except (TypeError, ValueError):
        v = DEFAULT_TAIL_QUANTILE
    _tail_q_cache = (raw, v)
    return v


def budget_bytes() -> int:
    """``DL4J_TPU_TRACE_STORE_BYTES`` — the retained-trace bytes budget
    (estimated span bytes; oldest unpinned traces evict past it)."""
    global _budget_cache
    raw = _raw_knob(_K_BYTES, "DL4J_TPU_TRACE_STORE_BYTES")
    if raw == _budget_cache[0]:
        return _budget_cache[1]
    try:
        v = max(64 << 10, int(raw))
    except (TypeError, ValueError):
        v = DEFAULT_BUDGET_BYTES
    _budget_cache = (raw, v)
    return v


# lazily-bound instruments (the tracing.py `_ring_obs` posture: no
# registry work on import, registry-reset safe)
_obs_cache: Optional[tuple] = None
_retained_children: Dict[str, Any] = {}


def _obs():
    global _obs_cache
    if _obs_cache is None:
        reg = global_registry()
        _obs_cache = (
            reg.counter("dl4j_trace_retained_total",
                        "completed traces kept by the trace store, by "
                        "why-kept reason (error / latency_tail / "
                        "incident / head_sample)",
                        label_names=("reason",)),
            reg.counter("dl4j_trace_discarded_total",
                        "completed traces the retention rules dropped "
                        "(boring and head-unsampled)"),
            reg.counter("dl4j_trace_store_evicted_total",
                        "retained traces evicted oldest-first to stay "
                        "inside the bytes budget"),
            reg.gauge("dl4j_trace_store_bytes",
                      "estimated bytes of retained trace spans "
                      "currently held by the trace store"),
            reg.gauge("dl4j_trace_store_budget_bytes",
                      "the trace store's bytes budget "
                      "(DL4J_TPU_TRACE_STORE_BYTES)"),
            reg.gauge("dl4j_trace_store_traces",
                      "retained traces currently held by the trace "
                      "store"))
    return _obs_cache


def _retained_counter(reason: str):
    child = _retained_children.get(reason)
    if child is None:
        child = _retained_children[reason] = _obs()[0].labels(reason=reason)
    return child


@on_registry_reset
def _drop_store_obs():
    global _obs_cache
    _obs_cache = None
    _retained_children.clear()


def _span_dict(rec) -> Dict[str, Any]:
    """A SpanRecord as the JSON shape the debug endpoints and fleet
    assembly ship (attrs coerced to scalars the same way the Chrome
    export does)."""
    attrs = {}
    if rec.attrs:
        attrs = {k: (v if isinstance(v, (int, float, bool, str))
                     or v is None else str(v))
                 for k, v in rec.attrs.items()}
    return {"name": rec.name, "ts_us": rec.ts_us, "dur_us": rec.dur_us,
            "tid": rec.tid, "depth": rec.depth, "attrs": attrs,
            "trace_id": rec.trace_id, "span_id": rec.span_id,
            "parent_id": rec.parent_id, "error": bool(rec.error),
            "error_type": rec.error_type}


def _est_bytes(span: Dict[str, Any]) -> int:
    """Cheap per-span byte estimate for the budget — close enough to
    the JSON size without serializing on the span-close hot path."""
    n = 120 + len(span["name"] or "")
    for k, v in (span["attrs"] or {}).items():
        n += len(str(k)) + len(str(v)) + 8
    return n


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("inf")
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class _Pending:
    """One in-flight trace: spans fed so far + the count of still-open
    ``span()`` blocks (the close of the last one completes the trace)."""

    __slots__ = ("spans", "open_count", "started", "truncated")

    def __init__(self):
        self.spans: List[Any] = []      # raw SpanRecords until decision
        self.open_count = 0
        self.started = time.monotonic()
        self.truncated = False


class TraceStore:
    """See module doc.  One process-wide instance via
    :func:`global_trace_store`; tests construct their own."""

    def __init__(self, budget: Optional[int] = None):
        self._budget_override = budget
        self._lock = threading.Lock()
        self._pending: "OrderedDict[str, _Pending]" = OrderedDict()
        self._retained: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._bytes = 0
        self._tail: Dict[str, deque] = {}
        # per-endpoint cached tail threshold: (threshold, appends since
        # recompute) — re-sorting the 128-sample window on EVERY span
        # close is the measured hot spot; a threshold ≤8 samples stale
        # is the same tail, 1/8th the sorts
        self._tail_thresh: Dict[str, list] = {}
        self._pins: "OrderedDict[str, bool]" = OrderedDict()
        self._incident_until = 0.0
        self._rng = random.Random()
        # async hook queue (GIL economics: a span close on the batcher
        # thread sits on every batched request's handoff path, and ANY
        # locked Python work there was measured at ~17us wall under
        # contention — a deque append is the whole hot-path cost)
        self._queue: deque = deque(maxlen=_QUEUE_MAX)
        self._drain_lock = threading.Lock()
        self._drainer: Optional[threading.Thread] = None
        # decision counters mirrored locally so snapshot()/tests don't
        # need a registry scrape
        self.retained_count = 0
        self.discarded_count = 0
        self.evicted_count = 0

    # ----------------------------------------------------- async hook path
    def enqueue_open(self, trace_id: Optional[str]):
        """Hot-path half of :meth:`note_open`: one deque append; the
        drainer (or the next query) does the locked work."""
        if trace_id:
            self._queue.append((None, trace_id))
            if self._drainer is None:
                self._start_drainer()

    def enqueue_close(self, rec, span_close: bool = True):
        """Hot-path half of :meth:`feed`."""
        if rec.trace_id:
            self._queue.append((rec, span_close))
            if self._drainer is None:
                self._start_drainer()

    def _start_drainer(self):
        with self._drain_lock:
            if self._drainer is not None:
                return
            t = threading.Thread(target=self._drain_loop,
                                 name="dl4j-trace-store-drain", daemon=True)
            self._drainer = t
            t.start()

    def _drain_loop(self):
        while True:
            time.sleep(_DRAIN_INTERVAL_S)
            try:
                self.drain()
            except Exception:
                pass            # the store must never kill its drainer

    def drain(self):
        """Apply every queued hook event now (queries call this, so a
        read is always coherent with the spans closed before it).
        Serialized (two concurrent drainers would interleave pops and
        apply a close before its own open) and batched: one store-lock
        acquisition per pass, not per event — on a GIL-bound box the
        store's total bytecode IS its overhead, so per-event locking
        was the next-biggest line item after the hooks themselves."""
        q = self._queue
        with self._drain_lock:
            batch = []
            while q:
                try:
                    batch.append(q.popleft())
                except IndexError:
                    break
            if not batch:
                return
            publishes = []
            with self._lock:
                for rec, arg in batch:
                    if rec is None:
                        self._note_open_locked(arg)
                    else:
                        pub = self._feed_locked(rec, arg)
                        if pub:
                            publishes.append(pub)
        for pub in publishes:
            self._flush(pub)

    # ------------------------------------------------------------- feeding
    def note_open(self, trace_id: Optional[str]):
        """A ``span()`` block opened under ``trace_id`` (global sink):
        the trace cannot complete until this block's close is fed."""
        if not trace_id:
            return
        with self._lock:
            self._note_open_locked(trace_id)

    def _note_open_locked(self, trace_id: str):
        if trace_id in self._retained:
            return
        p = self._pending.get(trace_id)
        if p is None:
            p = self._ensure_pending_locked(trace_id)
        p.open_count += 1

    def _ensure_pending_locked(self, trace_id: str) -> _Pending:
        p = self._pending[trace_id] = _Pending()
        self._pending.move_to_end(trace_id)
        # bounded in-progress state: a leaked context (thread died with
        # the span open) is discarded oldest-first, never accumulated
        while len(self._pending) > _MAX_PENDING:
            self._pending.popitem(last=False)
            # counted locally only — the registry counter flushes on the
            # next completed-trace decision (no instrument work under a
            # hook that runs on every span open)
            self.discarded_count += 1
        return p

    def feed(self, rec, span_close: bool = True):
        """One completed span record (from the global sink).
        ``span_close`` is True for ``Span.__exit__`` records (they
        balance a :meth:`note_open`), False for externally-timed
        :func:`record_span` records."""
        tid = rec.trace_id
        if not tid:
            return
        with self._lock:
            publish = self._feed_locked(rec, span_close)
        if publish:
            self._flush(publish)

    def _feed_locked(self, rec, span_close: bool) -> Optional[dict]:
        tid = rec.trace_id
        entry = self._retained.get(tid)
        if entry is not None:
            # late span for an already-retained trace (a queue
            # consumer finishing after the root closed): append it
            if len(entry["spans"]) < _MAX_SPANS_PER_TRACE:
                span = _span_dict(rec)
                entry["spans"].append(span)
                entry["spans"].sort(key=lambda s: s["ts_us"])
                grew = _est_bytes(span)
                entry["bytes"] += grew
                self._bytes += grew
                return self._evict_locked()
            entry["truncated"] = True
            return None
        p = self._pending.get(tid)
        if p is None:
            if not span_close:
                # orphan externally-timed record (a phase marker under
                # a fresh id, no span() block to join): a one-span
                # "trace" is never an assemblable waterfall, and
                # finalizing one per batch on the batcher thread sat on
                # every request's handoff critical path — drop it
                return None
            p = self._ensure_pending_locked(tid)
        # raw SpanRecords until the keep/discard decision — the
        # common discard path never pays per-span dict building
        if len(p.spans) < _MAX_SPANS_PER_TRACE:
            p.spans.append(rec)
        else:
            p.truncated = True
        if span_close and p.open_count > 0:
            p.open_count -= 1
        if p.open_count <= 0:
            del self._pending[tid]
            return self._finalize_locked(tid, p)
        return None

    # ----------------------------------------------------------- retention
    def _root_of(self, recs) -> Any:
        """The trace's root SpanRecord: no parent, or a parent that is
        not a local span (a joined fleet trace's proxy parent)."""
        ids = {r.span_id for r in recs if r.span_id}
        roots = [r for r in recs
                 if not r.parent_id or r.parent_id not in ids]
        pool = roots or recs
        return max(pool, key=lambda r: (r.dur_us, -r.ts_us))

    @staticmethod
    def _root_errored(root: Dict[str, Any]) -> bool:
        if root["error"] or root["error_type"]:
            return True
        attrs = root["attrs"] or {}
        if attrs.get("error_type"):
            return True             # front door: typed shed/deadline/4xx
        try:
            if int(attrs.get("status", 200)) >= 400:
                return True
        except (TypeError, ValueError):
            pass
        return attrs.get("outcome") in _TYPED_ERROR_OUTCOMES  # proxy span

    def _endpoint_key(self, root: Dict[str, Any]) -> str:
        route = (root["attrs"] or {}).get("route")
        return f"{root['name']}:{route}" if route else root["name"]

    def _finalize_locked(self, tid: str, p: _Pending) -> Optional[dict]:
        """The keep/discard decision for one completed trace; returns
        the instrument updates to flush OUTSIDE the lock."""
        recs = p.spans
        if not recs:
            return None
        root = _span_dict(self._root_of(recs))
        endpoint = self._endpoint_key(root)
        window = self._tail.get(endpoint)
        if window is None:
            if len(self._tail) < 64:        # bounded endpoint keys (the
                window = self._tail[endpoint] = deque(maxlen=_TAIL_WINDOW)
            # span-names lint keeps names literal, but a rogue caller
            # must not explode this dict either

        reason = None
        if tid in self._pins:
            reason = "incident"
        elif self._root_errored(root):
            reason = "error"
        elif (window is not None and len(window) >= _TAIL_MIN_SAMPLES
                and root["dur_us"] > self._tail_threshold_locked(endpoint,
                                                                 window)):
            reason = "latency_tail"
        elif time.time() < self._incident_until:
            reason = "incident"
        elif self._rng.random() < sample_rate():
            reason = "head_sample"
        if window is not None:
            window.append(float(root["dur_us"]))
        if reason is None:
            self.discarded_count += 1
            return {"discarded": 1}
        spans = sorted((_span_dict(r) for r in recs),
                       key=lambda s: s["ts_us"])
        entry = {
            "trace_id": tid, "reason": reason, "root": root["name"],
            "route": (root["attrs"] or {}).get("route"),
            "tenant": (root["attrs"] or {}).get("tenant"),
            "ts_us": root["ts_us"], "dur_us": root["dur_us"],
            "error": self._root_errored(root),
            "error_type": (root["error_type"]
                           or (root["attrs"] or {}).get("error_type")),
            "at": time.time(), "pinned": tid in self._pins,
            "truncated": p.truncated,
            "bytes": sum(_est_bytes(s) for s in spans),
            "spans": spans,
        }
        self._retained[tid] = entry
        self._bytes += entry["bytes"]
        self.retained_count += 1
        out = self._evict_locked() or {}
        out["retained"] = reason
        return out

    def _tail_threshold_locked(self, endpoint: str, window: deque) -> float:
        """The rolling quantile over ``window``, recomputed at most
        every 8 appends (sorting 128 floats per span close was the
        measured hot spot; a few-sample-stale threshold keeps the same
        tail)."""
        cached = self._tail_thresh.get(endpoint)
        if cached is not None and cached[1] < 8:
            cached[1] += 1
            return cached[0]
        thresh = _quantile(sorted(window), tail_quantile())
        self._tail_thresh[endpoint] = [thresh, 0]
        return thresh

    def _evict_locked(self) -> Optional[dict]:
        """FIFO eviction past the bytes budget, skipping pinned traces
        (an incident's evidence outlives the budget until unpinned)."""
        budget = (self._budget_override if self._budget_override is not None
                  else budget_bytes())
        evicted = 0
        if self._bytes > budget:
            # graftlint: disable=lock-discipline — _locked suffix: every
            # caller already holds self._lock (checker can't cross calls)
            for tid in list(self._retained):
                if self._bytes <= budget:
                    break
                if self._retained[tid].get("pinned"):
                    continue
                self._bytes -= self._retained[tid]["bytes"]
                del self._retained[tid]
                evicted += 1
        if evicted:
            self.evicted_count += evicted
            return {"evicted": evicted}
        return None

    def _flush(self, updates: dict):
        """Publish instrument updates outside the store lock (the
        TraceSink discipline: no metric locks under the span path's
        lock)."""
        try:
            (retained_c, discarded_c, evicted_c, bytes_g, budget_g,
             traces_g) = _obs()
            reason = updates.get("retained")
            if reason:
                _retained_counter(reason).inc()
            if updates.get("discarded"):
                discarded_c.inc(updates["discarded"])
            if updates.get("evicted"):
                evicted_c.inc(updates["evicted"])
            if reason or updates.get("evicted"):
                # the gauges only move when the retained set does — the
                # common discard path (99% of traffic at the default
                # head rate) skips three gauge writes per request
                bytes_g.set(float(self._bytes))
                budget_g.set(float(self._budget_override
                                   if self._budget_override is not None
                                   else budget_bytes()))
                traces_g.set(float(len(self._retained)))
        except Exception:
            pass        # metrics off / mid-reset must never break a span

    # ----------------------------------------------------------- incidents
    def pin(self, trace_id: Optional[str]):
        """Always-retain ``trace_id``: if already retained it becomes
        eviction-exempt; if still pending/future it will be kept with
        reason ``incident`` when it completes."""
        if not trace_id:
            return
        with self._lock:
            self._pins[trace_id] = True
            while len(self._pins) > _MAX_PINS:
                old, _ = self._pins.popitem(last=False)
                ent = self._retained.get(old)
                if ent is not None:
                    ent["pinned"] = False
            ent = self._retained.get(trace_id)
            if ent is not None:
                ent["pinned"] = True

    def pinned_ids(self) -> List[str]:
        with self._lock:
            return list(self._pins)

    def open_incident_window(self, seconds: float = INCIDENT_WINDOW_S):
        """Keep every trace completing in the next ``seconds`` — the
        requests around an incident explain it."""
        with self._lock:
            self._incident_until = max(self._incident_until,
                                       time.time() + max(0.0, seconds))

    def incident_active(self) -> bool:
        return time.time() < self._incident_until

    # ------------------------------------------------------------- queries
    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The retained trace payload (spans included), or None."""
        self.drain()
        with self._lock:
            entry = self._retained.get(trace_id)
            if entry is None:
                return None
            out = dict(entry)
            out["spans"] = list(entry["spans"])
            return out

    def recent(self, limit: int = 64) -> List[Dict[str, Any]]:
        """Newest-first retained-trace summaries (no span bodies)."""
        self.drain()
        with self._lock:
            entries = list(self._retained.values())[-max(1, int(limit)):]
        return [{k: e[k] for k in
                 ("trace_id", "reason", "root", "route", "tenant",
                  "ts_us", "dur_us", "error", "error_type", "at",
                  "pinned", "truncated", "bytes")}
                | {"n_spans": len(e["spans"])}
                for e in reversed(entries)]

    def snapshot(self) -> Dict[str, Any]:
        self.drain()
        with self._lock:
            return {
                "enabled": trace_store_enabled(),
                "traces": len(self._retained),
                "pending": len(self._pending),
                "bytes": self._bytes,
                "budget_bytes": (self._budget_override
                                 if self._budget_override is not None
                                 else budget_bytes()),
                "retained": self.retained_count,
                "discarded": self.discarded_count,
                "evicted": self.evicted_count,
                "pinned": list(self._pins),
                "incident_window_open": time.time() < self._incident_until,
                "sample_rate": sample_rate(),
                "tail_quantile": tail_quantile(),
            }

    def clear(self):
        self._queue.clear()
        with self._lock:
            self._pending.clear()
            self._retained.clear()
            self._tail.clear()
            self._tail_thresh.clear()
            self._pins.clear()
            self._bytes = 0
            self._incident_until = 0.0


_global_store: Optional[TraceStore] = None
_store_lock = threading.Lock()


def global_trace_store() -> TraceStore:
    global _global_store
    if _global_store is None:
        with _store_lock:
            if _global_store is None:
                _global_store = TraceStore()
    return _global_store


def reset_global_trace_store(**kw) -> TraceStore:
    global _global_store
    with _store_lock:
        _global_store = TraceStore(**kw)
    return _global_store


# ------------------------------------------------- tracing-side hooks
# (called by tracing.py for every global-sink span; both resolve the
# kill switch LIVE so DL4J_TPU_TRACE_STORE=0 is a pure no-op)

def store_span_open(trace_id: Optional[str]) -> None:
    if not trace_store_enabled():
        return
    global_trace_store().enqueue_open(trace_id)


def store_span_close(rec, span_close: bool = True) -> None:
    if not trace_store_enabled():
        return
    global_trace_store().enqueue_close(rec, span_close=span_close)
