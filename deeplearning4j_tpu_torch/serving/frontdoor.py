"""HTTP/SSE serving front door: the network wire surface on the router.

The serving stack ended at Python call boundaries — ``ServingRouter``
had no wire surface at all, which is exactly the gap between "a serving
library" and "a server" (the reference DL4J shipped its Vert.x HTTP
serving/UI layer as a first-class product; the TensorFlow system paper,
Abadi et al. arXiv:1605.08695 §9, treats the network serving tier as
part of the system). :class:`FrontDoor` is that tier, built on the same
dependency-free ``ThreadingHTTPServer`` pattern as ``ui/server.py`` but
hardened as a traffic surface:

- ``POST /v1/classify`` — JSON in/out through the router's versioned
  ``output()`` (hash-split rollout, per-version SLOs, drains — the whole
  versioned registry behind one URL).
- ``POST /v1/generate`` — KV-cache generation; with ``"stream": true``
  the response is **server-sent events, one event per token**, emitted
  at the decode step boundary that produced each token (the
  ``on_token`` plumbing through router → pipeline → decode loop). The
  streamed sequence is byte-identical to the non-streamed result for
  the same seed/version; a client that disconnects mid-stream cancels
  its request at the next step boundary — the slot frees, typed as
  ``StreamCancelled``, never leaked.
- **Typed errors map to HTTP statuses**: shed/admission → 429, circuit
  open / shutdown / disabled → 503, deadline → 504, wiring errors →
  400, unknown version → 404, everything else → 500. Per-request
  deadlines ride the body (``deadline_ms``) into the same
  ``Deadline`` machinery the in-process callers use.
- Every response carries the request's causal ``X-Dl4j-Trace-Id``
  header, so a slow HTTP request can be joined against ``/train/trace``
  spans and flight-recorder bundles.
- Admission control: a bounded in-flight gate (``max_inflight``) sheds
  with 429 before a traffic spike can pile threads onto the device
  queues; the ``http.request`` chaos point fires at the door so the
  whole surface is drivable under injected faults.
- **Multi-tenant QoS** (``resilience/qos.py``; kill switch
  ``DL4J_TPU_QOS=0``): the ``X-Dl4j-Tenant`` header names the caller
  (absent = default tenant, behavior unchanged); per-tenant request-
  rate / token-rate quotas are enforced AT the door (typed
  ``QuotaExceeded`` → 429) and the label threads through the router
  into both pipelines' weighted-fair queues. Every 429/503 shed
  response carries a ``Retry-After`` header — quota sheds derive it
  from the tenant's bucket refill time; the in-flight gate and other
  sheds reuse the same surface with a default. ``GET /debug/tenants``
  serves the live tenant table.
- **Multi-process mode**: constructed with a
  :class:`~deeplearning4j_tpu_torch.serving.shared_state.SharedServingState`,
  routing decisions (primary, canary split, stage) come from the shared
  store — N worker processes answer as one fleet — and a background
  sync thread heartbeats, publishes SLO windows, and applies the
  leader's stage transitions (promote/drain) locally.

The port's door (counterpart of ``deeplearning4j_tpu/serving/
frontdoor.py``) serves the generative lane over ``GenerationPipeline``.
The scoring lane's router (``output`` / ``output_on`` over
``ParallelInference``) waits for ROADMAP queue 1 item 8, so a door is
built with ``router=None`` and ``/v1/classify`` answers 404, as the
reference's does when that lane is absent.

Observability: ``dl4j_http_*`` series on ``/metrics``, a ``/debug/
frontdoor`` endpoint (also folded into flight-recorder bundles as
``frontdoor.json`` and mirrored by the UI server), and the live kill
switch ``DL4J_TPU_FRONTDOOR=0`` (resolved per request) that answers 503
on ``/v1/*`` while keeping the debug surfaces up — the "drain this
replica at the load balancer" lever.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch.observability import current_span as _current_span
from deeplearning4j_tpu_torch.observability import federation as _fed
from deeplearning4j_tpu_torch.observability import global_registry, on_registry_reset
from deeplearning4j_tpu_torch.observability import span as _span
from deeplearning4j_tpu_torch.observability import timeseries as _tms
from deeplearning4j_tpu_torch.observability import trace_store as _trace_store
from deeplearning4j_tpu_torch.observability import watchtower as _watchtower
from deeplearning4j_tpu_torch.observability.tracing import (current_context,
                                                      trace_context)
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience import qos as _qos
from deeplearning4j_tpu_torch.resilience.policy import (TYPED_OUTCOMES,
                                                  CircuitOpenError,
                                                  DeadlineExceeded,
                                                  RetryPolicy, ShedError,
                                                  ShutdownError)
from deeplearning4j_tpu_torch.serving import idempotency as _idem
from deeplearning4j_tpu_torch.serving import session as _sess
from deeplearning4j_tpu_torch.serving.errors import RolloutConflictError
from deeplearning4j_tpu_torch.serving.router import request_fraction


def default_bind_host() -> str:
    """``DL4J_TPU_UI_HOST`` — bind host for the serving front door and
    the federation surfaces, with the meaning the reference's UI server
    gives it (``deeplearning4j_tpu/ui/server.py``; the UI server is not
    ported, so the knob's one spelling lives here). Default stays
    loopback: exposing the server off-box is an explicit decision
    (``0.0.0.0``), never an accident."""
    return os.environ.get("DL4J_TPU_UI_HOST", "127.0.0.1")


#: request bodies above this are refused with 413 BEFORE buffering — a
#: hardened door must not let one Content-Length header OOM the process
MAX_BODY_BYTES = 16 << 20

#: the tenant-identity request header (QoS posture; absent = default
#: tenant, behavior unchanged)
TENANT_HEADER = "X-Dl4j-Tenant"

#: the durable-session id header (sessions posture): the proxy pins a
#: stream's session here so its mid-stream failover can name the
#: session a survivor must adopt; responses echo the minted id
SESSION_HEADER = "X-Dl4j-Session-Id"

#: the SSE resume header (standard EventSource semantics): the last
#: ``id:`` the client received — a re-routed stream replays/regenerates
#: everything AFTER it and nothing at or before it (exactly-once)
LAST_EVENT_ID_HEADER = "Last-Event-ID"

#: Retry-After for sheds that carry no quota refill time (the in-flight
#: gate, an open circuit): "come back shortly", not a quota schedule
DEFAULT_RETRY_AFTER_S = 1.0


def retry_after_seconds(exc: Optional[BaseException]) -> float:
    """The Retry-After a shed response should carry: a quota shed knows
    its bucket's refill time (``QuotaExceeded.retry_after_s``); every
    other 429/503 uses the default."""
    v = getattr(exc, "retry_after_s", None)
    try:
        return max(0.0, float(v)) if v is not None else \
            DEFAULT_RETRY_AFTER_S
    except (TypeError, ValueError):
        return DEFAULT_RETRY_AFTER_S


def _retry_after_header(exc: Optional[BaseException] = None):
    """RFC 7231 delta-seconds (integer, >= 1 so a client never busy-
    loops on a sub-second value rounded to 0)."""
    import math
    return ("Retry-After",
            str(max(1, math.ceil(retry_after_seconds(exc)))))


def frontdoor_enabled() -> bool:
    """``DL4J_TPU_FRONTDOOR`` kill switch, resolved LIVE (per request —
    flipping it 503s new traffic without restarting the process; the
    debug/metrics surfaces stay up)."""
    return os.environ.get("DL4J_TPU_FRONTDOOR", "1") != "0"


class BadRequest(ValueError):
    """Malformed request body/params — HTTP 400, never an error-rate
    event (client bugs are not model failures)."""


class PayloadTooLarge(ValueError):
    """Request body over :data:`MAX_BODY_BYTES` — HTTP 413, refused
    before a byte of it is buffered."""


def charges_possible(exc: BaseException) -> bool:
    """Could work that charged the tenant (or emitted tokens) have
    happened before ``exc``?  Drives the idempotency journal's
    resolve-vs-abandon split for typed outcomes: pre-charge rejections
    (quota, queue-full shed, circuit open, shutdown) are abandoned so a
    later retry gets a real attempt; anything that may carry partial
    work (preemption and stream-cancel after partial decode, deadlines,
    device errors) is resolved so a retry replays instead of
    double-charging."""
    if isinstance(exc, _qos.PreemptedError):
        return True
    if type(exc).__name__ == "StreamCancelled":
        return True          # partial tokens were streamed and charged
    if isinstance(exc, (ShedError, CircuitOpenError, ShutdownError)):
        return False
    return True


def http_status(exc: BaseException) -> int:
    """The typed-outcome → HTTP status mapping (one spelling: the JSON
    error path, the SSE error event, and the tests all read this)."""
    if isinstance(exc, (ShedError,)):          # incl. StreamCancelled
        return 429
    if isinstance(exc, DeadlineExceeded):
        return 504
    if isinstance(exc, (CircuitOpenError, ShutdownError)):
        return 503
    if isinstance(exc, KeyError):              # unknown version
        return 404
    if isinstance(exc, RolloutConflictError):  # rollout lifecycle refusal
        return 409
    if isinstance(exc, PayloadTooLarge):
        return 413
    if isinstance(exc, (BadRequest, ValueError, TypeError)):
        return 400
    return 500                                 # device errors, InjectedFault


class _HttpMetrics:
    """Label-bound ``dl4j_http_*`` instruments (registry-reset safe,
    the serving/_GenMetrics pattern)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        reg = global_registry()
        self._requests = reg.counter(
            "dl4j_http_requests_total",
            "front-door HTTP requests answered, by route and status code",
            label_names=("route", "code"))
        self._latency = reg.histogram(
            "dl4j_http_latency_seconds",
            "front-door request wall time from parse to last byte, by "
            "route (streams: until the final SSE event)",
            label_names=("route",))
        self.inflight = reg.gauge(
            "dl4j_http_inflight",
            "front-door requests currently being served (admission gate "
            "sheds above max_inflight)")
        shed = reg.counter(
            "dl4j_http_shed_total",
            "front-door requests shed at the door, by reason",
            label_names=("reason",))
        self.shed = {r: shed.labels(reason=r)
                     for r in ("inflight", "disabled")}
        self.stream_tokens = reg.counter(
            "dl4j_http_stream_tokens_total",
            "tokens emitted over SSE streams (rate = streamed tokens/s "
            "on the wire)")
        self.first_token = reg.histogram(
            "dl4j_http_first_token_seconds",
            "SSE streams: request start to the first token event on the "
            "wire (the latency streaming exists to shrink)")
        self.disconnects = reg.counter(
            "dl4j_http_disconnects_total",
            "clients that went away mid-response (streams cancel at the "
            "next step boundary, slots freed)")

    def requests(self, route: str, code: int):
        return self._requests.labels(route=route, code=str(code))

    def latency(self, route: str):
        return self._latency.labels(route=route)

    @classmethod
    def get(cls) -> "_HttpMetrics":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance


@on_registry_reset
def _drop_http_metrics():
    _HttpMetrics._instance = None


def _route_of(path: str) -> str:
    if path == "/v1/classify":
        return "classify"
    if path == "/v1/generate":
        return "generate"
    if path.startswith("/admin/"):
        return "admin"
    if path.startswith("/debug/") or path in ("/metrics", "/health",
                                              "/metrics/fleet",
                                              "/health/fleet",
                                              "/alerts/fleet"):
        return "debug"
    return "other"


class FrontDoor:
    """One worker's HTTP front door. ``router`` serves the scoring lane
    (``/v1/classify``), ``gen_router`` the generative lane
    (``/v1/generate``); either may be None (the route 404s). With
    ``shared`` set, routing state comes from the shared store (see
    module doc) and a sync thread coordinates with the fleet."""

    _live: "weakref.WeakSet[FrontDoor]" = weakref.WeakSet()

    def __init__(self, router=None, gen_router=None, *, shared=None,
                 host: Optional[str] = None, port: int = 0,
                 max_inflight: int = 64,
                 sync_interval_s: float = 0.25,
                 worker_id: Optional[str] = None,
                 reuse_port: bool = False):
        self.router = router
        self.gen_router = gen_router
        self.shared = shared
        self.worker_id = worker_id or (shared.worker_id if shared else "w0")
        self.host = host
        self.port = int(port)
        self.max_inflight = int(max_inflight)
        self.reuse_port = bool(reuse_port)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._sync_interval = float(sync_interval_s)
        self._sync_stop = threading.Event()
        self._sync_thread: Optional[threading.Thread] = None
        self._started_at = time.time()
        self._fleet_health = None       # lazy federation.FleetHealth
        self._fleet_pub_at = 0.0        # leader rollup publish throttle
        self._fleet_watch = None        # lazy federation.FleetWatch
        self._alerts_pub_at = 0.0       # alert snapshot publish throttle
        FrontDoor._live.add(self)

    # ------------------------------------------------------------- lanes
    def _lane_router(self, lane: str):
        return self.router if lane == "scoring" else self.gen_router

    def classify(self, x, deadline_ms=None, request_key=None,
                 tenant=None):
        """One classify request through whichever routing mode is wired
        (shared store split or the local rollout machinery)."""
        if self.router is None:
            raise KeyError("no scoring deploy behind this front door")
        if self.shared is None:
            return self.router.output(x, deadline_ms=deadline_ms,
                                      request_key=request_key,
                                      tenant=tenant), None
        frac = request_fraction(x, request_key)
        version, canary = self.shared.pick("scoring", frac)
        if version is None:
            raise KeyError("scoring lane has no primary in the shared "
                           "store")
        t0 = time.perf_counter()
        try:
            out = self.router.output_on(version, x, deadline_ms=deadline_ms,
                                        canary=canary, tenant=tenant)
        except Exception as e:
            self.shared.record(version,
                               ok=isinstance(e, TYPED_OUTCOMES),
                               latency_s=time.perf_counter() - t0)
            raise
        self.shared.record(version, ok=True,
                           latency_s=time.perf_counter() - t0)
        return out, version

    def generate(self, prompt, max_new_tokens=None, eos_id=None,
                 deadline_ms=None, request_key=None, on_token=None,
                 tenant=None, session_id=None):
        if self.gen_router is None:
            raise KeyError("no generative deploy behind this front door")
        if self.shared is None:
            return self.gen_router.generate(
                prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                deadline_ms=deadline_ms, request_key=request_key,
                on_token=on_token, tenant=tenant,
                session_id=session_id), None
        frac = request_fraction(prompt, request_key)
        version, canary = self.shared.pick("generative", frac)
        if version is None:
            raise KeyError("generative lane has no primary in the shared "
                           "store")
        t0 = time.perf_counter()
        try:
            out = self.gen_router.generate_on(
                version, prompt, max_new_tokens=max_new_tokens,
                eos_id=eos_id, deadline_ms=deadline_ms, canary=canary,
                on_token=on_token, tenant=tenant, session_id=session_id)
        except Exception as e:
            self.shared.record(version,
                               ok=isinstance(e, TYPED_OUTCOMES),
                               latency_s=time.perf_counter() - t0)
            raise
        self.shared.record(version, ok=True,
                           latency_s=time.perf_counter() - t0)
        return out, version

    def adopt_session(self, sid: str) -> dict:
        """Fence-bump ``sid``'s journaled record to THIS worker (fleet
        failover: the proxy re-routed a dead worker's stream here). The
        ``generation.adopt`` chaos point fires per attempt under the
        standard retry budget — a transient store blip costs a retry,
        not the stream. Raises ``KeyError`` when nothing durable
        exists to adopt."""
        if self.shared is None:
            raise KeyError("session adoption needs the shared store")

        def attempt():
            if _faults.armed():
                _faults.check("generation.adopt")
            return _sess.adopt(self.shared.store, sid, self.worker_id)

        if _faults.resilience_enabled():
            return RetryPolicy(max_retries=2,
                               base_delay_seconds=0.01).call(
                attempt, op="generation.adopt")
        return attempt()

    def resume(self, record: dict, on_token=None, deadline_ms=None,
               tenant=None):
        """Continue an adopted session on this worker's slots: mirror
        the record locally (the continued tokens journal under the
        bumped fence) and re-enter through the pipeline's resume path.
        Returns ``(tokens, version)`` like :meth:`generate`."""
        if self.gen_router is None:
            raise KeyError("no generative deploy behind this front door")
        sess = _sess.global_sessions().adopt_local(record)
        version = record.get("version")
        if self.shared is not None and version is None:
            version, _canary = self.shared.pick("generative", 0.0)
        if version is None:
            raise KeyError("adopted session names no generative version")
        t0 = time.perf_counter()
        try:
            out = self.gen_router.resume_on(
                version, record, on_token=on_token,
                deadline_ms=deadline_ms, tenant=tenant, session=sess)
        except KeyError:
            # the dead worker served a version this one never deployed
            # (mid-rollout death): fall back to the lane primary — the
            # in-graph seed travels in the record, so greedy output is
            # unchanged; a sampled stream continues best-effort
            if self.shared is None:
                raise
            version, _canary = self.shared.pick("generative", 0.0)
            if version is None:
                raise
            out = self.gen_router.resume_on(
                version, record, on_token=on_token,
                deadline_ms=deadline_ms, tenant=tenant, session=sess)
        except Exception as e:
            if self.shared is not None:
                self.shared.record(version,
                                   ok=isinstance(e, TYPED_OUTCOMES),
                                   latency_s=time.perf_counter() - t0)
            raise
        if self.shared is not None:
            self.shared.record(version, ok=True,
                               latency_s=time.perf_counter() - t0)
        return out, version

    # ----------------------------------------------------- shared syncing
    def _apply_event(self, event: dict):
        """Apply one leader transition locally: FULL → repoint this
        worker's lane router and gracefully drain the old incumbent;
        ROLLED_BACK → drain the local candidate. Errors are absorbed
        (a version this worker never deployed is not its transition)."""
        lane = event.get("lane")
        router = self._lane_router(lane or "")
        if router is None:
            return
        registry = router._registry
        try:
            if event.get("to") == "full":
                router.repoint(event["candidate"])
                old = event.get("old_primary")
                if old and old != event["candidate"]:
                    registry.retire(old)
            elif event.get("to") == "rolled_back":
                cand = event.get("candidate")
                if cand:
                    registry.retire(cand)
        except Exception:  # graftlint: disable=typed-errors — replaying a
            pass           # shared-store event is best-effort; no request
                           # outcome flows through this handler

    def sync_once(self):
        """One shared-store beat (the background thread's body; tests
        and single-stepped drills call it directly)."""
        if self.shared is None:
            return []
        events = self.shared.sync()
        for e in events:
            self._apply_event(e)
        return events

    def _sync_loop(self):
        while not self._sync_stop.wait(self._sync_interval):
            try:
                self.sync_once()
            # graftlint: disable=typed-errors — coordination must never
            # kill the serving process; the next beat retries
            except Exception:
                # (store contention, transient fs)
                pass
            try:
                self._fleet_obs_beat()
            # graftlint: disable=typed-errors — the observability plane
            # must never kill the serving process; the next beat retries
            except Exception:
                pass

    def _fleet_health_view(self):
        """This worker's federated health engine (lazy: built on first
        ``/health/fleet`` or leader rollup; only valid in shared mode)."""
        if self._fleet_health is None:
            self._fleet_health = _fed.FleetHealth(self.shared.store,
                                                  worker_id=self.worker_id)
        return self._fleet_health

    def _fleet_watch_view(self):
        """The LEADER's fleet-level watchtower (lazy; wraps the same
        federated health view so detectors read one scrape shape)."""
        if self._fleet_watch is None:
            self._fleet_watch = _fed.FleetWatch(self._fleet_health_view())
        return self._fleet_watch

    def _maybe_publish_alerts(self):
        """This worker's watchtower alert snapshot into the shared
        store, throttled to the health interval; the LEADER also beats
        the fleet-level detectors and publishes their rollup."""
        if not _tms.watchtower_enabled():
            return
        now = time.monotonic()
        if now - self._alerts_pub_at < _fed.health_interval_s():
            return
        self._alerts_pub_at = now
        fleet = None
        term = None
        if self.shared.is_leader:
            fw = self._fleet_watch_view()
            fw.beat()
            fleet = fw.snapshot()
            term = self.shared.leader_term
        _fed.publish_alerts(self.shared.store, self.worker_id, term,
                            _watchtower.global_watchtower().snapshot(),
                            fleet=fleet,
                            is_leader=self.shared.is_leader)

    def _fleet_obs_beat(self):
        """One beat of the fleet observability plane (rides the sync
        loop; tests single-step it directly): beat the local watchtower
        (its own live kill switch + interval throttle — a page firing
        here pins traces and dumps the bundle the incident publisher
        fans out), run the incident fan-out protocol, publish this
        worker's alert snapshot, and — on the LEADER only, throttled to
        ``DL4J_TPU_FLEET_HEALTH_INTERVAL_S`` — publish the fleet health
        rollup into the shared store so every worker's ``/debug/fleet``
        shows one consistent verdict."""
        if self.shared is None:
            return
        _watchtower.global_watchtower().beat()
        if not _fed.fleet_obs_enabled():
            return
        _fed.incident_beat(self.shared.store, self.worker_id,
                           self.shared.is_leader)
        self._maybe_publish_alerts()
        if not self.shared.is_leader:
            return
        now = time.monotonic()
        if now - self._fleet_pub_at < _fed.health_interval_s():
            return
        self._fleet_pub_at = now
        _fed.publish_rollup(self.shared.store, self.worker_id,
                            self.shared.leader_term,
                            self._fleet_health_view().evaluate())

    # -------------------------------------------------------------- serve
    def start(self) -> "FrontDoor":
        fd = self
        if self.shared is not None and _sess.sessions_enabled():
            # arm the session journal under this worker's lease: batched
            # step-boundary writes into the same shared store the fleet
            # plane rides (one daemon thread; kill switch leaves the
            # journal detached and every session surface inert)
            _sess.global_journal().attach(self.shared.store,
                                          self.worker_id)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # quiet, like the UI server
                pass

            # ------------------------------------------------- plumbing
            def _tid(self):
                """This request's trace id: captured inside the span
                (so ERROR replies emitted after it closed still carry
                it), falling back to any live ambient context.  The
                fallback is gated on the fleet plane — the pre-plane
                span site still opens an http_request span when the
                switch is OFF, and its ambient context must not leak a
                header onto byte-identical pre-plane responses."""
                tid = getattr(self, "_trace_id", None)
                if tid is not None:
                    return tid
                if not _fed.fleet_obs_enabled():
                    return None
                ctx = current_context()
                return ctx.trace_id if ctx is not None else None

            def _finish_idem(self, code: int, payload: dict, exc=None):
                """Journal this request's final outcome under its
                idempotency key (once): outcomes reached after execution
                began resolve (a retry replays); pre-charge rejections
                abandon (a retry gets a real attempt)."""
                key = getattr(self, "_idem_key", None)
                if key is None:
                    return
                self._idem_key = None
                journal = _idem.global_journal()
                if (getattr(self, "_idem_executing", False)
                        and (exc is None or charges_possible(exc))):
                    journal.resolve(key, code, payload)
                else:
                    journal.abandon(key)

            def _reply(self, code: int, payload: dict, route: str,
                       t0: float, extra_headers=()):
                self._finish_idem(code, payload)
                if _trace_store.trace_store_enabled():
                    # the retention rules read the ROOT span's attrs:
                    # typed errors are caught INSIDE the http_request
                    # span (it exits cleanly), so the status must ride
                    # on the span for tail-based keep/drop to see it
                    sp = _current_span()
                    if sp is not None:
                        sp.set_attr("status", code)
                        tenant = getattr(self, "_tenant", None)
                        if tenant is not None:
                            sp.set_attr("tenant", tenant)
                body = json.dumps(payload, default=str).encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    tid = self._tid()
                    if tid is not None:
                        self.send_header("X-Dl4j-Trace-Id", str(tid))
                    for k, v in extra_headers:
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    _HttpMetrics.get().disconnects.inc()
                obs = _HttpMetrics.get()
                obs.requests(route, code).inc()
                obs.latency(route).observe(time.perf_counter() - t0)

            def _error(self, exc: BaseException, route: str, t0: float):
                code = http_status(exc)
                payload = {"error": type(exc).__name__,
                           "detail": str(exc)}
                if _trace_store.trace_store_enabled():
                    sp = _current_span()
                    if sp is not None:
                        sp.set_attr("error_type", type(exc).__name__)
                self._finish_idem(code, payload, exc=exc)
                headers = ()
                if code in (429, 503):
                    # every shed response tells the client when to come
                    # back: quota sheds derive it from the tenant's
                    # bucket refill time, the rest use the default
                    headers = (_retry_after_header(exc),)
                    payload["retry_after_s"] = round(
                        retry_after_seconds(exc), 3)
                self._reply(code, payload, route, t0,
                            extra_headers=headers)

            def _serve_replay(self, entry, route: str, t0: float):
                """A retried idempotency key: wait for the original's
                resolution (immediate when already done) and return THE
                original outcome — nothing executes, nothing is charged."""
                try:
                    body = self._read_json()     # drain + stream flag
                except Exception as e:
                    self._error(e, route, t0)
                    return
                outcome = _idem.global_journal().await_outcome(entry)
                if outcome is None:
                    # original still executing past the bounded wait (or
                    # the key was abandoned mid-wait): come back shortly
                    self._reply(503, {
                        "error": "IdempotentInFlight",
                        "detail": "the original request under this "
                                  "idempotency key is still executing",
                        "retry_after_s": DEFAULT_RETRY_AFTER_S},
                        route, t0,
                        extra_headers=(_retry_after_header(),))
                    return
                code, payload = outcome
                if (body.get("stream") and code == 200
                        and isinstance(payload.get("tokens"), list)):
                    self._replay_stream(payload, route, t0)
                    return
                self._reply(code, payload, route, t0,
                            extra_headers=((_idem.REPLAY_HEADER, "1"),))

            def _replay_stream(self, payload: dict, route: str,
                               t0: float):
                """Replay a journaled stream outcome as SSE: the same
                token events the original emitted, from the journal."""
                obs = _HttpMetrics.get()
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header(_idem.REPLAY_HEADER, "1")
                    tid = self._tid()
                    if tid is not None:
                        self.send_header("X-Dl4j-Trace-Id", str(tid))
                    self.end_headers()
                    for i, tok in enumerate(payload["tokens"]):
                        self.wfile.write(
                            (f"event: token\ndata: "
                             f"{json.dumps({'index': i, 'token': int(tok)})}"
                             f"\n\n").encode())
                    self.wfile.write(("event: done\ndata: "
                                      + json.dumps(payload)
                                      + "\n\n").encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    obs.disconnects.inc()
                obs.requests("stream", 200).inc()
                obs.latency("stream").observe(time.perf_counter() - t0)

            def _read_json(self) -> dict:
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n > MAX_BODY_BYTES:
                    raise PayloadTooLarge(
                        f"body of {n} bytes exceeds the "
                        f"{MAX_BODY_BYTES}-byte limit")
                raw = self.rfile.read(n) if n > 0 else b"{}"
                try:
                    doc = json.loads(raw or b"{}")
                except ValueError as e:
                    raise BadRequest(f"body is not JSON: {e}")
                if not isinstance(doc, dict):
                    raise BadRequest("body must be a JSON object")
                return doc

            def _send_text(self, body: bytes, route: str):
                """Plain-text 200 (the Prometheus exposition paths).
                With the fleet plane off ``self._trace_id`` is None and
                the bytes on the wire are identical to the pre-
                federation ``/metrics`` writer."""
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                tid = getattr(self, "_trace_id", None)
                if tid is not None:
                    self.send_header("X-Dl4j-Trace-Id", str(tid))
                self.end_headers()
                self.wfile.write(body)
                _HttpMetrics.get().requests(route, 200).inc()

            # --------------------------------------------------- routes
            def do_POST(self):
                path = urlparse(self.path).path
                route = _route_of(path)
                t0 = time.perf_counter()
                self._trace_id = None
                self._obs_ctx = None
                if _fed.fleet_obs_enabled():
                    # fleet plane: join the caller's trace (or pre-
                    # allocate a root id) BEFORE the early exits, so
                    # EVERY response path — 404, disabled-503, quota/
                    # inflight-429, idempotent replay — carries
                    # X-Dl4j-Trace-Id
                    self._obs_ctx = _fed.inbound_context(self.headers)
                    self._trace_id = self._obs_ctx.trace_id
                self._idem_key = None
                self._idem_executing = False
                obs = _HttpMetrics.get()
                if path not in ("/v1/classify", "/v1/generate",
                                "/admin/rollout", "/admin/rollback"):
                    self._reply(404, {"error": "NotFound", "path": path},
                                route, t0)
                    return
                if path.startswith("/v1/") and not frontdoor_enabled():
                    obs.shed["disabled"].inc()
                    self._reply(503, {"error": "FrontDoorDisabled",
                                      "detail": "DL4J_TPU_FRONTDOOR=0"},
                                route, t0,
                                extra_headers=(_retry_after_header(),))
                    return
                # idempotent retries: a known key replays its journaled
                # outcome (or attaches to the in-flight original) BEFORE
                # quota/admission — a replay executes nothing, spends no
                # quota, and charges no token debt (exactly-once per key)
                if (path in ("/v1/classify", "/v1/generate")
                        and _idem.idempotency_enabled()):
                    key = self.headers.get(_idem.IDEMPOTENCY_HEADER)
                    if key:
                        entry, state = _idem.global_journal().begin(key)
                        if entry is not None and state != _idem.NEW:
                            self._serve_replay(entry, route, t0)
                            return
                        if entry is not None:
                            self._idem_key = key
                # tenant identity + quota admission (QoS posture; the
                # kill switch leaves self._tenant None — the header is
                # inert and no tenant series are touched)
                self._tenant = None
                if path.startswith("/v1/") and _qos.qos_enabled():
                    tenants = _qos.global_tenants()
                    try:
                        self._tenant = tenants.admit(
                            self.headers.get(TENANT_HEADER))
                    except _qos.QuotaExceeded as e:
                        # quota sheds are still per-tenant traffic: the
                        # requests denominator must see a 100% -over-
                        # quota tenant, not read it as "no traffic, ok"
                        tenants.observe_request(
                            e.tenant, time.perf_counter() - t0, e)
                        self._error(e, route, t0)
                        return
                admitted = False
                if path.startswith("/v1/"):
                    with fd._inflight_lock:
                        if fd._inflight >= fd.max_inflight:
                            obs.shed["inflight"].inc()
                        else:
                            fd._inflight += 1
                            admitted = True
                            obs.inflight.set(fd._inflight)
                    if not admitted:
                        # the in-flight gate's shed reuses the same
                        # Retry-After surface as the quota path
                        self._reply(429, {
                            "error": "ShedError",
                            "detail": f"front door at max_inflight="
                                      f"{fd.max_inflight}",
                            "retry_after_s": DEFAULT_RETRY_AFTER_S},
                            route, t0,
                            extra_headers=(_retry_after_header(),))
                        return
                try:
                    # trace_context(None) is effect-free, so with the
                    # fleet plane off this line is byte-identical to the
                    # pre-federation span site; with it on, the root
                    # span's trace/parent ids are the CALLER's
                    with trace_context(self._obs_ctx), \
                            _span("http_request", route=route):
                        # capture the id while the span is OPEN: error
                        # replies run after it closes and must still
                        # carry the header (the join-to-traces contract
                        # matters MOST for failing requests).  Gated on
                        # the plane being ON — the span exists either
                        # way, but with DL4J_TPU_FLEET_OBS=0 no header
                        # may leak (byte-identical pre-plane responses)
                        if self._obs_ctx is not None:
                            ctx = current_context()
                            self._trace_id = (ctx.trace_id
                                              if ctx is not None
                                              else self._trace_id)
                        try:
                            if _faults.armed():
                                _faults.check("http.request")
                            body = self._read_json()
                            if (self._idem_key is not None
                                    and path in ("/v1/classify",
                                                 "/v1/generate")):
                                # past here, ANY outcome may carry
                                # charged work: journal it, never
                                # re-execute a retried key
                                self._idem_executing = True
                                _idem.global_journal().mark_executing(
                                    self._idem_key)
                            if path == "/v1/classify":
                                self._classify(body, route, t0)
                            elif path == "/v1/generate":
                                self._generate(body, route, t0)
                            elif path == "/admin/rollout":
                                self._rollout(body, route, t0)
                            else:
                                self._rollback(body, route, t0)
                        except Exception as e:
                            self._error(e, route, t0)
                finally:
                    if admitted:
                        with fd._inflight_lock:
                            fd._inflight -= 1
                            obs.inflight.set(fd._inflight)

            def _classify(self, body: dict, route: str, t0: float):
                if "inputs" not in body:
                    raise BadRequest("missing 'inputs'")
                try:
                    x = np.asarray(body["inputs"], dtype="f4")
                except (ValueError, TypeError) as e:
                    raise BadRequest(f"inputs not numeric: {e}")
                out, version = fd.classify(
                    x, deadline_ms=body.get("deadline_ms"),
                    request_key=body.get("request_key"),
                    tenant=self._tenant)
                payload = {"outputs": np.asarray(out).tolist(),
                           "worker": fd.worker_id}
                if version is not None:
                    payload["version"] = version
                self._reply(200, payload, route, t0)

            def _parse_generate(self, body: dict):
                if "prompt" not in body:
                    raise BadRequest("missing 'prompt'")
                try:
                    prompt = np.asarray(body["prompt"],
                                        np.int32).reshape(-1)
                except (ValueError, TypeError) as e:
                    raise BadRequest(f"prompt not integral: {e}")
                mnt = body.get("max_new_tokens")
                return prompt, (int(mnt) if mnt is not None else None)

            def _generate(self, body: dict, route: str, t0: float):
                prompt, mnt = self._parse_generate(body)
                kw = dict(max_new_tokens=mnt, eos_id=body.get("eos_id"),
                          deadline_ms=body.get("deadline_ms"),
                          request_key=body.get("request_key"),
                          tenant=self._tenant)
                sid = None
                if _sess.sessions_enabled():
                    last = self.headers.get(LAST_EVENT_ID_HEADER)
                    sid = (self.headers.get(SESSION_HEADER)
                           or body.get("session_id"))
                    if (body.get("stream") and last is not None
                            and sid and fd.shared is not None):
                        # fleet failover re-entry: the proxy re-routed a
                        # mid-stream death here with the session id and
                        # the last event id its client received
                        self._resume_stream(sid, last, kw, t0)
                        return
                    sid = sid or _sess.new_session_id()
                    kw["session_id"] = sid
                if body.get("stream"):
                    self._generate_stream(prompt, kw, t0, sid=sid)
                    return
                out, version = fd.generate(prompt, **kw)
                payload = {"tokens": np.asarray(out).tolist(),
                           "worker": fd.worker_id}
                if sid is not None:
                    payload["session"] = sid
                if version is not None:
                    payload["version"] = version
                self._reply(200, payload, route, t0)

            def _resume_stream(self, sid: str, last: str, kw: dict,
                               t0: float):
                """Adopt ``sid`` from the store (lease-fenced) and
                continue its stream from the client's ``Last-Event-ID``:
                the journal's token log replays through the same queue,
                the pipeline regenerates the rest, and the dedup window
                drops every index the client already has — exactly-once
                across the failover."""
                try:
                    last_seq = int(last)
                except (TypeError, ValueError):
                    last_seq = -1
                record = fd.adopt_session(sid)
                tenant = self._tenant or record.get("tenant")
                run_ctx = current_context()

                def runner(on_token):
                    with trace_context(run_ctx):
                        return fd.resume(
                            record, on_token=on_token,
                            deadline_ms=kw.get("deadline_ms"),
                            tenant=tenant)

                self._stream_sse(runner, t0, sid=sid, last_seq=last_seq)

            def _generate_stream(self, prompt, kw: dict, t0: float,
                                 sid=None):
                run_ctx = current_context()

                def runner(on_token):
                    # the generation runs on a worker thread: hand the
                    # HTTP request's trace context across so the
                    # pipeline's spans join the SAME trace id the
                    # response header names
                    with trace_context(run_ctx):
                        return fd.generate(prompt, on_token=on_token,
                                           **kw)

                self._stream_sse(runner, t0, sid=sid)

            def _stream_sse(self, runner, t0: float, sid=None,
                            last_seq: int = -1):
                """SSE per-token streaming. The decode thread hands each
                token to a bounded queue via ``on_token`` (never touching
                the socket); this handler thread drains it onto the wire.
                A write failure (client gone) flips ``dead`` — the next
                callback returns False and the pipeline frees the slot
                at the step boundary (typed ``StreamCancelled``).

                With a session (``sid``), every token event carries its
                sequence number as the SSE ``id:`` field — the resume
                contract — and tokens at or below ``last_seq`` are
                dropped before the queue (the failover dedup window).
                With sessions off both are inert and the bytes on the
                wire are identical to the pre-session stream."""
                obs = _HttpMetrics.get()
                q: "queue.Queue" = queue.Queue(maxsize=4096)
                dead = threading.Event()

                def on_token(tok, idx):
                    if dead.is_set():
                        return False
                    if idx <= last_seq:
                        return True        # client already has it
                    try:
                        q.put_nowait((idx, int(tok)))
                    except queue.Full:
                        return False       # pathologically slow consumer
                    return True

                result: dict = {}

                def run():
                    try:
                        out, version = runner(on_token)
                        result["tokens"] = np.asarray(out).tolist()
                        result["version"] = version
                    # graftlint: disable=typed-errors — resolved by
                    # transport: the stored error is re-raised to the
                    # HTTP caller via the SSE error event / status map
                    except BaseException as e:
                        result["error"] = e
                    finally:
                        q.put(None)

                threading.Thread(target=run, daemon=True,
                                 name="dl4j-frontdoor-gen").start()
                # block for the FIRST token (or resolution) before
                # committing to SSE: a request that dies at the door —
                # shed, expired, unknown version — answers its real
                # HTTP status, not a 200 stream with an error event
                first_item = q.get()
                if first_item is None:
                    err = result.get("error")
                    if err is not None:
                        raise err
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                tid = self._tid()
                if tid is not None:
                    self.send_header("X-Dl4j-Trace-Id", str(tid))
                if sid is not None:
                    self.send_header(SESSION_HEADER, str(sid))
                self.end_headers()

                def emit(text: str) -> bool:
                    if dead.is_set():
                        return False
                    try:
                        self.wfile.write(text.encode())
                        self.wfile.flush()
                        return True
                    except (BrokenPipeError, ConnectionResetError,
                            OSError):
                        dead.set()
                        obs.disconnects.inc()
                        return False

                first_at = None
                item = first_item
                while item is not None:            # None = resolution
                    if item is not False:          # False = keepalive tick
                        idx, tok = item
                        # the SSE id: field IS the seq number — an
                        # EventSource (or the proxy's failover relay)
                        # resumes with Last-Event-ID = the last id seen
                        prefix = (f"id: {idx}\n" if sid is not None
                                  else "")
                        if emit(f"{prefix}event: token\ndata: "
                                f"{json.dumps({'index': idx, 'token': tok})}"
                                f"\n\n"):
                            obs.stream_tokens.inc()
                            if first_at is None:
                                first_at = time.perf_counter()
                                obs.first_token.observe(first_at - t0)
                    try:
                        item = q.get(timeout=1.0)
                    except queue.Empty:
                        emit(": keepalive\n\n")    # forces disconnect
                        item = False               # detection when idle
                err = result.get("error")
                code = 200
                if err is not None and _trace_store.trace_store_enabled():
                    # streams bypass _reply/_error: stamp the root span
                    # here so a failed stream is tail-retained too
                    sp = _current_span()
                    if sp is not None:
                        sp.set_attr("status", http_status(err))
                        sp.set_attr("error_type", type(err).__name__)
                if err is not None:
                    err_payload = {"error": type(err).__name__,
                                   "detail": str(err),
                                   "status": http_status(err)}
                    self._finish_idem(http_status(err), err_payload,
                                      exc=err)
                    if not dead.is_set():
                        code = err_payload["status"]
                        emit("event: error\ndata: "
                             + json.dumps(err_payload) + "\n\n")
                else:
                    done = {"tokens": result.get("tokens"),
                            "n": len(result.get("tokens") or ()),
                            "worker": fd.worker_id}
                    if sid is not None:
                        done["session"] = sid
                    if result.get("version") is not None:
                        done["version"] = result["version"]
                    self._finish_idem(200, done)
                    emit("event: done\ndata: " + json.dumps(done) + "\n\n")
                obs.requests("stream", code).inc()
                obs.latency("stream").observe(time.perf_counter() - t0)

            def _rollout(self, body: dict, route: str, t0: float):
                lane = body.get("lane", "scoring")
                candidate = body.get("candidate")
                if not candidate:
                    raise BadRequest("missing 'candidate'")
                if fd.shared is not None:
                    fd.shared.begin_rollout(lane, candidate,
                                            body.get("policy"))
                    self._reply(200, fd.shared.routing(lane), route, t0)
                    return
                router = fd._lane_router(lane)
                if router is None:
                    raise KeyError(f"no {lane} router on this front door")
                from deeplearning4j_tpu_torch.serving.rollout import RolloutPolicy
                policy = RolloutPolicy(**(body.get("policy") or {}))
                ro = router.begin_rollout(candidate, policy)
                self._reply(200, ro.snapshot(), route, t0)

            def _rollback(self, body: dict, route: str, t0: float):
                lane = body.get("lane", "scoring")
                reason = body.get("reason", "manual")
                if fd.shared is not None:
                    fd.shared.rollback(lane, reason)
                    self._reply(200, fd.shared.routing(lane), route, t0)
                    return
                router = fd._lane_router(lane)
                if router is None or router.rollout is None:
                    raise KeyError(f"no active {lane} rollout")
                router.rollout.rollback(reason)
                self._reply(200, router.snapshot(), route, t0)

            def do_GET(self):
                path = urlparse(self.path).path
                route = _route_of(path)
                t0 = time.perf_counter()
                self._trace_id = None
                fleet_on = _fed.fleet_obs_enabled()
                if fleet_on:
                    # same join-at-the-door as do_POST: a caller-
                    # supplied id echoes on every GET path too
                    self._trace_id = _fed.inbound_context(
                        self.headers).trace_id
                try:
                    if path == "/debug/frontdoor":
                        self._reply(200, fd.snapshot(), route, t0)
                    elif path == "/debug/fleet":
                        # the fleet robustness view: lease/term state,
                        # demotions, store-corruption/rebuild evidence,
                        # and the idempotency journal (the chaos drill's
                        # duplicate-execution audit surface)
                        self._reply(200, fleet_snapshot(), route, t0)
                    elif path == "/debug/tenants":
                        # tenant policies, quota bucket levels, and
                        # per-tenant lifetime counters — the multi-
                        # tenant QoS view of this worker
                        self._reply(200, _qos.snapshot(), route, t0)
                    elif path == "/debug/sessions":
                        # durable generation sessions: the in-memory
                        # ring, journal watermarks, fences — the
                        # failover drill's adoption audit surface
                        self._reply(200, _sess.snapshot(), route, t0)
                    elif path == "/metrics":
                        from deeplearning4j_tpu_torch.observability import metrics
                        body = metrics().render_prometheus().encode()
                        self._send_text(body, route)
                    elif (path == "/metrics/fleet" and fleet_on
                          and fd.shared is not None):
                        # the federated scrape: every live worker's
                        # series with a `worker` label plus this
                        # process's own — partial (200) when a peer is
                        # unreachable, never a 500 because one died
                        body = _fed.render_fleet(
                            fd.shared.store,
                            local_worker=fd.worker_id).encode()
                        self._send_text(body, route)
                    elif (path == "/health/fleet" and fleet_on
                          and fd.shared is not None):
                        from deeplearning4j_tpu_torch.observability.slo import (
                            FAILING)
                        report = fd._fleet_health_view().evaluate()
                        self._reply(
                            503 if report["status"] == FAILING else 200,
                            report, route, t0)
                    elif (path == "/alerts/fleet" and fleet_on
                          and fd.shared is not None):
                        self._reply(200, fd._fleet_health_view().alerts(),
                                    route, t0)
                    elif (path == "/debug/alerts"
                          and _tms.watchtower_enabled()):
                        # the unified alert surface: legacy SLO keys +
                        # watchtower lifecycle + (fleet mode) the store
                        # rollup with honest `partial` on dead workers
                        q = parse_qs(urlparse(self.path).query)
                        code, payload = _fed.handle_alerts_route(
                            path, q,
                            store=(fd.shared.store
                                   if fd.shared is not None else None),
                            local_worker=fd.worker_id,
                            fleet=fleet_on and fd.shared is not None)
                        self._reply(code, payload, route, t0)
                    elif (path == "/debug/timeseries"
                          and _tms.watchtower_enabled()):
                        # the minutes BEFORE the trip: ringed registry
                        # samples (?name=<prefix>&last=N)
                        q = parse_qs(urlparse(self.path).query)
                        self._reply(200, _tms.timeseries_payload(
                            q, local_worker=fd.worker_id), route, t0)
                    elif (path.startswith("/debug/trace")
                            and _trace_store.trace_store_enabled()):
                        # trace intelligence: retained traces with
                        # why-kept reasons, and any retained id
                        # assembled into a cross-worker waterfall
                        # (fan-out exactly like /metrics/fleet; the
                        # ?local=1 form peers scrape stays local)
                        q = parse_qs(urlparse(self.path).query)
                        code, payload = _fed.handle_trace_route(
                            path, q,
                            store=(fd.shared.store
                                   if fd.shared is not None else None),
                            local_worker=fd.worker_id,
                            fleet=fleet_on and fd.shared is not None)
                        self._reply(code, payload, route, t0)
                    elif path == "/health":
                        from deeplearning4j_tpu_torch.observability.slo import (
                            FAILING, global_slo_engine)
                        report = global_slo_engine().evaluate()
                        self._reply(
                            503 if report["status"] == FAILING else 200,
                            {"status": report["status"],
                             "failing_rules": report["failing_rules"],
                             "degraded_rules": report["degraded_rules"],
                             "worker": fd.worker_id,
                             "uptime_seconds": round(
                                 time.time() - fd._started_at, 3)},
                            route, t0)
                    else:
                        self._reply(404, {"error": "NotFound",
                                          "path": path}, route, t0)
                except Exception as e:
                    self._error(e, route, t0)

        host = self.host if self.host is not None else default_bind_host()
        if self.reuse_port:
            # kernel-level scale-out (tools/serve.py --reuseport): every
            # worker binds the SAME port; the kernel spreads accepts
            import socket as _socket
            self._httpd = ThreadingHTTPServer((host, self.port), Handler,
                                              bind_and_activate=False)
            self._httpd.socket.setsockopt(
                _socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1)
            self._httpd.server_bind()
            self._httpd.server_activate()
        else:
            self._httpd = ThreadingHTTPServer((host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.host = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="dl4j-frontdoor-http")
        self._thread.start()
        if self.shared is not None:
            # wire this worker's flight recorder into the coordinated-
            # capture protocol (the hook itself checks the live
            # DL4J_TPU_FLEET_OBS switch, so installing is inert when off)
            _fed.install_incident_publisher(self.shared.store,
                                            self.worker_id)
            self._sync_thread = threading.Thread(
                target=self._sync_loop, daemon=True,
                name="dl4j-frontdoor-sync")
            self._sync_thread.start()
        return self

    def stop(self):
        self._sync_stop.set()
        if self._sync_thread is not None:
            self._sync_thread.join(timeout=5.0)
            self._sync_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def get_address(self) -> str:
        host = self.host or "127.0.0.1"
        if host == "0.0.0.0":
            host = "127.0.0.1"
        return f"http://{host}:{self.port}"

    # ------------------------------------------------------------ queries
    def snapshot(self) -> dict:
        out = {
            "worker_id": self.worker_id,
            "address": (self.get_address()
                        if self._httpd is not None else None),
            "enabled": frontdoor_enabled(),
            "mode": "shared" if self.shared is not None else "local",
            "inflight": self._inflight,
            "max_inflight": self.max_inflight,
            "uptime_seconds": round(time.time() - self._started_at, 3),
            "scoring": (self.router.snapshot()
                        if self.router is not None else None),
            "generative": (self.gen_router.snapshot()
                           if self.gen_router is not None else None),
        }
        if self.shared is not None:
            out["shared"] = self.shared.snapshot()
        return out


def snapshot_all() -> dict:
    """Every live front door's state — the ``/debug/frontdoor`` payload
    on the UI server and ``frontdoor.json`` in flight-recorder bundles."""
    return {"enabled": frontdoor_enabled(),
            "frontdoors": [f.snapshot() for f in list(FrontDoor._live)
                           if f._httpd is not None]}


def fleet_snapshot() -> dict:
    """The ``/debug/fleet`` payload (also ``fleet.json`` in flight-
    recorder bundles): lease-fenced leadership state (term, holder,
    demotions), store corruption/rebuild evidence, and the idempotency
    journal with per-key execution counts — the fleet chaos drill's
    audit surface for "zero duplicate executions, strictly monotonic
    terms"."""
    from deeplearning4j_tpu_torch.serving import shared_state as _ss
    doors = []
    for f in list(FrontDoor._live):
        if f._httpd is None:
            continue
        doors.append({
            "worker_id": f.worker_id,
            "address": f.get_address(),
            "shared": (f.shared.snapshot()
                       if f.shared is not None else None),
        })
    out = {
        "fence_enabled": _ss.fleet_fence_enabled(),
        "idempotency": _idem.snapshot(),
        "frontdoors": doors,
    }
    if _fed.fleet_obs_enabled():
        # the leader-published rollup and the incident ledger: ONE
        # consistent fleet verdict, whichever worker answered this GET
        for f in list(FrontDoor._live):
            if f.shared is None or f._httpd is None:
                continue
            try:
                doc = f.shared.store.read()
            # graftlint: disable=typed-errors — a torn store read must
            # not break the debug surface; the base payload stands
            except Exception:
                break
            out["fleet_health"] = doc.get("fleet_health")
            out["incidents"] = doc.get("incidents") or []
            if _tms.watchtower_enabled():
                # the published alert rollup (leader fleet verdict +
                # per-worker snapshots) — key absent with the
                # watchtower off, byte-identical to pre-watchtower
                out["alerts"] = doc.get("alerts")
            break
    return out
