#!/usr/bin/env python
"""Multi-process generative serving: N front-door workers, one version set.

``python -m deeplearning4j_tpu_torch.tools.serve --workers 2 --port 8080
--state-dir /tmp/fleet`` spawns N worker processes, each a full serving
stack on the card — the demo generative deploy with warm-up, a
:class:`FrontDoor` bound to an ephemeral port, and a
:class:`SharedServingState` handle on the file-backed store — plus a
small proxy on ``--port`` that spreads client connections across the
live workers. Counterpart of the reference's ``tools/serve.py``. The
pieces:

- **Shared store** (``--state-dir``): registry/rollout/drain state every
  worker agrees on. A canary started on ANY worker
  (``POST /admin/rollout``) hash-splits identically on all of them; the
  leader grades fleet-aggregated SLO windows and advances/rolls back the
  shared stage; every worker applies promotions/drains locally.
- **Proxy** (default): the HTTP-aware proxy with health ejection,
  idempotent connect-failover and mid-stream session failover (a
  SIGKILLed worker's SSE streams resume on a survivor, which adopts the
  journaled session and continues it from ``Last-Event-ID``); with
  ``DL4J_TPU_IDEMPOTENCY=0`` a plain TCP splice with connect-failover.
  ``--reuseport`` instead binds every worker to ``--port`` with
  ``SO_REUSEPORT`` and lets the kernel spread accepts (no proxy hop).
- **Respawn**: the parent monitors children and respawns a dead worker
  under its old worker id; the respawned process reads the store at
  startup and rejoins the rollout at its CURRENT stage.

Workers run on the card (``--device`` defaults to ``cuda``; the CPU
serves only when asked, ``--device cpu``). They serve the reference
demo's generative ``g1`` (a ``TransformerLM`` of vocab 61, 2 layers,
d_model 32, random weights from seed 0; :func:`demo_engine`). The
reference's scoring ``v1``/``v2`` serve DL4J networks through
``ParallelInference`` and wait for it (ROADMAP queue 1 item 8). Real
deployments embed :class:`FrontDoor` + :class:`SharedServingState`
directly.

With ``DL4J_TPU_LAUNCH_COUNTS_DIR`` set, each worker zeroes the port's
kernel launch counters after its warm-up and, when stopped, writes them
to ``<dir>/<worker id>.json``: what its own serving launched.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


#: a directory: each worker stopped by SIGTERM or SIGINT writes its kernel
#: launches since its warm-up there, as ``<worker id>.json``
LAUNCH_COUNTS_ENV = "DL4J_TPU_LAUNCH_COUNTS_DIR"


def _fleet_obs_on() -> bool:
    """The fleet observability plane's kill switch, read LIVE and
    without importing the package — with ``DL4J_TPU_FLEET_OBS=0`` the
    proxy's wire path stays byte-identical to the pre-federation code
    (no spans, no header injection, no admin server)."""
    return os.environ.get("DL4J_TPU_FLEET_OBS", "1") != "0"


def _sessions_on() -> bool:
    """The durable-session kill switch (``DL4J_TPU_SESSIONS=0``), read
    LIVE and without importing the serving package — when off the
    proxy's response pump stays byte-identical to the pre-session
    code (no SSE parsing, no mid-stream failover)."""
    return os.environ.get("DL4J_TPU_SESSIONS", "1") != "0"


class _SseTail:
    """Line scanner over relayed SSE bytes: tracks the last ``id:``
    the client has been sent and whether a terminal ``event: done`` /
    ``event: error`` closed the stream.  Fed the exact bytes the proxy
    forwards, so ``last_id`` is precisely what a resuming request may
    assert via ``Last-Event-ID`` (the survivor worker dedups the
    overlap window against it — exactly-once delivery)."""

    def __init__(self):
        self._buf = b""
        self.last_id = -1
        self.terminal = False

    def feed(self, data: bytes) -> None:
        self._buf += data
        while b"\n" in self._buf:
            line, _, self._buf = self._buf.partition(b"\n")
            line = line.strip()
            if line.startswith(b"id:"):
                try:
                    self.last_id = int(line[3:].strip())
                except ValueError:
                    pass
            elif line in (b"event: done", b"event: error"):
                self.terminal = True
        if len(self._buf) > 65536:      # non-SSE payloads with no
            self._buf = self._buf[-65536:]   # newlines must not pool


def _with_resume_headers(raw: bytes, sid: str, last_id: int) -> bytes:
    """The buffered client request, rewritten into a resume request:
    ``Last-Event-ID`` pins the dedup floor and ``X-Dl4j-Session-Id``
    names the journaled session the survivor must adopt.  Any client-
    sent copies of either header are dropped first (the proxy's view
    of delivered bytes is authoritative once it has relayed any)."""
    head, sep, body = raw.partition(b"\r\n\r\n")
    lines = [ln for ln in head.split(b"\r\n")
             if not ln.lower().startswith(
                 (b"last-event-id:", b"x-dl4j-session-id:"))]
    lines.append(b"Last-Event-ID: " + str(int(last_id)).encode("ascii"))
    lines.append(b"X-Dl4j-Session-Id: " + sid.encode("latin-1"))
    return b"\r\n".join(lines) + (sep or b"\r\n\r\n") + body


class _ProxyMetrics:
    """The proxy process's OWN ``dl4j_*`` series (fleet observability
    satellite: before this, the failover/circuit counters were visible
    only via the shared-store re-export inside workers).  Served on the
    admin port's ``/metrics`` and folded into ``/metrics/fleet`` under
    ``worker="proxy"``."""

    _instance = None
    _lock = threading.Lock()
    _reset_hooked = False

    def __init__(self):
        from deeplearning4j_tpu_torch.observability import global_registry
        reg = global_registry()
        self.failovers = reg.counter(
            "dl4j_fleet_failovers_total",
            "proxy requests re-sent to another worker after a backend "
            "connect/first-byte failure")
        self._connect_failures = reg.counter(
            "dl4j_proxy_connect_failures_total",
            "backend connect/first-byte failures seen by the proxy, by "
            "worker port",
            label_names=("port",))
        self._ejections = reg.counter(
            "dl4j_proxy_ejections_total",
            "backends skipped while their circuit was open, by worker "
            "port",
            label_names=("port",))
        self._circuit_open = reg.gauge(
            "dl4j_proxy_circuit_open",
            "1 while the proxy's breaker for a worker port is refusing "
            "connects, else 0",
            label_names=("port",))
        self.inflight = reg.gauge(
            "dl4j_proxy_inflight",
            "client connections the proxy is currently serving (its "
            "queue depth on the wire)")
        self._stream_breaks = reg.counter(
            "dl4j_proxy_stream_breaks_total",
            "upstream connections that died mid-response (after the "
            "head, before an SSE terminal event), by worker port",
            label_names=("port",))

    def connect_failures(self, port):
        return self._connect_failures.labels(port=str(port))

    def stream_breaks(self, port):
        return self._stream_breaks.labels(port=str(port))

    def ejections(self, port):
        return self._ejections.labels(port=str(port))

    def circuit_open(self, port):
        return self._circuit_open.labels(port=str(port))

    @classmethod
    def get(cls) -> "_ProxyMetrics":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
                    if not cls._reset_hooked:
                        from deeplearning4j_tpu_torch.observability import (
                            on_registry_reset)
                        on_registry_reset(
                            lambda: setattr(cls, "_instance", None))
                        cls._reset_hooked = True
        return cls._instance


# --------------------------------------------------------------- worker
#: the reference demo's generative model (``tools/serve.py``): greedy,
#: vocab 61, 2 layers, 2 heads of 16, d_model 32, decoding to 48 tokens
DEMO_CONFIG = dict(vocab_size=61, n_layers=2, n_heads=2, d_model=32,
                   max_len=64)
DEMO_MAX_LEN = 48


def demo_engine(device=None, seed: int = 0):
    """The demo ``DecodeEngine``: :data:`DEMO_CONFIG` with random f32
    weights from ``seed`` on ``device`` (``None`` = the card). One
    spelling for the workers and for a caller that needs the same
    model's undisturbed tokens."""
    from deeplearning4j_tpu_torch.models.generation import DecodeEngine
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    model = TransformerLM(TransformerConfig(**DEMO_CONFIG), device=device)
    return DecodeEngine(model, model.init_params(seed),
                        max_len=DEMO_MAX_LEN, device=device)


def _build_demo(slots: int, device=None):
    """The demo deploy: one tiny greedy TransformerLM as ``g1``."""
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ServingRouter
    reg = ModelRegistry()
    reg.deploy_generative("g1", demo_engine(device), slots=slots,
                          max_new_tokens=16)
    return reg, ServingRouter(reg, "g1")


def _retrying(what, fn, attempts: int = 8, delay_s: float = 0.1):
    """Bounded retry for the worker's startup store writes: a chaos run
    arms store.read/store.write faults in the WORKER env, and a startup
    blip must cost a beat, not the whole process (the parent would
    respawn it into the same weather)."""
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:
            if i == attempts - 1:
                raise
            print(f"worker startup: {what} failed ({e!r}); retrying",
                  file=sys.stderr, flush=True)
            time.sleep(delay_s)


def run_worker(args) -> int:
    from deeplearning4j_tpu_torch.serving import (FrontDoor, SharedServingState,
                                            SharedStore)

    reg, gen_router = _build_demo(args.slots, args.device)
    counts_dir = os.environ.get(LAUNCH_COUNTS_ENV)
    if counts_dir:
        # count what serving launches, not the warm-up
        from deeplearning4j_tpu_torch.kernels import reset_launch_counts
        reset_launch_counts()
    shared = SharedServingState(SharedStore(args.state_dir),
                                args.worker_id)
    _retrying("ensure_lane(generative)",
              lambda: shared.ensure_lane("generative", "g1"))
    fd = FrontDoor(None, gen_router, shared=shared, host=args.host,
                   port=(args.port if args.reuseport else 0),
                   reuse_port=args.reuseport,
                   max_inflight=args.max_inflight).start()
    _retrying("register",
              lambda: shared.register(os.getpid(), fd.port))
    print(json.dumps({"worker": args.worker_id, "pid": os.getpid(),
                      "port": fd.port, "address": fd.get_address()}),
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    while not stop.is_set():
        stop.wait(0.5)
    if counts_dir:
        _write_launch_counts(counts_dir, args.worker_id)
    fd.stop()
    reg.shutdown()
    return 0


def _write_launch_counts(counts_dir: str, worker_id: str) -> None:
    """This worker's kernel launches since its warm-up, by kernel name,
    as ``<counts_dir>/<worker_id>.json`` (written whole, then renamed)."""
    from deeplearning4j_tpu_torch.kernels import launch_counts
    path = os.path.join(counts_dir, f"{worker_id}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(launch_counts(), f)
    os.replace(path + ".tmp", path)


# ---------------------------------------------------------------- proxy
class _SpliceProxy:
    """Thread-per-connection TCP splice with connect-failover: pick the
    next live worker port (round robin over store heartbeats); a refused
    connect moves on to the next — a freshly killed worker sheds onto
    the survivors without a single client-visible failure on them.
    This is the pre-idempotency proxy, kept byte-identical as the
    ``DL4J_TPU_IDEMPOTENCY=0`` kill path; the default fleet runs
    :class:`_HttpProxy` (health ejection + safe failover)."""

    def __init__(self, store, host: str, port: int):
        self._store = store
        self._rr = 0
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(128)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="dl4j-proxy")
        self._thread.start()

    def _backends(self):
        now = time.time()
        try:
            doc = self._store.read()
            pairs = [(int(rec["port"]), wid) for wid, rec in
                     sorted((doc.get("workers") or {}).items())
                     if rec.get("port")
                     and now - float(rec.get("heartbeat", 0)) <= 3.0]
            ports = [p for p, _ in pairs]
            if ports:
                with self._lock:
                    self._last_ports = ports
                    # port → worker id, so the proxy span can stamp WHO
                    # it routed to (fleet observability plane)
                    self._port_wids = dict(pairs)
        except Exception:
            # a store read blip (injected store.read fault, transient
            # fs) must not drop client connections: route on the last
            # known-good backend set
            ports = []
        if not ports:
            with self._lock:
                ports = list(getattr(self, "_last_ports", ()))
        if not ports:
            return []
        with self._lock:
            self._rr += 1
            off = self._rr
        return ports[off % len(ports):] + ports[:off % len(ports)]

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                client, _ = self._srv.accept()
            except OSError:
                # transient accept errors (ECONNABORTED from a client
                # that RST'd while queued, fd-pressure blips) must not
                # kill the accept loop — a dead accept loop lets the
                # backlog fill and every later client gets refused,
                # which is exactly the "survivors fail" outcome the
                # proxy exists to prevent. Only a stop() is terminal.
                if self._stop.is_set():
                    return
                time.sleep(0.01)
                continue
            try:
                threading.Thread(target=self._splice, args=(client,),
                                 daemon=True).start()
            except RuntimeError:          # thread pressure: shed one
                client.close()            # connection, keep accepting

    def _splice(self, client: socket.socket):
        upstream = None
        for port in self._backends():
            try:
                upstream = socket.create_connection(("127.0.0.1", port),
                                                    timeout=2.0)
                break
            except OSError:
                continue            # dead worker: fail over, not fail
        if upstream is None:
            client.close()
            return

        def pump(src, dst):
            try:
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                for s in (src, dst):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        t = threading.Thread(target=pump, args=(client, upstream),
                             daemon=True)
        t.start()
        pump(upstream, client)
        t.join(timeout=5.0)
        for s in (client, upstream):
            try:
                s.close()
            except OSError:
                pass

    def stop(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass


class _HttpProxy(_SpliceProxy):
    """HTTP-aware fleet proxy: per-backend **health ejection** (a
    ``CircuitBreaker`` per worker port opens after consecutive connect/
    first-byte failures — an ejected backend is skipped until its timed
    half-open probe heals it) and **deadline-bounded failover** that is
    safe by construction: the ENTIRE buffered request — including its
    ``X-Dl4j-Idempotency-Key`` header — is re-sent to the next live
    backend, so the worker-side result journal makes the retry replay
    instead of re-execute.

    Failover triggers: connect refused/reset (dead worker) and, for
    **replay-safe** requests only (GET/HEAD, or any request carrying an
    idempotency key), no response head within ``head_timeout_s``. The
    head timeout is deliberately LONGER than a GC/SIGSTOP-class pause
    (default 15 s): failing over away from a paused-but-alive worker
    would let the original land later on a different worker than the
    retry — the journal's exactly-once scope is per worker, so patience
    beats a duplicate execution. A request with no key gets no head
    timeout at all (there is no safe retry for it).

    Once response bytes flow, the proxy degrades to a plain splice
    (SSE streams pass through token by token). Failover/ejection counts
    are published (throttled) into the shared store's ``proxy`` record,
    which every worker re-exports as ``dl4j_fleet_failovers_total`` and
    ``/debug/fleet`` surfaces."""

    def __init__(self, store, host: str, port: int,
                 head_timeout_s: float = 15.0):
        self._head_timeout = float(head_timeout_s)
        self._breakers = {}
        self._failovers = 0
        self._ejections = 0
        self._pub_at = 0.0
        super().__init__(store, host, port)

    def _breaker(self, port: int):
        from deeplearning4j_tpu_torch.resilience.policy import CircuitBreaker
        with self._lock:
            brk = self._breakers.get(port)
            if brk is None:
                brk = self._breakers[port] = CircuitBreaker(
                    f"proxy.connect:{port}", failure_threshold=3,
                    reset_timeout_seconds=2.0)
            return brk

    def _note(self, failover: bool = False, ejection: bool = False):
        with self._lock:
            if failover:
                self._failovers += 1
            if ejection:
                self._ejections += 1
            now = time.monotonic()
            if now - self._pub_at < 1.0:
                return
            self._pub_at = now
            fo, ej = self._failovers, self._ejections

        def mutate(doc):
            doc["proxy"] = {"mode": "http", "failovers": fo,
                            "ejections": ej, "at": time.time()}
        try:
            self._store.update(mutate)
        except Exception:
            pass            # stats are best-effort; next note retries

    def debug_snapshot(self) -> dict:
        """The admin port's ``/debug/proxy`` extra: lifetime failover/
        ejection counts and each backend breaker's live state."""
        with self._lock:
            out = {"mode": "http", "failovers": self._failovers,
                   "ejections": self._ejections,
                   "backends": dict(getattr(self, "_port_wids", {}))}
            breakers = dict(self._breakers)
        out["breakers"] = {str(port): str(getattr(brk, "state", "?"))
                           for port, brk in sorted(breakers.items())}
        return out

    @staticmethod
    def _read_request(client):
        """Buffer one full HTTP request (line + headers + body by
        Content-Length). Returns (raw_bytes, replay_safe, header_map)
        or None."""
        client.settimeout(30.0)
        f = client.makefile("rb")
        line = f.readline(65536)
        if not line:
            return None
        chunks = [line]
        hmap = {}
        while True:
            h = f.readline(65536)
            if h in (b"", b"\r\n", b"\n"):
                chunks.append(b"\r\n")
                break
            chunks.append(h)
            k, _, v = h.partition(b":")
            hmap[k.strip().lower()] = v.strip()
        try:
            n = int(hmap.get(b"content-length", b"0") or 0)
        except ValueError:
            n = 0
        if n > 0:
            chunks.append(f.read(min(n, 16 << 20)))
        method = line.split(b" ", 1)[0].upper()
        replay_safe = (method in (b"GET", b"HEAD")
                       or b"x-dl4j-idempotency-key" in hmap)
        return b"".join(chunks), replay_safe, hmap

    def _splice(self, client: socket.socket):
        try:
            req = self._read_request(client)
        except (OSError, ValueError):
            req = None
        if req is None:
            try:
                client.close()
            except OSError:
                pass
            return
        raw, replay_safe, hmap = req
        if not _fleet_obs_on():
            # kill-switch path: the pre-federation proxy, byte-for-byte
            # (no span, no header rewrite, no proxy-local metrics)
            self._forward(client, raw, replay_safe, None)
            return
        from deeplearning4j_tpu_torch.observability import federation as fed
        from deeplearning4j_tpu_torch.observability.tracing import (span,
                                                              trace_context)
        metrics = _ProxyMetrics.get()
        ctx = fed.trace_context_from_bytes(hmap)
        metrics.inflight.inc(1)
        try:
            # the proxy's OWN span per connection: joined to the
            # caller's context when the client sent one, and the parent
            # of the worker's http_request span via the injected
            # headers — ONE trace id across proxy, worker, and response
            try:
                route = raw.split(b"\r\n", 1)[0].split(b" ")[1].decode(
                    "latin-1")
            except (IndexError, UnicodeDecodeError):
                route = None
            with trace_context(ctx):
                with span("proxy_request", route=route,
                          replay_safe=bool(replay_safe)) as sp:
                    tid = getattr(sp, "trace_id", None) or ctx.trace_id
                    parent = getattr(sp, "span_id", None) or ctx.span_id
                    out = fed.inject_trace_headers(raw, tid, parent)
                    self._forward(client, out, replay_safe, sp)
        finally:
            metrics.inflight.inc(-1)

    def _forward(self, client: socket.socket, raw: bytes,
                 replay_safe: bool, sp):
        """The backend loop: connect → re-send the buffered request →
        failover per the replay-safety rules.  ``sp`` is the open
        ``proxy_request`` span (None on the kill-switch path, which
        also disables the proxy-local metrics)."""
        metrics = _ProxyMetrics.get() if sp is not None else None
        attempted = 0
        for port in self._backends():
            brk = self._breaker(port)
            if not brk.allow():
                self._note(ejection=True)    # health-ejected backend
                if metrics is not None:
                    metrics.ejections(port).inc()
                    metrics.circuit_open(port).set(1.0)
                continue
            if attempted:
                self._note(failover=True)
                if metrics is not None:
                    metrics.failovers.inc()
            attempted += 1
            upstream = None
            delivered = False
            try:
                upstream = socket.create_connection(("127.0.0.1", port),
                                                    timeout=2.0)
                delivered = True    # from here bytes may have landed
                upstream.sendall(raw)
                upstream.settimeout(self._head_timeout if replay_safe
                                    else None)
                first = upstream.recv(65536)
                if not first:
                    raise OSError("upstream closed before response head")
            except OSError:
                if upstream is not None:
                    try:
                        upstream.close()
                    except OSError:
                        pass
                brk.record_failure()
                if metrics is not None:
                    metrics.connect_failures(port).inc()
                if delivered and not replay_safe:
                    # the request may have EXECUTED before the death —
                    # with no idempotency key there is no safe retry
                    # (a re-send could double-execute / double-charge);
                    # the client sees the reset and owns the decision
                    if sp is not None:
                        sp.set_attr("outcome", "reset")
                    break
                continue            # next backend gets the same bytes
            brk.record_success()
            if metrics is not None:
                metrics.circuit_open(port).set(0.0)
            if sp is not None:
                # stamp WHO served it (and how many hops it took): the
                # cross-process join point for the access log
                sp.set_attr("worker_port", port)
                sp.set_attr(
                    "worker",
                    getattr(self, "_port_wids", {}).get(port))
                sp.set_attr("failovers", attempted - 1)
                sp.set_attr("outcome", "ok")
                try:
                    # the status from the response head the proxy
                    # already holds: a forwarded 4xx/5xx must retain the
                    # PROXY side of the trace too, or error waterfalls
                    # would assemble with the proxy hop missing
                    head = first.split(b" ", 2)
                    if head[0].startswith(b"HTTP/"):
                        sp.set_attr("status", int(head[1]))
                except (IndexError, ValueError):
                    pass
            upstream.settimeout(None)
            if metrics is not None and _sessions_on():
                # session-aware relay: an upstream death mid-SSE is
                # re-routed to a survivor (Last-Event-ID) instead of
                # silently truncating the client's stream
                self._relay_stream(client, upstream, first, port, raw,
                                   sp, metrics)
                return
            try:
                client.sendall(first)
                while True:
                    data = upstream.recv(65536)
                    if not data:
                        break
                    client.sendall(data)
            except OSError:
                pass                # client gone / upstream died mid-
            finally:                # response: no safe retry, close out
                for s in (client, upstream):
                    try:
                        s.close()
                    except OSError:
                        pass
            return
        if sp is not None:
            sp.set_attr("outcome", "no_backend")
        try:
            client.close()          # no live backend took the request
        except OSError:
            pass

    # ---------------------------------------------- mid-stream failover
    @staticmethod
    def _close_pair(client, upstream):
        for s in (client, upstream):
            try:
                s.close()
            except OSError:
                pass

    @staticmethod
    def _read_head(upstream, first: bytes = b"") -> bytes:
        """Accumulate upstream bytes until the full response head
        (``CRLFCRLF``) is buffered; body bytes past it ride along."""
        blob = first
        while b"\r\n\r\n" not in blob and len(blob) < 262144:
            data = upstream.recv(65536)
            if not data:
                break
            blob += data
        return blob

    @staticmethod
    def _parse_head(blob: bytes):
        """``(status, is_sse, session_id, body_offset)`` from a
        buffered response head, or None if no complete head is there."""
        end = blob.find(b"\r\n\r\n")
        if end < 0:
            return None
        lines = blob[:end].split(b"\r\n")
        status = 0
        parts = lines[0].split(b" ")
        if len(parts) >= 2 and parts[0].startswith(b"HTTP/"):
            try:
                status = int(parts[1])
            except ValueError:
                pass
        is_sse, sid = False, None
        for ln in lines[1:]:
            k, _, v = ln.partition(b":")
            k, v = k.strip().lower(), v.strip()
            if (k == b"content-type"
                    and v.lower().startswith(b"text/event-stream")):
                is_sse = True
            elif k == b"x-dl4j-session-id":
                sid = v.decode("latin-1")
        return status, is_sse, sid, end + 4

    def _send_stream_error(self, client, detail: str, sp) -> None:
        """A client whose stream broke and cannot be resumed gets a
        typed terminal SSE ``error`` event (with the trace id) instead
        of a silent connection reset."""
        payload = {"error": "UpstreamLost", "status": 502,
                   "detail": str(detail)}
        tid = getattr(sp, "trace_id", None) if sp is not None else None
        if tid:
            payload["trace_id"] = str(tid)
        try:
            client.sendall(b"event: error\ndata: "
                           + json.dumps(payload).encode("utf-8")
                           + b"\n\n")
        except OSError:
            pass

    def _resume_upstream(self, dead_port, raw, sid, last_id, sp,
                         metrics):
        """Re-route a broken stream: the client's buffered request is
        re-sent — rewritten with ``Last-Event-ID`` + session headers —
        to the next live backend.  Returns ``(upstream, port,
        first_body_bytes)`` once a survivor answers 200 with a fresh
        SSE head, else None."""
        resume_raw = _with_resume_headers(raw, sid, last_id)
        for port in self._backends():
            if port == dead_port:
                continue            # the corpse is still in the list
            brk = self._breaker(port)
            if not brk.allow():
                self._note(ejection=True)
                if metrics is not None:
                    metrics.ejections(port).inc()
                    metrics.circuit_open(port).set(1.0)
                continue
            try:
                upstream = socket.create_connection(
                    ("127.0.0.1", port), timeout=2.0)
                upstream.sendall(resume_raw)
                upstream.settimeout(self._head_timeout)
                blob = self._read_head(upstream)
            except OSError:
                brk.record_failure()
                if metrics is not None:
                    metrics.connect_failures(port).inc()
                continue
            parsed = self._parse_head(blob)
            if parsed is None or parsed[0] != 200 or not parsed[1]:
                # the survivor refused the adoption (shed / admission /
                # unknown session): its head is not relayable onto the
                # half-sent stream, but it IS alive — no ejection
                try:
                    upstream.close()
                except OSError:
                    pass
                brk.record_success()
                continue
            brk.record_success()
            upstream.settimeout(None)
            if metrics is not None:
                metrics.circuit_open(port).set(0.0)
            if sp is not None:
                sp.set_attr("worker_port", port)
                sp.set_attr("worker",
                            getattr(self, "_port_wids", {}).get(port))
                sp.set_attr("outcome", "resumed")
            return upstream, port, blob[parsed[3]:]
        return None

    def _relay_stream(self, client, upstream, first, port, raw, sp,
                      metrics):
        """Session-aware response relay (sessions AND fleet obs on):
        pumps bytes like the plain splice but watches the SSE tail, so
        a mid-stream upstream death is never silent.  If the response
        named a session (``X-Dl4j-Session-Id``) the proxy re-routes to
        a live worker with ``Last-Event-ID`` — the survivor adopts the
        journaled session, skips everything the client already has,
        and the stream completes on the same client socket (exactly-
        once, byte-identical under greedy).  Clients that can't resume
        get the terminal typed ``error`` event; every break counts
        ``dl4j_proxy_stream_breaks_total{port}``."""
        try:
            blob = self._read_head(upstream, first)
        except OSError:
            blob = first
        parsed = self._parse_head(blob)
        if parsed is None:          # unparseable head: plain close-out
            try:
                client.sendall(blob)
            except OSError:
                pass
            self._close_pair(client, upstream)
            return
        status, is_sse, sid, body_at = parsed
        try:
            client.sendall(blob)
        except OSError:
            self._close_pair(client, upstream)
            return
        tail = _SseTail()
        tail.feed(blob[body_at:])
        attempts = 0
        while True:
            upstream_ended = client_dead = False
            while True:
                try:
                    data = upstream.recv(65536)
                except OSError:
                    upstream_ended = True
                    break
                if not data:
                    upstream_ended = True   # EOF — terminal check below
                    break
                try:
                    client.sendall(data)
                except OSError:
                    client_dead = True
                    break
                tail.feed(data)
            if client_dead or not upstream_ended:
                break               # client gone: nothing to rescue
            if not is_sse or tail.terminal or status != 200:
                break               # the stream ended properly
            # mid-stream upstream death with a live client
            metrics.stream_breaks(port).inc()
            self._breaker(port).record_failure()
            if sp is not None:
                sp.set_attr("outcome", "stream_break")
                sp.set_attr("stream_failovers", attempts)
            if not sid or attempts >= 3:
                self._send_stream_error(
                    client, "upstream died mid-stream"
                    + ("" if sid else " (no session to resume)"), sp)
                break
            attempts += 1
            nxt = self._resume_upstream(port, raw, sid, tail.last_id,
                                        sp, metrics)
            try:
                upstream.close()
            except OSError:
                pass
            if nxt is None:
                self._send_stream_error(
                    client,
                    "no live backend could resume session " + sid, sp)
                break
            upstream, port, body0 = nxt
            self._note(failover=True)
            metrics.failovers.inc()
            if sp is not None:
                sp.set_attr("stream_failovers", attempts)
            try:
                client.sendall(body0)
            except OSError:
                break
            tail.feed(body0)        # keep pumping from the survivor
        self._close_pair(client, upstream)


# --------------------------------------------------------------- parent
def _spawn(args, wid: str) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.tools.serve",
           "--worker-id", wid, "--state-dir", args.state_dir,
           "--slots", str(args.slots),
           "--max-inflight", str(args.max_inflight)]
    if args.device is not None:
        cmd += ["--device", args.device]
    if args.host is not None:
        cmd += ["--host", args.host]
    if args.reuseport:
        cmd += ["--reuseport", "--port", str(args.port)]
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    # workers write to stderr so the PARENT's stdout stays a clean
    # protocol stream (one fleet JSON line a caller can readline())
    try:
        worker_out = sys.stderr.fileno()
    except (OSError, ValueError, AttributeError):
        worker_out = subprocess.DEVNULL     # stderr is not a real fd
    return subprocess.Popen(cmd, env=env, stdout=worker_out)


def run_fleet(args) -> int:
    from deeplearning4j_tpu_torch.serving import SharedStore

    os.makedirs(args.state_dir, exist_ok=True)
    store = SharedStore(args.state_dir)
    wids = [f"w{i}" for i in range(args.workers)]
    children = {wid: _spawn(args, wid) for wid in wids}
    deadline = time.monotonic() + args.spinup_timeout_s
    while time.monotonic() < deadline:
        try:
            ports = {w: r.get("port") for w, r in
                     (store.read().get("workers") or {}).items()}
        except Exception:
            ports = {}          # store blip (chaos env): keep waiting
        if all(ports.get(w) for w in wids):
            break
        time.sleep(0.2)
    else:
        for p in children.values():
            p.terminate()
        print("workers failed to register in time", file=sys.stderr)
        return 1
    proxy = None
    if not args.reuseport:
        # the HTTP-aware proxy (health ejection + key-forwarding
        # failover) rides the idempotency posture; its kill switch
        # restores the pre-journal TCP splice byte-identically
        if os.environ.get("DL4J_TPU_IDEMPOTENCY", "1") != "0":
            proxy = _HttpProxy(store, args.host or "127.0.0.1", args.port,
                               head_timeout_s=args.failover_head_timeout_s)
        else:
            proxy = _SpliceProxy(store, args.host or "127.0.0.1",
                                 args.port)
    admin = None
    if proxy is not None and _fleet_obs_on():
        # the fleet observability plane's admin surface on the proxy:
        # its own /metrics plus the federated /metrics/fleet,
        # /health/fleet, /alerts/fleet and /debug/proxy views
        try:
            from deeplearning4j_tpu_torch.observability.federation import (
                FleetAdminServer)
            _ProxyMetrics.get()     # register the proxy series up front
            admin = FleetAdminServer(
                store, host=args.host or "127.0.0.1",
                port=args.admin_port, local_worker="proxy",
                debug_extra=getattr(proxy, "debug_snapshot",
                                    None)).start()
        except Exception as e:
            print(f"fleet admin server failed to start: {e!r}",
                  file=sys.stderr, flush=True)
            admin = None
    address = f"http://127.0.0.1:{proxy.port if proxy else args.port}"
    announce = {
        "fleet": {w: children[w].pid for w in wids},
        "address": address,
        "state_dir": args.state_dir,
        "mode": "reuseport" if args.reuseport else "proxy",
    }
    if admin is not None:
        announce["admin_address"] = admin.get_address()
    print(json.dumps(announce), flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    try:
        while not stop.is_set():
            stop.wait(0.5)
            for wid, proc in list(children.items()):
                if proc.poll() is not None and args.respawn:
                    # the respawned worker re-registers under its old id
                    # and adopts the store's CURRENT stage — the
                    # kill/respawn drill's rejoin property
                    children[wid] = _spawn(args, wid)
                    print(json.dumps({"respawned": wid,
                                      "pid": children[wid].pid}),
                          flush=True)
    finally:
        if admin is not None:
            admin.stop()
        if proxy is not None:
            proxy.stop()
        for proc in children.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in children.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--port", type=int, default=8080,
                    help="proxy port (or the shared SO_REUSEPORT port)")
    ap.add_argument("--host", default=None,
                    help="bind host (default: DL4J_TPU_UI_HOST or "
                         "127.0.0.1)")
    ap.add_argument("--state-dir", default="/tmp/dl4j-tpu-fleet",
                    help="shared rollout store directory")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-inflight", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="the workers' torch device (default: the card, "
                         "cuda; cpu only when asked)")
    ap.add_argument("--reuseport", action="store_true",
                    help="SO_REUSEPORT kernel spreading instead of the "
                         "proxy")
    ap.add_argument("--no-respawn", dest="respawn", action="store_false")
    ap.add_argument("--failover-head-timeout-s", type=float, default=15.0,
                    help="proxy failover deadline for replay-safe "
                         "requests (carrying an idempotency key): no "
                         "response head within this long fails over to "
                         "the next live worker; sized ABOVE GC/SIGSTOP-"
                         "class pauses so a paused worker is waited "
                         "out, never duplicated")
    ap.add_argument("--admin-port", type=int, default=0,
                    help="proxy admin/observability port (0 = "
                         "ephemeral, announced as admin_address): "
                         "serves /metrics, /metrics/fleet, "
                         "/health/fleet, /alerts/fleet, /debug/proxy "
                         "when the fleet observability plane is on")
    ap.add_argument("--spinup-timeout-s", type=float, default=180.0)
    ap.add_argument("--worker-id", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker_id is not None:
        return run_worker(args)
    return run_fleet(args)


if __name__ == "__main__":
    sys.exit(main())
