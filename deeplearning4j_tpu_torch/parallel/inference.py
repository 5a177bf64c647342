"""ParallelInference: batched serving facade for a DL4J network.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py`` (the
reference's ``org.deeplearning4j.parallelism.ParallelInference``, INSTANT
and BATCHED modes). BATCHED mode coalesces concurrent small requests into
one forward on the card, padded to a shape bucket, which is where serving
throughput on an accelerator comes from.

Async pipeline (default; kill switch ``DL4J_TPU_ASYNC=0``): the serve loop
is split into three stages so several device batches stay in flight —

    producers → request queue → **batcher** (coalesce + pad to a
    power-of-two shape bucket) → **dispatcher** (non-blocking device
    dispatch, up to ``inflight_limit`` batches queued on the card) →
    **completer** (waits for the batch's CUDA event, copies it back once,
    distributes per-request slices)

The reference leans on JAX's async dispatch; the port orders the same
stages explicitly. The dispatcher stages each padded batch in pinned host
memory, copies it to the card without blocking on a stream of its own
(``record_stream`` hands the buffer to the compute stream), queues the
forward and records a ``torch.cuda.Event`` after it; the completer waits
on that event and copies the result back on a third stream. The
dispatcher waits for neither copy, so batch *k+1*'s upload and launches
may run while
batch *k* still computes or copies back; how much of the copies' time
actually runs under other kernels depends on the load (``chip_smoke.py``'s
scoring phase reads it from a trace). The current stream is thread-local,
so the two threads order only through events. On the CPU
(``device="cpu"`` nets and callers' wrappers) the forward is synchronous
and the completer only slices. Under ``DL4J_TPU_ASYNC=0`` the
single-threaded loop runs: one batch in flight, padded to
``batch_limit``.

A padded row never reaches a caller: each request gets its own rows of the
output (``_distribute``), and the network's inference forward treats rows
independently (BatchNormalization reads its running statistics), so a
request's probabilities do not depend on what shares its batch.

Resilience (kill switch ``DL4J_TPU_RESILIENCE=0``), as in the reference:
per-request deadlines (shed before padding, before an in-flight slot, at
distribution, and by the caller's walk-away), bounded-queue shedding
(``reject_newest`` / ``reject_oldest``), a per-instance
``CircuitBreaker`` on device execution with half-open probes, budgeted
retries of transient dispatch faults, and the typed ``ShutdownError``.
Multi-tenant QoS (kill switch ``DL4J_TPU_QOS=0``): a deficit-weighted
``FairQueue`` over per-tenant queues, over-share shedding, and per-tenant
requests, latency, tokens (examples) and the bucket's FLOPs share.

Every metric series is the reference's (``dl4j_inference_*``). The cost
model names each bucket ``<Net>._output_jit[b<n>]`` and counts its FLOPs
analytically (``cost_model.maybe_account_bucket``). ``workers`` shards
the forward over N devices in the reference (a ``ShardedTrainer``);
multi-GPU is ROADMAP queue 1 item 7, so ``workers`` > 1 raises.
"""
from __future__ import annotations

import bisect
import queue
import threading
import time
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import async_runtime as _async
from deeplearning4j_tpu_torch.observability import compile_watch as _cw
from deeplearning4j_tpu_torch.observability import cost_model as _cost
from deeplearning4j_tpu_torch.observability import device_memory as _devmem
from deeplearning4j_tpu_torch.observability import (global_registry,
                                                    on_registry_reset)
from deeplearning4j_tpu_torch.observability import span as _span
from deeplearning4j_tpu_torch.observability.flight_recorder import (
    global_flight_recorder as _flight)
from deeplearning4j_tpu_torch.observability.straggler import (
    StragglerDetector)
from deeplearning4j_tpu_torch.observability.tracing import (current_context,
                                                            now_us,
                                                            record_span)
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience import qos as _qos
from deeplearning4j_tpu_torch.resilience.policy import (TYPED_OUTCOMES,
                                                        CircuitBreaker,
                                                        CircuitOpenError,
                                                        Deadline,
                                                        DeadlineExceeded,
                                                        RetryPolicy,
                                                        ShedError,
                                                        ShutdownError,
                                                        default_deadline_ms)


class InferenceMode:
    INSTANT = "INSTANT"
    BATCHED = "BATCHED"


#: excluded from dl4j_inference_errors_total and from the circuit
#: breaker's failure accounting (see policy.TYPED_OUTCOMES — shared with
#: the serving router so the two error-rate surfaces cannot diverge)
_TYPED_OUTCOMES = TYPED_OUTCOMES


class _ServingMetrics:
    """Label-bound serving instruments (shared across instances — the
    registry aggregates; per-instance series would leak one label value
    per short-lived ParallelInference in tests)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        reg = global_registry()
        lat = reg.histogram(
            "dl4j_inference_latency_seconds",
            "end-to-end ParallelInference.output latency (enqueue + batch "
            "window + device forward)", label_names=("mode",))
        self.latency = {m: lat.labels(mode=m)
                        for m in (InferenceMode.INSTANT, InferenceMode.BATCHED)}
        req = reg.counter("dl4j_inference_requests_total",
                          "ParallelInference requests served",
                          label_names=("mode",))
        self.requests = {m: req.labels(mode=m)
                         for m in (InferenceMode.INSTANT, InferenceMode.BATCHED)}
        self.errors = reg.counter("dl4j_inference_errors_total",
                                  "ParallelInference requests that raised")
        self.queue_depth = reg.gauge(
            "dl4j_inference_queue_depth",
            "requests waiting in the batching queue (sampled per transition)")
        self.batch_occupancy = reg.histogram(
            "dl4j_inference_batch_occupancy",
            "coalesced examples / batch_limit per device call (1.0 = full "
            "batch, the padded-executable reuse sweet spot)",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self.batches = reg.counter("dl4j_inference_batches_total",
                                   "device calls issued by the serve loop")
        self.inflight = reg.gauge(
            "dl4j_inference_inflight_batches",
            "device batches dispatched but not yet completed (serving "
            "pipeline depth; bounded by inflight_limit)")
        bucket = reg.counter(
            "dl4j_inference_bucket_total",
            "shape-bucket outcomes per device call: hit = padded shape "
            "already run for this instance, miss = first use",
            label_names=("outcome",))
        self.bucket_hits = bucket.labels(outcome="hit")
        self.bucket_misses = bucket.labels(outcome="miss")
        self.bucket_fill = reg.histogram(
            "dl4j_inference_bucket_fill",
            "coalesced examples / padded bucket size per device call "
            "(1.0 = zero padded compute waste)",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        shed = reg.counter(
            "dl4j_inference_shed_total",
            "requests shed by admission control: queue_full (bounded-queue "
            "reject), deadline (expired before completion), circuit_open "
            "(failed fast on an open breaker)", label_names=("reason",))
        self.shed = {r: shed.labels(reason=r)
                     for r in ("queue_full", "deadline", "circuit_open")}
        # serving-side straggler flag (the detector previously watched
        # train steps only): per-device-batch dispatch→complete wall time
        # against its rolling median, so one slow first bucket shape or
        # a wedged transfer shows up in a scrape without a trace
        self.straggler = StragglerDetector(phase="inference_batch",
                                           registry=reg)

    @classmethod
    def get(cls) -> "_ServingMetrics":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance


@on_registry_reset
def _drop_serving_metrics():
    _ServingMetrics._instance = None


def _host_f32(t: torch.Tensor) -> np.ndarray:
    """A host tensor (or a CPU net's output) as f32 numpy."""
    t = t.detach()
    if t.dtype != torch.float32 and t.is_floating_point():
        t = t.float()
    return t.cpu().numpy()


class _Dispatched:
    """One dispatched batch: the forward's output tensor and the CUDA
    event recorded after it on the dispatching thread's stream (None when
    the forward ran on the CPU and is already done)."""
    __slots__ = ("out", "event")

    def __init__(self, out, event):
        self.out = out
        self.event = event


class _Request:
    __slots__ = ("x", "event", "result", "error", "ctx", "t_enqueue_us",
                 "deadline", "tenant", "_claim_lock", "_claimed")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error = None
        # QoS tenant label (None when QoS is off — the request behaves
        # exactly as pre-tenant requests did)
        self.tenant = None
        # causal trace context captured at enqueue: the serve threads stamp
        # this request's queue_wait/bucket_pad/dispatch/device/complete
        # phases into ITS trace, so one trace_id follows the request across
        # the batcher→dispatcher→completer pipeline
        self.ctx = None
        self.t_enqueue_us = 0.0
        # optional Deadline: checked by the batcher before padding, the
        # dispatcher before an in-flight slot is taken, and the completer
        # before handing the slice back
        self.deadline = None
        # exactly-once resolution: every path that would set
        # result/error (completer, _fail, shed, the caller's deadline
        # walk-away) must win claim() first — two racing resolvers can
        # never both count a shed or overwrite each other's outcome
        self._claim_lock = threading.Lock()
        self._claimed = False

    def claim(self) -> bool:
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True


class ParallelInference:
    """ref API: ParallelInference.Builder(model).inferenceMode(...)
    .batchLimit(n).queueLimit(n).build(); output(x).

    ``model`` is a port network (``output`` takes numpy or a tensor and
    returns a tensor on the net's device) or any object with such an
    ``output``. ``output(x)`` returns a host numpy array, as the
    reference's does. Instances own serve threads (BATCHED mode); call
    :meth:`shutdown` (or use as a context manager) when done.
    :meth:`shutdown_all` stops every live instance — the test harness's
    safety net against leaked serve threads keeping the nets and their
    device buffers alive."""

    _live = weakref.WeakSet()

    def __init__(self, model, inference_mode: str = InferenceMode.BATCHED,
                 batch_limit: int = 32, queue_limit: int = 64,
                 max_wait_ms: float = 5.0, workers: Optional[int] = None,
                 inflight_limit: Optional[int] = None,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 max_queue_depth: Optional[int] = None,
                 shed_policy: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.model = model
        self.mode = inference_mode
        self.batch_limit = batch_limit
        self.max_wait_ms = max_wait_ms
        # resilience posture, resolved at construction so a running
        # instance is stable even if the env knobs change mid-flight.
        # DL4J_TPU_RESILIENCE=0 ⇒ all of it inert (byte-identical paths).
        self._resilience = _faults.resilience_enabled()
        if shed_policy is not None and shed_policy not in (
                "reject_newest", "reject_oldest"):
            raise ValueError("shed_policy must be 'reject_newest' or "
                             f"'reject_oldest', got {shed_policy!r}")
        if max_queue_depth is not None and self._resilience:
            # under the kill switch the bounded queue must NOT apply
            # either: pre-resilience behavior is the default-depth queue
            # with producer parking, not a shrunk queue without shedding
            queue_limit = max(1, int(max_queue_depth))
            shed_policy = shed_policy or "reject_newest"
        self._shed_policy = shed_policy if self._resilience else None
        self.default_deadline_ms = (deadline_ms if deadline_ms is not None
                                    else default_deadline_ms())
        self._breaker = None
        if self._resilience:
            self._breaker = breaker if breaker is not None else \
                CircuitBreaker("inference.device_execute")
            self._retry = RetryPolicy(max_retries=2,
                                      base_delay_seconds=0.01)
        # pipeline depth + padding buckets (async serving; see module doc).
        # Both resolved here so a running instance has stable behavior even
        # if the env knobs change mid-flight.
        self.inflight_limit = max(1, inflight_limit if inflight_limit
                                  is not None else _async.inflight_limit())
        if bucket_sizes:
            buckets = tuple(sorted({int(b) for b in bucket_sizes
                                    if 0 < int(b) <= batch_limit}))
            if not buckets:
                # refuse loudly: silently swapping in the defaults would
                # hand the caller six bucket shapes they never asked for
                raise ValueError(
                    f"bucket_sizes {tuple(bucket_sizes)} has no entry in "
                    f"(0, batch_limit={batch_limit}]")
        else:
            buckets = _async.default_buckets(batch_limit)
        self.bucket_sizes = buckets + ((batch_limit,)
                                       if buckets[-1] != batch_limit else ())
        self._async = _async.async_enabled()
        self._seen_buckets: set = set()
        # workers: the reference shards the forward over N devices through
        # a ShardedTrainer. One card runs one program; multi-GPU comes with
        # ROADMAP queue 1 item 7, so more than one worker is refused, never
        # silently served by one
        if workers is not None and int(workers) > 1:
            raise NotImplementedError(
                f"workers={workers}: sharding the forward over several GPUs "
                "waits for multi-GPU training (ROADMAP queue 1 item 7); "
                "one card serves with workers=None or 1")
        dev = getattr(model, "device", None)
        self._device = (torch.device(dev) if isinstance(dev, (str,
                                                              torch.device))
                        else None)
        # the card path's copy streams (made on first use, per instance)
        self._h2d: Optional["torch.cuda.Stream"] = None
        self._d2h: Optional["torch.cuda.Stream"] = None
        # multi-tenant QoS posture (resolved at construction like the
        # rest): the single FIFO becomes a deficit-weighted round-robin
        # FairQueue over per-tenant queues. DL4J_TPU_QOS=0 (or the
        # resilience kill switch) keeps the original queue.Queue —
        # byte-identical pre-QoS behavior.
        self._qos = self._resilience and _qos.qos_enabled()
        if self._qos:
            self._queue = _qos.FairQueue(
                queue_limit, _qos.global_tenants(),
                cost_fn=lambda r: int(r.x.shape[0]))
        else:
            self._queue: "queue.Queue[_Request]" = queue.Queue(
                maxsize=queue_limit)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # serializes enqueue vs shutdown-drain so a request can never be
        # enqueued after the drain and hang forever; the condition wakes
        # producers blocked on a full queue the instant the batcher drains
        # it (no busy-wait poll)
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._held: Optional[_Request] = None  # window overflow carry
        if self.mode == InferenceMode.BATCHED:
            if self._async:
                self._dispatch_q: queue.Queue = queue.Queue(maxsize=2)
                self._complete_q: queue.Queue = queue.Queue(
                    maxsize=self.inflight_limit)
                targets = (self._batch_loop, self._dispatch_loop,
                           self._complete_loop)
            else:
                targets = (self._serve_loop,)
            for tgt in targets:
                t = threading.Thread(target=tgt, daemon=True,
                                     name=f"dl4j-serve-{tgt.__name__}")
                t.start()
                self._threads.append(t)
        ParallelInference._live.add(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    @classmethod
    def shutdown_all(cls):
        """Stop every live instance's serve threads (test-harness teardown)."""
        for pi in list(cls._live):
            pi.shutdown()

    class Builder:
        def __init__(self, model):
            self._model = model
            self._kw = {}

        def inference_mode(self, mode):
            self._kw["inference_mode"] = mode
            return self

        inferenceMode = inference_mode

        def batch_limit(self, n):
            self._kw["batch_limit"] = n
            return self

        batchLimit = batch_limit

        def queue_limit(self, n):
            self._kw["queue_limit"] = n
            return self

        queueLimit = queue_limit

        def workers(self, n):
            self._kw["workers"] = n
            return self

        def inflight_limit(self, n):
            self._kw["inflight_limit"] = n
            return self

        inflightLimit = inflight_limit

        def bucket_sizes(self, sizes):
            self._kw["bucket_sizes"] = tuple(sizes)
            return self

        bucketSizes = bucket_sizes

        def max_queue_depth(self, n):
            """Bound the request queue at ``n`` and shed instead of
            parking producers (admission control)."""
            self._kw["max_queue_depth"] = n
            return self

        maxQueueDepth = max_queue_depth

        def shed_policy(self, policy):
            """``reject_newest`` (refuse the arriving request) or
            ``reject_oldest`` (evict the head of the queue)."""
            self._kw["shed_policy"] = policy
            return self

        shedPolicy = shed_policy

        def deadline_ms(self, ms):
            """Default per-request deadline (overrides
            ``DL4J_TPU_DEADLINE_MS``); 0 disables."""
            self._kw["deadline_ms"] = ms
            return self

        deadlineMs = deadline_ms

        def build(self):
            return ParallelInference(self._model, **self._kw)

    # ----------------------------------------------------------------- api
    def _forward(self, x: np.ndarray) -> np.ndarray:
        return self._materialize(self._forward_async(x), x.shape[0])

    def _on_card(self) -> bool:
        return self._device is not None and self._device.type == "cuda"

    def _forward_async(self, x: np.ndarray) -> "_Dispatched":
        """Dispatch the forward and return without waiting for the card:
        ``x`` staged in pinned memory and copied on the upload stream
        without blocking, the forward queued on this thread's current
        stream, an event recorded after it. :meth:`_materialize` is the
        device→host sync. Off the card the forward runs here."""
        if not self._on_card():
            return _Dispatched(self.model.output(x), None)
        dev = self._device
        if self._h2d is None:
            self._h2d = torch.cuda.Stream(device=dev)
            self._d2h = torch.cuda.Stream(device=dev)
        host = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
        compute = torch.cuda.current_stream(dev)
        with torch.cuda.stream(self._h2d):
            xd = host.to(dev, non_blocking=True)
        compute.wait_stream(self._h2d)
        # allocated on the upload stream, read on the compute stream: the
        # allocator must not reuse it before the forward has read it
        xd.record_stream(compute)
        out = self.model.output(xd)
        done = torch.cuda.Event()
        done.record(compute)
        return _Dispatched(out, done)

    def _materialize(self, d: "_Dispatched", n: int) -> np.ndarray:
        """The first ``n`` rows of a dispatched batch on the host: wait for
        its event on the download stream, copy once (blocking that stream
        only), as f32 numpy."""
        out = d.out
        if not isinstance(out, torch.Tensor):
            return np.asarray(out)[:n]
        if d.event is None:
            return _host_f32(out[:n])
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(d.event)
            out.record_stream(self._d2h)
            host = out[:n].to("cpu")
        return _host_f32(host)

    @staticmethod
    def _exemplar(ctx):
        """Histogram exemplar linking a latency observation to its trace
        (a `/metrics` tail bucket then names the trace_id to pull from
        `/train/trace`)."""
        return {"trace_id": ctx.trace_id} if ctx is not None else None

    def _resolve_deadline(self, deadline_ms) -> Optional[Deadline]:
        if not self._resilience:
            return None
        ms = deadline_ms if deadline_ms is not None else self.default_deadline_ms
        return Deadline.after_ms(ms) if ms and ms > 0 else None

    def _shed(self, reason: str, tenant=None):
        _ServingMetrics.get().shed[reason].inc()
        if tenant is not None:
            _qos.global_tenants().count_shed(tenant, reason)
        _faults.record_event("shed", op="inference", reason=reason)

    def _check_admission(self, tenant=None):
        """Fail fast on an open circuit — a dead device must reject at the
        door, not after a queue+batch+dispatch round trip."""
        if self._breaker is not None and not self._breaker.allow():
            self._shed("circuit_open", tenant=tenant)
            raise CircuitOpenError(
                "inference circuit open (consecutive device-execution "
                "failures); retry after the reset timeout")

    def output(self, x, deadline_ms: Optional[float] = None,
               tenant=None) -> np.ndarray:
        x = np.asarray(x)
        obs = _ServingMetrics.get()
        t0 = time.perf_counter()
        dl = self._resolve_deadline(deadline_ms)
        # tenant identity rides the request only under the QoS posture;
        # otherwise the kwarg is inert (byte-identical pre-QoS paths)
        tn = _qos.global_tenants().resolve(tenant) if self._qos else None

        def _tenant_account(err=None):
            if tn is not None:
                _qos.global_tenants().observe_request(
                    tn, time.perf_counter() - t0, err)
        if self.mode == InferenceMode.INSTANT:
            with _span("inference_request", mode=InferenceMode.INSTANT,
                       examples=int(x.shape[0])):
                ctx = current_context()
                try:
                    self._check_admission(tenant=tn)
                    if dl is not None and dl.expired():
                        self._shed("deadline", tenant=tn)
                        raise DeadlineExceeded(
                            "request expired before dispatch")
                    if self._resilience:
                        # same retry parity as the serve loops: transient
                        # dispatch faults are absorbed under the budget
                        self._retry.call(
                            lambda: _faults.check("inference.dispatch"),
                            op="inference.dispatch")
                        _faults.check("inference.device_execute")
                    out = self._forward(x)[: x.shape[0]]
                    if self._breaker is not None:
                        self._breaker.record_success()
                    if dl is not None and dl.expired():
                        # the device answered, but late — a late answer is
                        # wrong by the same policy _distribute applies in
                        # BATCHED mode (the breaker still saw a success:
                        # the device itself is healthy)
                        self._shed("deadline", tenant=tn)
                        raise DeadlineExceeded(
                            "request expired during device execution")
                except Exception as e:
                    # failed requests still count in the requests_total
                    # denominator (same as the BATCHED path) — otherwise
                    # ErrorRateRule's min_requests gate would read a 100%
                    # INSTANT outage as "no traffic, ok"
                    if (self._breaker is not None
                            and not isinstance(e, _TYPED_OUTCOMES)):
                        self._breaker.record_failure()
                    obs.latency[InferenceMode.INSTANT].observe(
                        time.perf_counter() - t0,
                        exemplar=self._exemplar(ctx))
                    obs.requests[InferenceMode.INSTANT].inc()
                    _tenant_account(e)
                    if not isinstance(e, _TYPED_OUTCOMES):
                        obs.errors.inc()
                    raise
            obs.latency[InferenceMode.INSTANT].observe(
                time.perf_counter() - t0, exemplar=self._exemplar(ctx))
            obs.requests[InferenceMode.INSTANT].inc()
            _tenant_account()
            if tn is not None:
                _qos.global_tenants().account_tokens(tn, int(x.shape[0]))
            return out
        req = _Request(x)
        req.deadline = dl
        req.tenant = tn
        # the per-request END-TO-END span: everything the serve threads do
        # for this request parents under it (they stamp phase records with
        # req.ctx), and the flight recorder treats the outstanding request
        # as in-flight work whose completion must keep making progress
        with _flight().arm("inference_request"), \
                _span("inference_request", mode=InferenceMode.BATCHED,
                      examples=int(x.shape[0])):
            req.ctx = current_context()
            req.t_enqueue_us = now_us()
            try:
                self._check_admission(tenant=tn)
            except CircuitOpenError as e:
                # fail-fast rejections are still traffic: without the
                # requests_total increment a 100% circuit-open outage
                # would read as "no traffic, ok" to ErrorRateRule's
                # min_requests gate (INSTANT mode already counts these)
                obs.latency[InferenceMode.BATCHED].observe(
                    time.perf_counter() - t0,
                    exemplar=self._exemplar(req.ctx))
                obs.requests[InferenceMode.BATCHED].inc()
                _tenant_account(e)
                raise
            # condition-based enqueue: a producer facing a full queue
            # sleeps on the condition and is woken by the batcher the
            # moment it drains a request — no 1 ms busy-wait poll, no
            # burned CPU. The timeout is belt-and-braces against a lost
            # wakeup racing shutdown.
            try:
                with self._not_full:
                    while True:
                        if self._stop.is_set():
                            raise ShutdownError(
                                "ParallelInference has been shut down")
                        if (req.deadline is not None
                                and req.deadline.expired()):
                            self._shed("deadline", tenant=tn)
                            raise DeadlineExceeded(
                                "request expired while waiting to enqueue")
                        try:
                            self._queue.put_nowait(req)
                            obs.queue_depth.set(self._queue.qsize())
                            break
                        except queue.Full:
                            if (self._qos
                                    and self._shed_policy is not None):
                                # tenant-aware shedding: evict from the
                                # most over-share tenant; None means the
                                # ARRIVING tenant is the most over-share
                                # (or nobody is over) — never evict an
                                # under-share tenant's work. In that
                                # case reject_oldest keeps its pre-QoS
                                # meaning WITHIN the tenant: the
                                # arrival's own stale head gives way
                                victim = self._queue.pick_victim(req)
                                if (victim is None and
                                        self._shed_policy
                                        == "reject_oldest"):
                                    victim = (self._queue.pop_oldest_of(
                                        tn)
                                        or self._queue
                                        .pop_global_oldest())
                                if victim is None:
                                    self._shed("queue_full", tenant=tn)
                                    raise ShedError(
                                        "inference queue full "
                                        f"({self._queue.maxsize} "
                                        "requests); request rejected "
                                        "(tenant over its fair share)")
                                self._shed_request(
                                    victim, "queue_full", ShedError(
                                        "shed from a full inference "
                                        "queue (most over-share "
                                        "tenant)"))
                                continue
                            if self._shed_policy == "reject_newest":
                                self._shed("queue_full", tenant=tn)
                                raise ShedError(
                                    "inference queue full "
                                    f"({self._queue.maxsize} requests); "
                                    "request rejected (reject_newest)")
                            if self._shed_policy == "reject_oldest":
                                try:
                                    old = self._queue.get_nowait()
                                except queue.Empty:
                                    continue  # batcher drained it — retry
                                self._shed_request(
                                    old, "queue_full", ShedError(
                                        "shed from a full inference queue "
                                        "by a newer request (reject_oldest)"))
                                continue
                            self._not_full.wait(timeout=0.1)
            except (ShedError, DeadlineExceeded, ShutdownError) as e:
                # pre-enqueue rejections count as requests too — same
                # denominator invariant as the error path below
                obs.latency[InferenceMode.BATCHED].observe(
                    time.perf_counter() - t0,
                    exemplar=self._exemplar(req.ctx))
                obs.requests[InferenceMode.BATCHED].inc()
                _tenant_account(e)
                raise
            # deadline-aware wait: the batcher/dispatcher/completer checks
            # cover the queue and the pad/dispatch boundaries, but a
            # WEDGED device batch resolves nothing — the caller must be
            # able to walk away at its deadline instead of hanging
            if req.deadline is None:
                req.event.wait()
            else:
                while not req.event.is_set():
                    rem = req.deadline.remaining()
                    if rem <= 0:
                        break
                    req.event.wait(timeout=rem)
                if not req.event.is_set():
                    # walk away: atomically CLAIM the request so pipeline
                    # stages skip it (no second shed count when the
                    # wedged batch finally resolves). Losing the claim
                    # race means another path is resolving RIGHT NOW —
                    # wait for its outcome instead of inventing one.
                    if req.claim():
                        req.error = DeadlineExceeded(
                            "request expired while awaiting device results")
                        req.event.set()
                        self._shed("deadline", tenant=tn)
                    else:
                        req.event.wait(timeout=5.0)
                        if req.error is None and req.result is None:
                            # the claim winner stalled past the grace
                            # window too — resolve locally rather than
                            # fall through to a None "result" (nobody
                            # reads the winner's late outcome)
                            req.error = DeadlineExceeded(
                                "request expired while awaiting device "
                                "results (resolution stalled)")
                # falls through to the common error accounting below
            if req.error is not None:
                # raise INSIDE the request span so the trace and
                # dl4j_span_errors_total agree with
                # dl4j_inference_errors_total about this request failing.
                # Typed resilience outcomes (shed/deadline/shutdown) are
                # lifecycle results, not device errors — they count as
                # requests but must not move the error-rate SLO.
                obs.latency[InferenceMode.BATCHED].observe(
                    time.perf_counter() - t0,
                    exemplar=self._exemplar(req.ctx))
                obs.requests[InferenceMode.BATCHED].inc()
                _tenant_account(req.error)
                if not isinstance(req.error, _TYPED_OUTCOMES):
                    obs.errors.inc()
                raise req.error
        obs.latency[InferenceMode.BATCHED].observe(
            time.perf_counter() - t0, exemplar=self._exemplar(req.ctx))
        obs.requests[InferenceMode.BATCHED].inc()
        _tenant_account()
        return req.result

    def shutdown(self):
        self._stop.set()
        # wake producers parked on the not-full condition so they observe
        # the stop flag instead of waiting out their timeout
        with self._not_full:
            self._not_full.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        if self._breaker is not None:
            # a dead instance's open circuit must not pin /health failing
            self._breaker.retire()
        # fail any requests that were still queued so callers never hang
        with self._lock:
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if not req.claim():
                    continue
                req.error = ShutdownError("ParallelInference shut down")
                req.event.set()
        # the queue-depth gauge must not freeze at the pre-shutdown burst
        # level — the SLO rule reads it live, and a stale >threshold value
        # would pin /health degraded/failing on a drained instance
        _ServingMetrics.get().queue_depth.set(self._queue.qsize())
        # stage-queue sweep: a batcher put can race the dispatcher's exit
        # (fail those — never dispatched), and if a join above timed out a
        # completed-but-unclaimed batch may remain (finish those)
        if getattr(self, "_dispatch_q", None) is not None:
            obs = _ServingMetrics.get()
            while True:
                try:
                    _, batch, _ = self._dispatch_q.get_nowait()
                except queue.Empty:
                    break
                self._fail(batch, ShutdownError("ParallelInference shut down"))
            while True:
                try:
                    item = self._complete_q.get_nowait()
                except queue.Empty:
                    break
                if item is self._DONE:
                    # re-deliver: a completer whose join timed out is still
                    # parked on get() and exits only on this marker —
                    # swallowing it would strand that thread forever. The
                    # marker is always last in FIFO order, so stop here.
                    self._complete_q.put(item)
                    break
                self._complete_one(obs, *item)

    # ------------------------------------------------------- batching stage
    def _shed_request(self, req: _Request, reason: str,
                      error: BaseException):
        """Fail one request with a typed shed outcome (never dispatched).
        A request another path already resolved (claimed) is skipped —
        it was shed/completed once; counting it again would lie."""
        if not req.claim():
            return
        self._shed(reason, tenant=req.tenant)
        if req.ctx is not None:
            record_span("shed", now_us(), ctx=req.ctx, reason=reason)
        req.error = error
        req.event.set()

    def _take_request(self, timeout: float) -> Optional[_Request]:
        """Pop one request (or the held window overflow), waking any
        producer blocked on the full queue. Requests whose deadline
        already expired are shed here — before any padding or dispatch
        work is spent on them."""
        wait_until = time.monotonic() + timeout
        while True:
            if self._held is not None:
                req, self._held = self._held, None
            else:
                try:
                    req = self._queue.get(
                        timeout=max(0.0, wait_until - time.monotonic()))
                except queue.Empty:
                    return None
                with self._not_full:
                    self._not_full.notify()
                # the request's queue_wait phase ends the moment the
                # batcher owns it; start was stamped by the producer thread
                # at enqueue (a held overflow request re-enters through
                # self._held above and is not double-counted)
                if req.ctx is not None:
                    record_span("queue_wait", req.t_enqueue_us, ctx=req.ctx,
                                examples=int(req.x.shape[0]))
            if (self._resilience and req.deadline is not None
                    and req.deadline.expired()):
                self._shed_request(req, "deadline", DeadlineExceeded(
                    "request expired in the batching queue"))
                continue
            return req

    def _next_window(self) -> Optional[List[_Request]]:
        """Coalesce one batch window, never exceeding batch_limit (the
        shared heart of both the sync loop and the async batcher)."""
        first = self._take_request(timeout=0.1)
        if first is None:
            return None
        obs = _ServingMetrics.get()
        obs.queue_depth.set(self._queue.qsize())
        batch: List[_Request] = [first]
        total = first.x.shape[0]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while total < self.batch_limit:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            nxt = self._take_request(timeout=remaining)
            if nxt is None:
                break
            if total + nxt.x.shape[0] > self.batch_limit:
                # too big for this batch: hold it locally to seed the
                # next one — putting it back on a bounded queue that
                # producers may have refilled would deadlock the sole
                # consumer (and break FIFO order)
                self._held = nxt
                break
            batch.append(nxt)
            total += nxt.x.shape[0]
        return batch

    def _bucket_for(self, n: int) -> int:
        """Smallest configured bucket that fits ``n`` examples."""
        i = bisect.bisect_left(self.bucket_sizes, n)
        return self.bucket_sizes[min(i, len(self.bucket_sizes) - 1)]

    def _pad_concat(self, batch: List[_Request], target: int):
        """Concatenate a window and zero-pad the leading axis to ``target``
        so the card runs one of a few bucket shapes."""
        X = np.concatenate([r.x for r in batch], axis=0)
        n = X.shape[0]
        if n < target:
            pad = np.zeros((target - n,) + X.shape[1:], X.dtype)
            X = np.concatenate([X, pad], axis=0)
        return X, n

    @staticmethod
    def _fail(batch: List[_Request], error: BaseException):
        for r in batch:
            if not r.claim():
                continue               # caller already walked away
            r.error = error
            r.event.set()

    def _distribute(self, batch: List[_Request], out: np.ndarray):
        off = 0
        for r in batch:
            k = r.x.shape[0]
            if (self._resilience and r.deadline is not None
                    and r.deadline.expired()):
                # the work is done but the caller's deadline has passed —
                # a late answer is a wrong answer to a deadline'd caller
                off += k
                self._shed_request(r, "deadline", DeadlineExceeded(
                    "request expired before results were distributed"))
                continue
            if not r.claim():
                off += k               # caller already walked away
                continue
            r.result = out[off:off + k]
            off += k
            r.event.set()

    def _drop_if_window_expired(self, batch: List[_Request]) -> bool:
        """True when EVERY member of the window has expired — the window
        is shed whole and must not occupy an in-flight slot. A partially
        expired window still dispatches (the padded buffer is positional;
        the completer sheds the expired members at distribute time)."""
        if not self._resilience or not batch:
            return False
        if all(r.deadline is not None and r.deadline.expired()
               for r in batch):
            for r in batch:
                self._shed_request(r, "deadline", DeadlineExceeded(
                    "request expired before dispatch"))
            return True
        return False

    @staticmethod
    def _record_phase(name: str, batch: List[_Request], start_us: float,
                      end_us: float, **attrs):
        """Stamp one pipeline phase into EVERY member request's trace —
        the per-request decomposition the batch-level spans can't give
        (a batch mixes requests from different traces)."""
        for r in batch:
            if r.ctx is not None:
                # graftlint: disable=span-names — forwarder: every
                # _record_phase caller passes a literal phase name
                record_span(name, start_us, end_us, ctx=r.ctx, **attrs)

    def _observe_batch(self, obs: "_ServingMetrics", n: int, target: int):
        obs.batch_occupancy.observe(n / max(self.batch_limit, 1))
        obs.bucket_fill.observe(n / max(target, 1))
        key = (target,)
        if key in self._seen_buckets:
            obs.bucket_hits.inc()
        else:
            self._seen_buckets.add(key)
            obs.bucket_misses.inc()
            # first use of this padded shape — its first output() run (the
            # port's stand-in for a compile: cuDNN's algorithm choice for a
            # new batch size) claims this cause, so compile_watch names the
            # bucket behind it. The cause is noted per MODEL, not per
            # instance: a second ParallelInference over the same net
            # records a (per-instance) miss that runs nothing new — a
            # pending cause there would mislabel the next unrelated event
            # within the claim window
            model_seen = self.model.__dict__.setdefault(
                "_cw_seen_buckets", set())
            if key not in model_seen:
                model_seen.add(key)
                _cw.note_cause("bucket_miss", bucket=target)
        obs.batches.inc()

    def _charge_tenants(self, batch: List[_Request], target: int):
        """Per-tenant usage + cost for one executed device batch: each
        member is charged its examples as usage tokens and its share of
        the bucket executable's accounted FLOPs (k/target of the padded
        program — executed work is charged even when the caller already
        walked away, because the device ran it)."""
        if not self._qos:
            return
        flops = _cost.global_cost_model().flops_for(
            _cost.bucket_fn(self.model, target))
        reg = _qos.global_tenants()
        for r in batch:
            if r.tenant is None:
                continue
            k = int(r.x.shape[0])
            reg.account_tokens(r.tenant, k)
            if flops:
                reg.account_cost(r.tenant, flops * k / max(1, target))

    # ------------------------------------------------- sync loop (ASYNC=0)
    def _serve_loop(self):
        """Single-threaded synchronous serve loop: one batch in flight,
        pad to batch_limit — the DL4J_TPU_ASYNC=0 behavior."""
        obs = _ServingMetrics.get()
        while not self._stop.is_set():
            batch = self._next_window()
            if batch is None:
                continue
            if self._drop_if_window_expired(batch):
                continue
            try:
                t_pad = now_us()
                X, n = self._pad_concat(batch, self.batch_limit)
                self._record_phase("bucket_pad", batch, t_pad, now_us(),
                                   bucket=self.batch_limit)
                self._observe_batch(obs, n, self.batch_limit)
                t0 = time.perf_counter()
                t_dev = now_us()
                with _span("inference_batch", requests=len(batch),
                           examples=n):
                    # sync loop: dispatch + device + transfer are one
                    # blocking call, so the whole thing is the request's
                    # "device" phase (both serving fault points fire here).
                    # Parity with the async dispatcher: transient DISPATCH
                    # faults retry under the budget; device-execution
                    # faults surface (breaker food)
                    if self._resilience:
                        self._retry.call(
                            lambda: _faults.check("inference.dispatch"),
                            op="inference.dispatch")
                        _faults.check("inference.device_execute")
                    out = self._forward(X)[:n]
                t_done = now_us()
                self._record_phase("device", batch, t_dev, t_done,
                                   examples=n)
                dt = time.perf_counter() - t0
                obs.straggler.observe(dt)
                # cost observatory: the sync loop's sole bucket (pad to
                # batch_limit) — account once (an analytic count, nothing
                # runs), then feed every batch's device wall time into its
                # MFU
                _cost.maybe_account_bucket(self.model, self.batch_limit, X)
                _cost.observe_bucket_time(self.model, self.batch_limit, dt)
                self._charge_tenants(batch, self.batch_limit)
                if self._breaker is not None:
                    self._breaker.record_success()
                self._distribute(batch, out)
                self._record_phase("complete", batch, t_done, now_us())
                _flight().progress("inference_batch")
                _devmem.sample()
            except Exception as e:             # surface errors to callers
                if self._breaker is not None:
                    self._breaker.record_failure()
                self._fail(batch, e)
        if self._held is not None:             # don't strand the overflow
            if self._held.claim():
                self._held.error = ShutdownError(
                    "ParallelInference shut down")
                self._held.event.set()
            self._held = None

    # ------------------------------------------- async pipeline (default)
    def _put_stage(self, q: queue.Queue, item) -> bool:
        """Stop-aware bounded put between pipeline stages (backpressure:
        a full downstream queue throttles this stage)."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _batch_loop(self):
        """Stage 1 — coalesce request windows, pad to the shape bucket."""
        obs = _ServingMetrics.get()
        while not self._stop.is_set():
            batch = self._next_window()
            if batch is None:
                continue
            try:
                total = sum(r.x.shape[0] for r in batch)
                target = self._bucket_for(total)
                t_pad = now_us()
                X, n = self._pad_concat(batch, target)
                self._record_phase("bucket_pad", batch, t_pad, now_us(),
                                   bucket=target)
                self._observe_batch(obs, n, target)
            except Exception as e:
                self._fail(batch, e)
                continue
            if not self._put_stage(self._dispatch_q, (X, batch, n)):
                self._fail(batch,
                           ShutdownError("ParallelInference shut down"))
        if self._held is not None:             # don't strand the overflow
            if self._held.claim():
                self._held.error = ShutdownError(
                    "ParallelInference shut down")
                self._held.event.set()
            self._held = None

    _DONE = object()    # dispatcher→completer end-of-stream marker

    def _dispatch_loop(self):
        """Stage 2 — non-blocking device dispatch; up to inflight_limit
        batches queued on the device while earlier results transfer back."""
        obs = _ServingMetrics.get()
        try:
            while True:
                try:
                    X, batch, n = self._dispatch_q.get(timeout=0.05)
                except queue.Empty:
                    if self._stop.is_set():
                        break
                    continue
                if self._drop_if_window_expired(batch):
                    continue   # expired whole: never takes an in-flight slot
                t_disp = time.perf_counter()
                try:
                    t_us = now_us()
                    with _span("inference_dispatch", requests=len(batch),
                               examples=n):
                        if self._resilience:
                            # transient injected dispatch faults are
                            # retried under the budgeted policy; real
                            # errors surface immediately
                            def _dispatch(X=X):
                                _faults.check("inference.dispatch")
                                return self._forward_async(X)
                            dev = self._retry.call(
                                _dispatch, op="inference.dispatch")
                        else:
                            dev = self._forward_async(X)
                    self._record_phase("dispatch", batch, t_us, now_us(),
                                       examples=n)
                except Exception as e:         # dispatch-time errors
                    if self._breaker is not None:
                        self._breaker.record_failure()
                    self._fail(batch, e)
                    continue
                # account the bucket's cost on its first dispatch (an
                # analytic count: nothing runs on the card)
                _cost.maybe_account_bucket(self.model, X.shape[0], X)
                if self._put_stage(self._complete_q,
                                   (dev, batch, n, t_disp, X.shape[0])):
                    obs.inflight.set(self._complete_q.qsize())
                else:
                    # shutdown raced the handoff: materialize inline so
                    # the callers still get their (valid) results
                    self._complete_one(obs, dev, batch, n, t_disp,
                                       X.shape[0])
        finally:
            # end-of-stream marker: a plain blocking put is safe because
            # the completer consumes until it sees the marker (it cannot
            # exit first), and it happens-after every real put from this
            # thread — so no dispatched batch is stranded behind the
            # completer's exit check (that race existed with a
            # stop-flag-only exit)
            self._complete_q.put(self._DONE)

    def _complete_one(self, obs, dev, batch, n, t_dispatch=None,
                      target=None):
        try:
            t_dev = now_us()
            with _span("inference_complete", requests=len(batch),
                       examples=n):
                if self._resilience:
                    _faults.check("inference.device_execute")
                out = self._materialize(dev, n)   # device→host sync point
            t_done = now_us()
            # "device" = dispatch→materialize (execution + transfer tail);
            # "complete" = slicing the host buffer out to callers
            self._record_phase("device", batch, t_dev, t_done, examples=n)
            if target is not None:
                self._charge_tenants(batch, target)
            self._distribute(batch, out)
            self._record_phase("complete", batch, t_done, now_us())
            if t_dispatch is not None:
                # straggler check over the batch's dispatch→complete wall
                # time — the serving analog of a slow train step
                dt = time.perf_counter() - t_dispatch
                obs.straggler.observe(dt)
                if target is not None:
                    # bucket MFU from the same duration (includes pipeline
                    # queueing under multi-in-flight — a lower bound)
                    _cost.observe_bucket_time(self.model, target, dt)
            _flight().progress("inference_batch")
            if self._breaker is not None:
                self._breaker.record_success()
            # batch boundary: sample device memory (throttled; no-op on
            # stat-less CPU backends)
            _devmem.sample()
        except Exception as e:                 # execution-time errors
            if self._breaker is not None:
                self._breaker.record_failure()
            self._fail(batch, e)

    def _complete_loop(self):
        """Stage 3 — block on the device→host transfer, hand out slices.
        Exits only on the dispatcher's end-of-stream marker, which follows
        every real item in queue order — in-flight batches always land."""
        obs = _ServingMetrics.get()
        while True:
            item = self._complete_q.get()
            if item is self._DONE:
                break
            self._complete_one(obs, *item)
            obs.inflight.set(self._complete_q.qsize())
