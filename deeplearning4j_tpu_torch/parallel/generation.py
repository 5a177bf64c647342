"""GenerationPipeline: continuous batching for autoregressive decode.

Counterpart of ``deeplearning4j_tpu/parallel/generation.py``, the serving
half of the port's generative decode path (the model half is
``models/generation.py``). A request occupies device batch space for its
whole multi-step lifetime, so windowed batching would make every member
wait on the window's longest member; continuous batching fixes that:

- the decode batch is a fixed set of ``slots`` (every decode step runs
  over all of them, occupied or not);
- a finished/shed request frees its slot **at the step boundary**, and a
  queued request joins in the freed slot immediately — its prefill runs
  and its k/v land in that slot's cache pages
  (``DecodeEngine.insert_slot``) while every other slot keeps decoding
  on the next step;
- steady-state decode runs at one step signature: ``compile_watch``
  counts no new one after warm-up (pinned in tests).

The PR-5 policies of the reference apply unchanged: per-request
deadlines (shed at admission, at the step boundary, and by the caller's
walk-away), bounded-queue shedding (``reject_newest``/``reject_oldest``),
a circuit breaker on the decode device path, transient-fault retries
under a budget, and exactly-once resolution through the shared
``_Request.claim()``. Chaos point ``generation.step`` fires once per step
boundary. Trace phases per request: ``slot_wait`` (enqueue → slot
granted), ``prefill``, and a batch-level ``decode_step`` span per step.

Metrics (``dl4j_decode_*``): generated tokens, slot occupancy,
prefill/decode latency split, cache bytes, sheds, queue depth, with
decode/prefill MFU entries in the cost model, and in flight-recorder
bundles (``generation.json``).

Multi-tenant QoS (kill switch ``DL4J_TPU_QOS=0``, see
``resilience/qos.py``): a per-tenant DWRR ``FairQueue``, over-share
shedding, priority preemption at a step boundary (typed
``PreemptedError``), and per-tenant token and FLOPs accounting.

Paged admission: FREE PAGES, not free slots, are the admission unit.
``cache_pages=`` bounds the pool below the dense worst case; ``_admit``
parks a joiner the pool cannot back yet and retries it at every step
boundary, and ``_reclaim_pages`` sheds the youngest active generation with
the typed ``CachePagesExhausted`` when mid-decode growth exhausts the
pool. Speculative engines emit 1..spec_k tokens per step boundary;
``_sweep_finished`` consumes per-slot token LISTS.

Durable sessions (kill switch ``DL4J_TPU_SESSIONS=0``, see
``serving/session.py``): every admitted generation carries a journaled
session record. The engine writes the cache in place (K4a+w stores each
step's rows inside the attention launch), so a step that raises may leave
rows half-written: a device-level fault builds a fresh state and restores
the journaled sessions into it, each in the slot it held, to the state
before the failed step (the prompt and the emitted tokens but the last
re-prefilled, as the reference re-prefills a survivor, the last carried;
see ``_replace_survivors``), and the failed step number is run again, so
the continued stream is the fault-free one under greedy and under seeded
top-k sampling (the same generator draws over the same rows) up to the
re-prefill's rounding.
``resume(record)`` re-enters an adopted session from another worker's
journal through the ordinary admission path (byte-identical under
greedy).

The decode loop runs on its own thread, where PyTorch's thread-local state
starts afresh: the loop selects the engine's CUDA device and enters
``torch.inference_mode()`` itself, so no step records an autograd graph.
It reads results on the host at two points only: the first token of each
prefill and the tokens of each plain decode step (``.cpu()``).
"""
from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.generation import (DECODE_FN, PREFILL_FN,
                                                        PROPOSE_FN, VERIFY_FN,
                                                        DecodeEngine)
from deeplearning4j_tpu_torch.observability import cost_model as _cost
from deeplearning4j_tpu_torch.observability import global_registry, on_registry_reset
from deeplearning4j_tpu_torch.observability import span as _span
from deeplearning4j_tpu_torch.observability.flight_recorder import (
    global_flight_recorder as _flight)
from deeplearning4j_tpu_torch.observability.tracing import (current_context,
                                                            now_us, record_span)
from deeplearning4j_tpu_torch.parallel.inference import _Request
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience import qos as _qos
from deeplearning4j_tpu_torch.resilience.policy import (TYPED_OUTCOMES,
                                                        CachePagesExhausted,
                                                        CircuitBreaker,
                                                        CircuitOpenError, Deadline,
                                                        DeadlineExceeded,
                                                        RetryPolicy, ShedError,
                                                        ShutdownError,
                                                        default_deadline_ms)

_TYPED_OUTCOMES = TYPED_OUTCOMES


def _session_mod():
    """Lazy ``serving.session`` import, as in the reference: ``parallel``
    does not import the ``serving`` package at module load (the
    reference's serving registry imports the parallel modules back)."""
    from deeplearning4j_tpu_torch.serving import session
    return session


class StreamCancelled(ShedError):
    """The streaming consumer walked away (its ``on_token`` callback
    returned ``False`` or raised): the request stops decoding and its
    slot frees at the next step boundary. A typed lifecycle outcome
    (``ShedError`` subclass), never an error-rate event — a client
    closing its SSE connection is load behavior, not a model failure."""


class _GenMetrics:
    """Label-bound decode instruments (shared across instances, same
    rationale as ``_ServingMetrics``)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        reg = global_registry()
        self.tokens = reg.counter(
            "dl4j_decode_tokens_total",
            "tokens emitted by the continuous-batching decode loop "
            "(rate = serving tokens/s)")
        self.steps = reg.counter(
            "dl4j_decode_steps_total",
            "decode step boundaries executed (each runs every occupied "
            "slot one token forward)")
        self.requests = reg.counter(
            "dl4j_decode_requests_total",
            "generation requests resolved (success, typed shed, or error)")
        self.errors = reg.counter(
            "dl4j_decode_errors_total",
            "generation requests that raised a non-typed error")
        shed = reg.counter(
            "dl4j_decode_shed_total",
            "generation requests shed by admission control or deadlines",
            label_names=("reason",))
        self.shed = {r: shed.labels(reason=r)
                     for r in ("queue_full", "deadline", "circuit_open",
                               "client_gone", "preempted",
                               "pages_exhausted", "session_lost")}
        self.occupancy = reg.histogram(
            "dl4j_decode_slot_occupancy_ratio",
            "occupied slots / total slots per decode step (1.0 = the "
            "device batch is full — continuous batching's win condition)",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self.prefill_latency = reg.histogram(
            "dl4j_decode_prefill_seconds",
            "prompt prefill wall time (trunk forward + cache insert), "
            "per joining request")
        self.step_latency = reg.histogram(
            "dl4j_decode_step_seconds",
            "one decode step boundary's wall time (single-query "
            "attention over every occupied slot + sampling)")
        self.latency = reg.histogram(
            "dl4j_decode_latency_seconds",
            "end-to-end GenerationPipeline.generate latency (queue wait "
            "+ prefill + all decode steps)")
        self.cache_bytes = reg.gauge(
            "dl4j_decode_cache_bytes",
            "ACTUAL resident KV-cache bytes of live pipelines: paged = "
            "pages in use x page bytes (post-quantization), dense = the "
            "full preallocation")
        self.slots_in_use = reg.gauge(
            "dl4j_decode_slots_in_use",
            "slots occupied by in-flight generations (sampled per step "
            "boundary)")
        self.queue_depth = reg.gauge(
            "dl4j_decode_queue_depth",
            "generation requests waiting for a free slot")
        self.pages_in_use = reg.gauge(
            "dl4j_decode_pages_in_use",
            "KV-cache pages allocated to live generations across paged "
            "pipelines (the admission unit)")
        self.pages_total = reg.gauge(
            "dl4j_decode_pages_capacity",
            "KV-cache page pool capacity across live paged pipelines "
            "(gauge: _total is counter-reserved by the metric lint)")
        self.spec_accept = reg.gauge(
            "dl4j_spec_accept_ratio",
            "cumulative speculative-decode acceptance: accepted draft "
            "tokens / proposed (per live spec engines; 1.0 = every "
            "proposal verified)")

    @classmethod
    def get(cls) -> "_GenMetrics":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance


@on_registry_reset
def _drop_gen_metrics():
    _GenMetrics._instance = None


class _GenRequest(_Request):
    """One generation request riding the shared exactly-once machinery
    (``claim()``): ``x`` is the 1-D int32 prompt, ``out`` accumulates
    emitted tokens while the request owns a slot. ``on_token`` (when
    set) streams each token out at the step boundary that produced it."""

    __slots__ = ("max_new_tokens", "eos_id", "out", "t_slot_us",
                 "on_token", "cost_flops", "session", "resumes")

    def __init__(self, x, max_new_tokens: int, eos_id: Optional[int],
                 on_token=None, session=None, out=None):
        super().__init__(x)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        # non-empty ``out`` = a RESUMED session: these tokens were
        # already emitted (by this worker before a fault, or by a dead
        # one — they came back from the journal) and prefill re-enters
        # at prompt + out
        self.out: List[int] = list(out) if out else []
        self.t_slot_us = 0.0
        self.on_token = on_token
        # accounted device work attributed to this request (prefill +
        # per-slot decode-step shares) — charged to its tenant at
        # resolution under the QoS posture
        self.cost_flops = 0.0
        # the durable session record riding this request (None with
        # DL4J_TPU_SESSIONS=0); ``resumes`` bounds the in-place
        # fault-resume budget so a poisoned cache can't loop forever
        self.session = session
        self.resumes = 0


class GenerationPipeline:
    """Slot-based continuous batching over one :class:`DecodeEngine`.

    Owns a decode-loop thread; call :meth:`shutdown` (or use as a
    context manager) when done. :meth:`shutdown_all` stops every live
    instance (test-harness teardown, like ``ParallelInference``)."""

    _live: "weakref.WeakSet[GenerationPipeline]" = weakref.WeakSet()

    def __init__(self, engine: DecodeEngine, slots: int = 4,
                 queue_limit: int = 64,
                 max_new_tokens: int = 32, eos_id: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 shed_policy: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 cache_pages: Optional[int] = None):
        self.engine = engine
        self.slots = int(slots)
        if self.slots < 1:
            # a zero-slot pipeline would warm, go live, and then park
            # every request forever — refuse at construction
            raise ValueError(f"slots must be >= 1, got {slots}")
        # paged admission pool: None = the dense worst case (every slot
        # can hold max_len tokens); pass FEWER pages to run more slots
        # against a fixed HBM budget and admit by ACTUAL cached tokens
        self._cache_pages = cache_pages
        if cache_pages is not None and engine.paged:
            if int(cache_pages) < engine.pages_per_slot:
                raise ValueError(
                    f"cache_pages {cache_pages} cannot back even one "
                    f"full-length slot ({engine.pages_per_slot} pages)")
        self.default_max_new_tokens = int(max_new_tokens)
        self.default_eos_id = eos_id
        self._resilience = _faults.resilience_enabled()
        # durable-session posture (kill switch DL4J_TPU_SESSIONS=0):
        # resolved once at construction, same discipline as _resilience
        self._sessions = _session_mod().sessions_enabled()
        if shed_policy is not None and shed_policy not in (
                "reject_newest", "reject_oldest"):
            raise ValueError("shed_policy must be 'reject_newest' or "
                             f"'reject_oldest', got {shed_policy!r}")
        if max_queue_depth is not None and self._resilience:
            queue_limit = max(1, int(max_queue_depth))
            shed_policy = shed_policy or "reject_newest"
        self._shed_policy = shed_policy if self._resilience else None
        self.default_deadline_ms = (deadline_ms if deadline_ms is not None
                                    else default_deadline_ms())
        self._breaker = None
        if self._resilience:
            self._breaker = breaker if breaker is not None else \
                CircuitBreaker("generation.step")
            self._retry = RetryPolicy(max_retries=2,
                                      base_delay_seconds=0.01)
        # QoS posture: per-tenant DWRR queue (cost = 1 slot per
        # request), same kill-switch discipline as ParallelInference
        self._qos = self._resilience and _qos.qos_enabled()
        if self._qos:
            self._queue = _qos.FairQueue(queue_limit,
                                         _qos.global_tenants())
        else:
            self._queue: "queue.Queue[_GenRequest]" = queue.Queue(
                maxsize=queue_limit)
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._stop = threading.Event()
        # slot state, owned exclusively by the decode thread
        self._slot_req: List[Optional[_GenRequest]] = [None] * self.slots
        self._tokens = np.zeros((self.slots,), np.int32)
        self._positions = np.zeros((self.slots,), np.int32)
        self._cache = engine.new_state(self.slots, pages=cache_pages)
        # a popped request the pool couldn't back yet — retried at every
        # step boundary (pages free there) before the queue is touched
        self._waiting: Optional[_GenRequest] = None
        self._step = 0
        self._thread = threading.Thread(target=self._decode_loop,
                                        daemon=True, name="dl4j-gen-decode")
        self._thread.start()
        GenerationPipeline._live.add(self)
        self._publish_cache_bytes()

    @classmethod
    def _publish_cache_bytes(cls):
        """The gauge is documented as the ACTUAL resident footprint of
        LIVE pipelines — sum across them (a second deploy must not mask
        the first, and a retired pipeline's bytes must leave the
        gauge). Paged pipelines contribute pages-in-use x page-bytes
        (post-quantization), dense ones their full preallocation."""
        obs = _GenMetrics.get()
        total = in_use = pages = 0
        accepted = proposed = 0
        for gp in list(cls._live):
            if gp._stop.is_set():
                continue
            total += gp._safe_cache_bytes() or 0
            st = gp._cache
            if st is not None and st.alloc is not None:
                in_use += st.alloc.in_use
                pages += st.alloc.total
            if gp.engine.spec:
                accepted += gp.engine.spec_stats["accepted"]
                proposed += gp.engine.spec_stats["proposed"]
        obs.cache_bytes.set(total)
        obs.pages_in_use.set(in_use)
        obs.pages_total.set(pages)
        # 0 when no live spec engine has proposed anything — a retired
        # spec deploy's final ratio must not outlive it on dashboards
        obs.spec_accept.set(accepted / proposed if proposed else 0.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    @classmethod
    def shutdown_all(cls):
        for gp in list(cls._live):
            gp.shutdown()

    # ------------------------------------------------------------- API
    def _resolve_deadline(self, deadline_ms) -> Optional[Deadline]:
        if not self._resilience:
            return None
        ms = (deadline_ms if deadline_ms is not None
              else self.default_deadline_ms)
        return Deadline.after_ms(ms) if ms and ms > 0 else None

    def _shed(self, reason: str, tenant=None):
        _GenMetrics.get().shed[reason].inc()
        if tenant is not None:
            _qos.global_tenants().count_shed(tenant, reason)
        _faults.record_event("shed", op="generation", reason=reason)

    def _check_admission(self, tenant=None):
        if self._breaker is not None and not self._breaker.allow():
            self._shed("circuit_open", tenant=tenant)
            raise CircuitOpenError(
                "generation circuit open (consecutive decode-step "
                "failures); retry after the reset timeout")

    def _begin_session(self, prompt: np.ndarray, n_new: int, eos_id,
                       tenant, session_version, session_id):
        """Mint the durable session record for an admitted generation
        (None under ``DL4J_TPU_SESSIONS=0``)."""
        if not self._sessions:
            return None
        smod = _session_mod()
        samp = self.engine.sampler
        return smod.global_sessions().begin(
            prompt.tolist(),
            {"kind": samp.kind, "top_k": samp.top_k,
             "temperature": samp.temperature},
            getattr(self.engine, "_seed", None), n_new, eos_id,
            tenant=tenant, version=session_version, sid=session_id)

    @staticmethod
    def _session_append(req: "_GenRequest", tok: int):
        if req.session is not None:
            req.session.append(tok)

    def _run_request(self, req: "_GenRequest", obs: "_GenMetrics",
                     t0: float, span_name: str, **span_kw) -> np.ndarray:
        """Submit → await → account, shared by :meth:`generate` and
        :meth:`resume` (identical lifecycle, different admission
        preludes)."""
        # span names stay literal (bounded trace-index cardinality);
        # the two lifecycles are the only callers
        span_cm = (_span("generation_resume", **span_kw)
                   if span_name == "generation_resume"
                   else _span("generation_request", **span_kw))
        with _flight().arm(span_name), span_cm:
            req.ctx = current_context()
            req.t_enqueue_us = now_us()

            def _account(err: Optional[BaseException]):
                obs.latency.observe(time.perf_counter() - t0)
                obs.requests.inc()
                if err is not None and not isinstance(err, _TYPED_OUTCOMES):
                    obs.errors.inc()
                if req.tenant is not None:
                    reg = _qos.global_tenants()
                    reg.observe_request(req.tenant,
                                        time.perf_counter() - t0, err)
                    if req.out:
                        reg.account_tokens(req.tenant, len(req.out))
                    if req.cost_flops:
                        reg.account_cost(req.tenant, req.cost_flops)

            try:
                self._check_admission(tenant=req.tenant)
                self._enqueue(req, obs)
            except Exception as e:
                if req.session is not None:
                    req.session.finish(
                        "cancelled" if isinstance(e, _TYPED_OUTCOMES)
                        else "failed")
                _account(e)
                raise
            self._await(req)
            if req.error is not None:
                # the resolver paths (_resolve/_fail/_shed) run on the
                # decode thread; the caller's walk-away resolves HERE —
                # the session terminal status is stamped once, centrally
                if req.session is not None:
                    req.session.finish(
                        "cancelled" if isinstance(req.error,
                                                  _TYPED_OUTCOMES)
                        else "failed")
                _account(req.error)
                raise req.error
            if req.session is not None:
                req.session.finish("done")
        _account(None)
        return req.result

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 on_token=None, tenant=None,
                 session_id: Optional[str] = None,
                 session=None,
                 session_version: Optional[str] = None) -> np.ndarray:
        """Generate up to ``max_new_tokens`` continuation tokens for a
        1-D int32 ``prompt``. Blocks until the request resolves; raises
        the typed resilience outcomes (shed/deadline/circuit/shutdown)
        or the device error that killed it. Returns the emitted tokens
        (1-D int32, possibly shorter on ``eos_id``).

        ``on_token(token, index)`` (optional) streams each emitted token
        at the step boundary that produced it — the SSE per-token wire
        surface rides this. It is called from the decode-loop thread, so
        it must be fast and non-blocking (hand off to a queue, never
        write a socket inline). Returning ``False`` or raising cancels
        the request: it resolves with the typed :class:`StreamCancelled`
        and its slot frees at the boundary — the disconnect-mid-stream
        path can never leak a slot. The streamed sequence is exactly the
        returned array: same tokens, same order, nothing elided.

        Under the durable-session posture every admitted generation
        also gets a :mod:`~deeplearning4j_tpu_torch.serving.session` record
        (``session_id`` pins its id, ``session`` supplies a pre-built
        record — the adoption path — and ``session_version`` stamps the
        serving deploy it ran under); ``DL4J_TPU_SESSIONS=0`` makes all
        three inert."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must contain at least one token")
        n_new = int(max_new_tokens if max_new_tokens is not None
                    else self.default_max_new_tokens)
        if n_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # fail fast on prompts that can never decode (bucket overflow):
        # a programming error, not a load condition — never typed
        self.engine.prefill_bucket(prompt.size)
        if prompt.size + 1 > self.engine.max_len:
            raise ValueError(
                f"prompt ({prompt.size} tokens) leaves no room to "
                f"decode in a {self.engine.max_len}-token cache")
        if (self.engine.paged and self.engine.min_pages_for_prompt(
                prompt.size) > self._cache.alloc.total):
            # capacity misconfiguration, not load: this prompt could
            # never admit even into an EMPTY pool
            raise ValueError(
                f"prompt ({prompt.size} tokens) needs "
                f"{self.engine.min_pages_for_prompt(prompt.size)} pages "
                f"but the pool holds {self._cache.alloc.total}")
        obs = _GenMetrics.get()
        t0 = time.perf_counter()
        real_eos = eos_id if eos_id is not None else self.default_eos_id
        sess = session
        if self._sessions and sess is None:
            sess = self._begin_session(prompt, n_new, real_eos, tenant,
                                       session_version, session_id)
        req = _GenRequest(prompt, n_new, real_eos, on_token=on_token,
                          session=sess)
        req.deadline = self._resolve_deadline(deadline_ms)
        req.tenant = (_qos.global_tenants().resolve(tenant)
                      if self._qos else None)
        return self._run_request(req, obs, t0, "generation_request",
                                 prompt_tokens=int(prompt.size),
                                 max_new_tokens=n_new)

    def resume(self, record: dict, on_token=None,
               deadline_ms: Optional[float] = None,
               tenant=None, session=None) -> np.ndarray:
        """Re-enter a journaled session (tentpole 2/3): replay the
        journaled token log through ``on_token`` (indices ``0..k-1`` —
        the caller's ``Last-Event-ID`` window dedups what its client
        already received), then re-prefill ``prompt + emitted`` into a
        free slot and continue the stream. Under greedy the continued
        stream is byte-identical to the one the dead worker would have
        produced. Live slots are never
        disturbed — a resume is an ordinary admission into a freed slot
        (page pressure parks it exactly like any joiner).

        ``record`` is the journal/store form (``prompt``, ``tokens``,
        ``max_new_tokens``, ``eos_id``, ...); ``session`` (optional) is
        the local :class:`~deeplearning4j_tpu_torch.serving.session.Session`
        mirror the continued tokens journal into — pass the
        ``adopt_local`` result on the adoption path."""
        prompt = np.asarray(record.get("prompt") or [],
                            np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("session record has no prompt to resume")
        emitted = [int(t) for t in (record.get("tokens") or [])]
        n_new = int(record.get("max_new_tokens")
                    or self.default_max_new_tokens)
        eos = record.get("eos_id")
        eos = int(eos) if eos is not None else None

        def _replay() -> bool:
            """Push the already-emitted log through the stream; False =
            the consumer walked away."""
            if on_token is None:
                return True
            for i, t in enumerate(emitted):
                if on_token(int(t), i) is False:
                    return False
            return True

        complete = (len(emitted) >= n_new
                    or (eos is not None and emitted
                        and emitted[-1] == eos))
        if complete:
            # nothing left to decode — the record IS the result (the
            # done-status adoption / replay-only path)
            _replay()
            return np.asarray(emitted, np.int32)
        total = prompt.size + len(emitted)
        self.engine.prefill_bucket(total)
        if total + 1 > self.engine.max_len:
            raise ValueError(
                f"resumed session ({total} cached tokens) leaves no "
                f"room to decode in a {self.engine.max_len}-token cache")
        if (self.engine.paged and self.engine.min_pages_for_prompt(total)
                > self._cache.alloc.total):
            raise ValueError(
                f"resumed session ({total} tokens) needs "
                f"{self.engine.min_pages_for_prompt(total)} pages but "
                f"the pool holds {self._cache.alloc.total}")
        obs = _GenMetrics.get()
        t0 = time.perf_counter()
        if not _replay():
            # client gone before the resume even admitted — same typed
            # outcome the mid-stream walk-away gets
            raise StreamCancelled(
                "streaming consumer cancelled during session replay")
        req = _GenRequest(prompt, n_new, eos, on_token=on_token,
                          session=session, out=emitted)
        req.deadline = self._resolve_deadline(deadline_ms)
        req.tenant = (_qos.global_tenants().resolve(
            tenant if tenant is not None else record.get("tenant"))
            if self._qos else None)
        if self._sessions:
            _session_mod().session_metrics().resumes.inc()
            _faults.record_event("session_resume",
                                 sid=record.get("sid"),
                                 emitted=len(emitted))
        return self._run_request(req, obs, t0, "generation_resume",
                                 prompt_tokens=int(prompt.size),
                                 replayed_tokens=len(emitted),
                                 max_new_tokens=n_new)

    def _enqueue(self, req: _GenRequest, obs: "_GenMetrics"):
        """Bounded enqueue with the PI condition/shed semantics."""
        with self._not_full:
            while True:
                if self._stop.is_set():
                    raise ShutdownError(
                        "GenerationPipeline has been shut down")
                if req.deadline is not None and req.deadline.expired():
                    self._shed("deadline", tenant=req.tenant)
                    raise DeadlineExceeded(
                        "request expired while waiting to enqueue")
                try:
                    self._queue.put_nowait(req)
                    obs.queue_depth.set(self._queue.qsize())
                    return
                except queue.Full:
                    if self._qos and self._shed_policy is not None:
                        # tenant-aware: evict the most over-share
                        # tenant's newest request; None = the arriving
                        # tenant is itself the most over-share (under
                        # reject_oldest its OWN stale head gives way —
                        # the pre-QoS policy meaning, tenant-scoped)
                        victim = self._queue.pick_victim(req)
                        if (victim is None
                                and self._shed_policy == "reject_oldest"):
                            victim = (self._queue.pop_oldest_of(
                                req.tenant)
                                or self._queue.pop_global_oldest())
                        if victim is None:
                            self._shed("queue_full", tenant=req.tenant)
                            raise ShedError(
                                f"generation queue full "
                                f"({self._queue.maxsize} requests); "
                                "request rejected (tenant over its "
                                "fair share)")
                        self._shed_request(victim, "queue_full",
                                           ShedError(
                                               "shed from a full "
                                               "generation queue (most "
                                               "over-share tenant)"))
                        continue
                    if self._shed_policy == "reject_newest":
                        self._shed("queue_full", tenant=req.tenant)
                        raise ShedError(
                            f"generation queue full "
                            f"({self._queue.maxsize} requests); request "
                            "rejected (reject_newest)")
                    if self._shed_policy == "reject_oldest":
                        try:
                            old = self._queue.get_nowait()
                        except queue.Empty:
                            continue
                        self._shed_request(old, "queue_full", ShedError(
                            "shed from a full generation queue by a "
                            "newer request (reject_oldest)"))
                        continue
                    self._not_full.wait(timeout=0.1)

    def _await(self, req: _GenRequest):
        """Deadline-aware wait with the walk-away claim (a wedged decode
        step must not hang a deadline'd caller)."""
        if req.deadline is None:
            req.event.wait()
            return
        while not req.event.is_set():
            rem = req.deadline.remaining()
            if rem <= 0:
                break
            req.event.wait(timeout=rem)
        if not req.event.is_set():
            if req.claim():
                req.error = DeadlineExceeded(
                    "request expired while decoding")
                req.event.set()
                self._shed("deadline", tenant=req.tenant)
            else:
                req.event.wait(timeout=5.0)
                if req.error is None and req.result is None:
                    req.error = DeadlineExceeded(
                        "request expired while decoding "
                        "(resolution stalled)")

    # --------------------------------------------------- decode thread
    def _shed_request(self, req: _GenRequest, reason: str,
                      error: BaseException):
        if not req.claim():
            return
        self._shed(reason, tenant=req.tenant)
        if req.ctx is not None:
            record_span("shed", now_us(), ctx=req.ctx, reason=reason)
        req.error = error
        req.event.set()

    def _resolve(self, req: _GenRequest):
        """Successful completion (slot already freed by the caller)."""
        if not req.claim():
            return
        req.result = np.asarray(req.out, np.int32)
        req.event.set()

    @staticmethod
    def _emit_token(req: _GenRequest, tok: int) -> bool:
        """Deliver one just-appended token to the request's streaming
        callback (decode-thread context). Returns False when the
        consumer cancelled — returned False or raised — and the caller
        must shed the request (``client_gone``)."""
        cb = req.on_token
        if cb is None:
            return True
        try:
            return cb(tok, len(req.out) - 1) is not False
        # graftlint: disable=typed-errors — a broken consumer callback is
        # resolved as a client_gone shed by the caller, not swallowed
        except Exception:
            # a broken consumer must never kill the decode loop the
            # other slots are riding — treat exactly like a walk-away
            return False

    def _fail_request(self, req: _GenRequest, error: BaseException):
        if not req.claim():
            return
        req.error = error
        req.event.set()

    def _n_active(self) -> int:
        return sum(1 for r in self._slot_req if r is not None)

    def _take_request(self, timeout: float) -> Optional[_GenRequest]:
        """Pop one queued request (shedding already-expired ones), waking
        any producer parked on the full queue."""
        wait_until = time.monotonic() + timeout
        while True:
            try:
                req = self._queue.get(
                    timeout=max(0.0, wait_until - time.monotonic()))
            except queue.Empty:
                return None
            with self._not_full:
                self._not_full.notify()
            if (self._resilience and req.deadline is not None
                    and req.deadline.expired()):
                self._shed_request(req, "deadline", DeadlineExceeded(
                    "request expired waiting for a slot"))
                continue
            return req

    def _free_slot(self, slot: int):
        """Release ``slot``: request pointer, its cache pages (paged),
        and the position/token books — every slot-freeing path must go
        through here or pages leak."""
        self._slot_req[slot] = None
        self.engine.free_slot(self._cache, slot)
        self._positions[slot] = 0
        self._tokens[slot] = 0

    def _rebuild_after_fault(self, error: BaseException):
        """A device-level fault may have left the cache half-written (the
        engine writes the pool in place, K4a+w inside the attention
        launch): fail every in-flight request EXCEPT the ones a durable
        session can deterministically restore, zero the slot books, and
        build a FRESH state — the old pool is never reused. Returns the
        restorable survivors as (slot, request) for
        :meth:`_replace_survivors`. With sessions off every slot fails."""
        survivors: List[tuple] = []
        for slot, req in enumerate(self._slot_req):
            if req is not None:
                if (self._sessions and req.session is not None
                        and not req.session.stolen and not req._claimed
                        and req.resumes < 3):
                    req.resumes += 1
                    survivors.append((slot, req))
                else:
                    self._fail_request(req, error)
            self._slot_req[slot] = None
        self._tokens[:] = 0
        self._positions[:] = 0
        self._cache = self.engine.new_state(self.slots,
                                            pages=self._cache_pages)
        return survivors

    def _replace_survivors(self, survivors: List[tuple],
                           error: BaseException):
        """Restore fault survivors into the rebuilt cache, each in the
        slot it held (all slots are free when this runs), to the state
        before the failed step: ``prompt + emitted[:-1]`` is re-prefilled,
        as the reference re-prefills a survivor, and the last emitted
        token is carried (:meth:`_restore_prefill`). A survivor that
        cannot be restored — pool too small for its grown context, or its
        re-prefill fails again — resolves with the original fault (typed
        ``pages_exhausted`` for the pool)."""
        if not survivors:
            return
        _session_mod().session_metrics().resumes.inc(len(survivors))
        _faults.record_event("session_resume_inplace",
                             count=len(survivors))
        for slot, req in survivors:
            self._restore_prefill(req, slot, req.out, error)

    def _restore_prefill(self, req: _GenRequest, slot: int, emitted,
                         error: BaseException) -> bool:
        """Prefill ``prompt + emitted[:-1]`` into ``slot`` and carry
        ``emitted[-1]`` at the next position; nothing is sampled into the
        stream (the prefill's own token is a re-draw of the carry and is
        dropped). Returns False when the request resolved instead."""
        x_in = np.concatenate([req.x, np.asarray(emitted[:-1], np.int32)])
        try:
            with _span("prefill", slot=slot, phase="restore",
                       prompt_tokens=int(x_in.size)):
                _first, _logits, kv, t = self.engine.prefill(
                    x_in[None], step=self._step)
                self._cache = self.engine.insert_slot(self._cache, kv, slot)
                if self.engine.spec:
                    self.engine.insert_draft_slot(self._cache, slot,
                                                  x_in[None],
                                                  step=self._step)
        except CachePagesExhausted as e:
            self._shed_request(req, "pages_exhausted", e)
            self.engine.free_slot(self._cache, slot)
            return False
        # graftlint: disable=typed-errors — the restore failed again: the
        # request resolves with the ORIGINAL fault (as the reference's
        # re-prefill of a survivor does)
        except Exception:
            self._fail_request(req, error)
            self.engine.free_slot(self._cache, slot)
            return False
        self._slot_req[slot] = req
        self._tokens[slot] = emitted[-1]
        self._positions[slot] = t
        return True

    def _start_request(self, req: _GenRequest, slot: int) -> bool:
        """Prefill ``req`` into ``slot``'s cache pages. Returns True when
        the slot is now occupied (False: resolved without occupying)."""
        obs = _GenMetrics.get()
        if req._claimed:
            return False          # caller already walked away — no work
        req.t_slot_us = now_us()
        if req.ctx is not None:
            # the join-latency phase continuous batching exists to shrink
            record_span("slot_wait", req.t_enqueue_us, req.t_slot_us,
                        ctx=req.ctx, slot=slot)
        t0 = time.perf_counter()
        t_us = now_us()
        # a resumed request re-prefills prompt + already-emitted tokens:
        # the cache rebuilds to the state the lost slot held, and greedy
        # decoding continues the identical stream
        k_resumed = len(req.out)
        x_in = (np.concatenate([req.x, np.asarray(req.out, np.int32)])
                if k_resumed else req.x)
        try:
            with _span("prefill", slot=slot,
                       prompt_tokens=int(x_in.size)):
                first, _logits, kv, t = self.engine.prefill(
                    x_in[None], step=self._step)
        except Exception as e:
            # prefill failed BEFORE the insert wrote anything — the live
            # cache is intact, only the joiner dies
            if self._breaker is not None:
                self._breaker.record_failure()
            self._fail_request(req, e)
            return False
        try:
            with _span("prefill", slot=slot, phase="insert"):
                self._cache = self.engine.insert_slot(self._cache, kv, slot)
                if self.engine.spec:
                    # the draft tracks the same prompt in its own dense
                    # cache — a failure here cannot touch the target
                    # pool (handled below)
                    self.engine.insert_draft_slot(self._cache, slot,
                                                  x_in[None],
                                                  step=self._step)
                first_tok = int(first.cpu()[0])   # device→host sync
            dt = time.perf_counter() - t0
            if req.ctx is not None:
                record_span("prefill", t_us, now_us(), ctx=req.ctx,
                            slot=slot, prompt_tokens=int(req.x.size))
            obs.prefill_latency.observe(dt)
            _cost.global_cost_model().observe_time(PREFILL_FN, dt)
            if req.tenant is not None:
                req.cost_flops += _cost.global_cost_model().flops_for(
                    PREFILL_FN)
            if self._breaker is not None:
                self._breaker.record_success()
        except CachePagesExhausted as e:
            # raised BEFORE any device write (the paged insert checks
            # the free list first): the live cache is intact, only the
            # joiner sheds typed — _admit normally parks it first, so
            # this is the belt-and-braces path
            self._shed_request(req, "pages_exhausted", e)
            return False
        except Exception as e:
            if self._breaker is not None:
                self._breaker.record_failure()
            self._fail_request(req, e)
            if isinstance(e, (ValueError, TypeError)):
                # a POISONED REQUEST (bad shapes/dtypes/values raised by
                # validation before any device write): the live cache is
                # intact — one bad joiner must never take down every
                # in-flight stream (blast-radius fix, pinned by a test)
                return False
            # device-level: the insert may have written part of the
            # pool in place before dying — no live cache is trusted:
            # build a fresh state, restore the journaled sessions in
            # place, and fail the rest with the real insert error
            survivors = self._rebuild_after_fault(e)
            self._replace_survivors(survivors, e)
            return False
        req.out.append(first_tok)
        self._session_append(req, first_tok)
        # the generation budget may be clipped by the cache length —
        # never write a position past the pages. On resume
        # (len(out)-1 == k pre-existing tokens) the budget already spent
        # k of its allowance; the cache-room clip applies to the REST
        cap = min(req.max_new_tokens,
                  (len(req.out) - 1) + self.engine.max_len - t)
        req.max_new_tokens = cap
        done = (len(req.out) >= cap
                or (req.eos_id is not None and first_tok == req.eos_id))
        obs.tokens.inc()
        if not self._emit_token(req, first_tok):
            if done:
                self._resolve(req)       # complete anyway: result is whole
            else:
                self._shed_request(req, "client_gone", StreamCancelled(
                    "streaming consumer cancelled during prefill"))
            self.engine.free_slot(self._cache, slot)
            return False
        if done:
            self._resolve(req)
            self.engine.free_slot(self._cache, slot)
            return False
        self._slot_req[slot] = req
        self._tokens[slot] = first_tok
        self._positions[slot] = t
        return True

    def _maybe_preempt(self, pri: Optional[float] = None) -> bool:
        """Priority preemption at a step boundary (QoS posture): when
        the contending tier — the highest QUEUED tier by default, or an
        explicit ``pri`` for a page-starved parked joiner — strictly
        exceeds some active slot's tier, that slot's request is shed
        typed
        (:class:`~deeplearning4j_tpu_torch.resilience.qos.PreemptedError`) and
        the slot freed (its cache pages with it: under the paged engine
        the bottleneck is usually PAGES, not slots, and preemption must
        fire there too or the PR-12 priority guarantee silently dies in
        the default mode). The victim: among lower-tier active slots,
        the most over-share tenant's longest-running request (slot
        frees and joins already happen exactly here — the preempted
        caller resolves typed, never hangs). Default tiers (0
        everywhere) never preempt."""
        if pri is None:
            pri = self._queue.peek_priority()
        if pri is None:
            return False
        reg = _qos.global_tenants()
        active = [(slot, r) for slot, r in enumerate(self._slot_req)
                  if r is not None]
        cands = [(slot, r) for slot, r in active
                 if reg.priority(r.tenant) < pri]
        if not cands:
            return False
        counts: dict = {}
        for _, r in active:
            counts[r.tenant] = counts.get(r.tenant, 0) + 1
        wsum = sum(reg.weight(t) for t in counts) or 1.0

        def over_share(t):
            return counts[t] / max(1e-9,
                                   len(active) * reg.weight(t) / wsum)

        victim_slot, victim = max(
            cands, key=lambda sr: (over_share(sr[1].tenant),
                                   -sr[1].t_slot_us))
        self._shed_request(victim, "preempted", _qos.PreemptedError(
            f"generation slot {victim_slot} preempted by a higher-"
            f"priority tenant at a decode step boundary"))
        self._free_slot(victim_slot)
        return True

    def _admit(self):
        """Join queued requests into free slots at this step boundary.
        Paged mode admits on FREE PAGES, not free slots: a popped
        request whose prompt the pool cannot back yet is parked in
        ``_waiting`` and retried at every boundary (pages free exactly
        there) before the queue is touched — admission resumes the
        moment reclamation or completions return enough pages.
        (Blocking briefly only when the whole pipeline is idle.)"""
        while not self._stop.is_set():
            free = [i for i, r in enumerate(self._slot_req) if r is None]
            if not free:
                if self._qos and self._maybe_preempt():
                    continue       # a slot was freed — re-scan and join
                return
            req, self._waiting = self._waiting, None
            if req is not None:
                if req._claimed:
                    continue        # parked caller already walked away
                if (self._resilience and req.deadline is not None
                        and req.deadline.expired()):
                    self._shed_request(req, "deadline", DeadlineExceeded(
                        "request expired waiting for cache pages"))
                    continue
            else:
                idle = len(free) == self.slots
                req = self._take_request(timeout=0.05 if idle else 0.0)
            if req is None:
                return
            if (self.engine.paged
                    and self.engine.min_pages_for_prompt(
                        req.x.size + len(req.out))
                    > self._cache.alloc.free_count):
                # can't back the prompt yet; active slots still hold
                # pages (generate() pre-checked the empty-pool fit, so
                # an idle pipeline always admits). A higher-tier
                # tenant's joiner may PREEMPT a lower-tier slot for its
                # pages — the paged twin of the slots-full preemption
                # above (page pressure is the common overload state
                # under a bounded pool)
                if self._qos and self._maybe_preempt(
                        pri=_qos.global_tenants().priority(req.tenant)):
                    self._waiting = req
                    continue       # pages came back — retry this joiner
                self._waiting = req
                return
            _GenMetrics.get().queue_depth.set(self._queue.qsize())
            self._start_request(req, free[0])

    def _reclaim_victim_key(self, slot: int):
        """Reclamation victim ordering (max wins): shed sessions with
        NOTHING journaled before sessions the journal already made
        durable, youngest first within each class — under page pressure
        a worker sheds NEW sessions before evicting journaled ones
        (tentpole 4). With sessions off every slot is "unjournaled" and
        the key degenerates to the pre-session pure youngest-first."""
        req = self._slot_req[slot]
        unjournaled = True
        if self._sessions and req.session is not None:
            unjournaled = req.session.journaled == 0
        return (unjournaled, req.t_slot_us)

    def _reclaim_pages(self, active: List[int]) -> List[int]:
        """Step-boundary reclamation: grow every active slot's pages for
        this step's writes (spec windows reach ``spec_k`` further); on
        pool exhaustion the YOUNGEST active request is shed typed
        (:class:`CachePagesExhausted`) and its pages return to the
        pool, until the survivors fit. Returns the surviving active
        list — deterministic, oldest generations win."""
        if not self.engine.paged:
            return active
        reach = self.engine.spec_k if self.engine.spec else 0
        for slot in sorted(active,
                           key=lambda s: self._slot_req[s].t_slot_us):
            req = self._slot_req[slot]
            if req is None:
                continue            # already shed as a victim below
            last = min(int(self._positions[slot]) + reach,
                       self.engine.max_len - 1)
            while not self.engine.ensure_slot_pages(self._cache, slot,
                                                    last):
                # victim = the youngest ACTIVE request, whether or not
                # it is the one needing the page — oldest generations
                # win unconditionally (shedding an elder because a
                # newcomer grew would invert the policy)
                cands = [s for s in active
                         if self._slot_req[s] is not None]
                victim = max(cands, key=self._reclaim_victim_key)
                self._shed_request(
                    self._slot_req[victim], "pages_exhausted",
                    CachePagesExhausted(
                        "KV page pool exhausted at a decode step "
                        "boundary; request shed to reclaim pages"))
                self._free_slot(victim)
                if victim == slot:
                    break
        return [s for s in active if self._slot_req[s] is not None]

    def _sweep_finished(self, emitted: Dict[int, List[int]]):
        """Post-step bookkeeping for every stepped slot: append its
        emitted tokens IN ORDER (one for a plain decode step, up to
        ``spec_k`` for a speculative round), then resolve/free finished,
        cancelled, or expired requests. A request finishing mid-window
        simply ignores the window's tail — same semantics as plain
        decode stopping at its boundary."""
        obs = _GenMetrics.get()
        # each occupied slot owns 1/slots of the step boundary's
        # accounted FLOPs (the whole slot batch runs whether occupied or
        # not — charging per OCCUPIED slot would make a lonely tenant
        # look cheap while it monopolizes the step). A spec round ran
        # propose + verify, never the one-token decode step — charge what
        # actually executed.
        step_share = 0.0
        if self._qos:
            cm = _cost.global_cost_model()
            flops = ((cm.flops_for(VERIFY_FN) + cm.flops_for(PROPOSE_FN))
                     if self.engine.spec else cm.flops_for(DECODE_FN))
            step_share = flops / max(1, self.slots)
        for slot, toks_l in emitted.items():
            req = self._slot_req[slot]
            if req is None:
                continue
            if req._claimed:
                # another path already resolved it (the caller's
                # deadline walk-away) — stop spending device steps on a
                # request nobody will read (racy read is safe: worst
                # case is one extra step before the slot frees)
                self._free_slot(slot)
                continue
            if req.session is not None and req.session.stolen:
                # another worker fence-bumped this session away (it
                # adopted the stream mid-failover while we were merely
                # stalled): stop decoding NOW — continuing would
                # double-decode, and our journal writes are already
                # fenced off
                self._shed_request(req, "session_lost",
                                   _session_mod().SessionLost(
                                       "session adopted by another "
                                       "worker (lease fenced)"))
                self._free_slot(slot)
                continue
            if req.tenant is not None:
                req.cost_flops += step_share
            done = cancelled = False
            for tok in toks_l:
                req.out.append(int(tok))
                self._session_append(req, tok)
                obs.tokens.inc()
                done = (len(req.out) >= req.max_new_tokens
                        or (req.eos_id is not None
                            and int(tok) == req.eos_id))
                if not self._emit_token(req, int(tok)) and not done:
                    cancelled = True
                    break
                if done:
                    break
            expired = (self._resilience and req.deadline is not None
                       and req.deadline.expired())
            if cancelled:
                # consumer gone mid-stream: free the slot NOW — other
                # slots keep decoding, nothing leaks
                self._shed_request(req, "client_gone", StreamCancelled(
                    "streaming consumer cancelled mid-stream"))
                self._free_slot(slot)
            elif expired and not done:
                self._shed_request(req, "deadline", DeadlineExceeded(
                    "request expired at a decode step boundary"))
                self._free_slot(slot)
            elif done:
                self._resolve(req)
                self._free_slot(slot)

    def _decode_loop(self):
        # PyTorch's current device and grad mode are thread-local: this
        # thread starts with neither, so it sets both itself (without
        # inference_mode every step would record an autograd graph)
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        with torch.inference_mode():
            self._run_decode_loop()

    def _run_decode_loop(self):
        while not self._stop.is_set():
            # re-fetch per iteration: a registry reset mid-flight drops
            # and re-binds the singleton (on_registry_reset) — a cached
            # handle would keep writing to detached instruments
            obs = _GenMetrics.get()
            self._admit()
            active = [i for i, r in enumerate(self._slot_req)
                      if r is not None]
            obs.slots_in_use.set(len(active))
            if not active:
                continue
            try:
                if self._resilience:
                    self._retry.call(
                        lambda: _faults.check("generation.step"),
                        op="generation.step")
                active = self._reclaim_pages(active)
                if not active:
                    self._step += 1
                    self._publish_cache_bytes()
                    continue
                t0 = time.perf_counter()
                if self.engine.spec:
                    with _span("decode_step", active=len(active),
                               slots=self.slots, spec=True):
                        emitted = self.engine.spec_step(
                            self._cache, self._tokens, self._positions,
                            self._step, active)
                    for slot, toks_l in emitted.items():
                        # the last emitted token is the next carry; the
                        # cache advanced one row per emitted token
                        self._tokens[slot] = toks_l[-1]
                        self._positions[slot] += len(toks_l)
                else:
                    with _span("decode_step", active=len(active),
                               slots=self.slots):
                        tokens, _logits, self._cache = self.engine.decode(
                            self._cache, self._tokens, self._positions,
                            self._step)
                        toks = tokens.cpu().numpy()  # device→host sync
                    self._tokens[active] = toks[active]
                    self._positions[active] += 1
                    emitted = {s: [int(toks[s])] for s in active}
                dt = time.perf_counter() - t0
                obs.step_latency.observe(dt)
                obs.steps.inc()
                obs.occupancy.observe(len(active) / max(1, self.slots))
                if self.engine.spec:
                    # the round's wall time covers the propose steps +
                    # the windowed verify — book it against the verify
                    # entry (the dominant step), NEVER the
                    # one-token decode step that did not run
                    _cost.global_cost_model().observe_time(VERIFY_FN, dt)
                    if self._fresh_spec_compile():
                        self.engine.account_spec(
                            self._cache, self._tokens, self._positions,
                            self._step)
                else:
                    _cost.global_cost_model().observe_time(DECODE_FN, dt)
                    if self._fresh_decode_compile():
                        self.engine.account_decode(
                            self._cache, self._tokens, self._positions,
                            self._step)
                if self._breaker is not None:
                    self._breaker.record_success()
                _flight().progress("generation_step")
            # graftlint: disable=typed-errors — the catch must be broad
            # (any step fault may leave the cache half-written); the
            # taxonomy is resolved per-request via _fail_request /
            # _shed_request
            except Exception as e:
                if (self._breaker is not None
                        and not isinstance(e, _TYPED_OUTCOMES)):
                    self._breaker.record_failure()
                # the step may have died mid-write (the cache is written
                # in place): build a fresh state, restore the journaled
                # sessions in their slots, and fail the rest (queued
                # requests are untouched; the fresh state resets the page
                # allocator and, in spec mode, the draft cache with it).
                # The step number is NOT advanced: the restored slots run
                # the failed step again with the same sampling draws.
                survivors = self._rebuild_after_fault(e)
                self._replace_survivors(survivors, e)
                self._notify_journal()
                self._publish_cache_bytes()
                continue
            self._step += 1
            self._sweep_finished(emitted)
            self._notify_journal()
            self._publish_cache_bytes()
        # shutdown: resolve whatever still occupies a slot (and the
        # parked joiner the pool never backed)
        for slot, req in enumerate(self._slot_req):
            if req is not None:
                self._fail_request(req, ShutdownError(
                    "GenerationPipeline shut down"))
                self._slot_req[slot] = None
        if self._waiting is not None:
            self._fail_request(self._waiting, ShutdownError(
                "GenerationPipeline shut down"))
            self._waiting = None

    def _notify_journal(self):
        """Step-boundary poke for the session journal writer — an
        ``Event.set``, the only hot-path cost journaling adds to the
        decode loop (the batched store write happens on the journal's
        own thread)."""
        if self._sessions:
            _session_mod().global_journal().notify()

    def _fresh_decode_compile(self) -> bool:
        """True when compile_watch counted a new decode signature the cost
        model has not accounted yet (kept cheap: one counter compare)."""
        try:
            return _cost.global_cost_model().needs_account(DECODE_FN,
                                                           DECODE_FN)
        except Exception:  # graftlint: disable=typed-errors — best-effort
            return False   # cost-telemetry probe; no request outcome here

    def _fresh_spec_compile(self) -> bool:
        """The spec twin: a new propose OR verify signature pending cost
        accounting."""
        try:
            cm = _cost.global_cost_model()
            return (cm.needs_account(VERIFY_FN, VERIFY_FN)
                    or cm.needs_account(PROPOSE_FN, PROPOSE_FN))
        except Exception:  # graftlint: disable=typed-errors — best-effort
            return False   # cost-telemetry probe; no request outcome here

    # -------------------------------------------------------- lifecycle
    def shutdown(self):
        self._stop.set()
        with self._not_full:
            self._not_full.notify_all()
        self._thread.join(timeout=5.0)
        if self._breaker is not None:
            self._breaker.retire()
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            self._fail_request(req, ShutdownError(
                "GenerationPipeline shut down"))
        _GenMetrics.get().queue_depth.set(self._queue.qsize())
        self._publish_cache_bytes()

    def snapshot(self) -> dict:
        """Live pipeline state (``/debug/generation`` + the
        flight-recorder ``generation.json`` payload)."""
        slots = []
        tenants: dict = {}
        for i, req in enumerate(self._slot_req):
            if req is None:
                slots.append({"slot": i, "state": "free"})
            else:
                slots.append({
                    "slot": i, "state": "decoding",
                    "position": int(self._positions[i]),
                    "generated": len(req.out),
                    "max_new_tokens": req.max_new_tokens,
                    "tenant": req.tenant,
                    "session": (req.session.sid
                                if req.session is not None else None),
                    "resumes": req.resumes,
                    "trace_id": (req.ctx.trace_id
                                 if req.ctx is not None else None)})
                if req.tenant is not None:
                    t = tenants.setdefault(req.tenant,
                                           {"active_slots": 0,
                                            "queued": 0})
                    t["active_slots"] += 1
        if self._qos:
            for t, n in self._queue.tenant_sizes().items():
                tenants.setdefault(t, {"active_slots": 0,
                                       "queued": 0})["queued"] = n
        eng = self.engine
        pages = None
        st = self._cache
        if eng.paged and st is not None and st.alloc is not None:
            pages = {
                "page_tokens": eng.page_tokens,
                "pages_per_slot": eng.pages_per_slot,
                "in_use": st.alloc.in_use,
                "total": st.alloc.total,
                "page_bytes": eng.page_bytes(),
                "quant": bool(eng.kv_quant),
                "quant_gate": eng.quant_gate,
                "waiting_for_pages": self._waiting is not None,
                "slot_pages": [len(p) for p in st.slot_pages],
            }
        spec = None
        if eng.draft is not None:
            ratio = eng.spec_accept_ratio()
            spec = {
                "enabled": eng.spec,
                "spec_k": eng.spec_k,
                "rounds": eng.spec_stats["rounds"],
                "proposed": eng.spec_stats["proposed"],
                "accepted": eng.spec_stats["accepted"],
                "accept_ratio": (round(ratio, 4)
                                 if ratio is not None else None),
            }
        return {
            "qos": self._qos,
            "sessions": self._sessions,
            "tenants": tenants,
            "slots": self.slots,
            "active": self._n_active(),
            "queue_depth": self._queue.qsize(),
            "step": self._step,
            "max_len": self.engine.max_len,
            "prefill_buckets": list(self.engine.prefill_buckets),
            "sampler": {"kind": self.engine.sampler.kind,
                        "top_k": self.engine.sampler.top_k,
                        "temperature": self.engine.sampler.temperature},
            "cache_bytes": self._safe_cache_bytes(),
            "pool_bytes": self._safe_pool_bytes(),
            "pages": pages,
            "spec": spec,
            "slot_table": slots,
        }

    def _safe_cache_bytes(self):
        """The decode thread may be mid-step (the cache being rebuilt)
        when a /debug or bundle snapshot races this read — answer None
        for that instant rather than raising into the dump. Reports
        ACTUAL resident bytes (paged: pages in use x page bytes)."""
        try:
            return self.engine.resident_cache_bytes(self._cache)
        except Exception:  # graftlint: disable=typed-errors — snapshot
            return None    # reader racing the decode thread; answers None

    def _safe_pool_bytes(self):
        """Worst-case device footprint (the whole pool + draft cache) —
        the snapshot reports it next to the resident number."""
        try:
            return DecodeEngine.cache_bytes(self._cache)
        except Exception:  # graftlint: disable=typed-errors — snapshot
            return None    # reader racing the decode thread; answers None

    @classmethod
    def live_snapshots(cls) -> list:
        return [gp.snapshot() for gp in list(cls._live)
                if not gp._stop.is_set()]
