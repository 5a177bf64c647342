"""ServingRouter: the versioned ``generate()`` front-end.

Counterpart of ``deeplearning4j_tpu/serving/router.py``'s generative
lane. Composes the registry's versions with the policies that already
live inside each ``GenerationPipeline`` (per-request deadlines, bounded
queues/shedding, a per-version circuit breaker) and adds the rollout
split on top:

- traffic is split **deterministically by request hash** — the same
  request (or explicit ``request_key``) always lands on the same
  version, so a client retry during a rollout cannot flap between
  models;
- the candidate path fires the ``serving.canary`` chaos point, so a
  rollout can be rehearsed under injected latency/error faults and the
  SLO gate proven to roll back;
- every routed request lands in the ``dl4j_serving_version_*`` series
  the rollout grader reads.

The reference's scoring lane (``output``, ``_serve``, ``_shadow_score``,
``output_on``) serves a DL4J network through ``ParallelInference`` and
comes with it (ROADMAP queue 1 item 8).

Kill switch ``DL4J_TPU_ROLLOUT=0`` (resolved at construction, like the
other hot-path switches): ``generate()`` is a passthrough to the primary
version's ``GenerationPipeline.generate`` — no hashing, no extra series,
no fault point — and ``begin_rollout`` refuses.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
import weakref
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience.policy import (TYPED_OUTCOMES,
                                                  ShutdownError)
from deeplearning4j_tpu_torch.serving.errors import RolloutConflictError
from deeplearning4j_tpu_torch.serving.metrics import serving_metrics
from deeplearning4j_tpu_torch.serving.rollout import (CanaryRollout, RolloutPolicy,
                                                RolloutState)

#: excluded from the per-version error counters — THE shared tuple from
#: resilience.policy, so this surface cannot diverge from
#: dl4j_inference_errors_total (typed outcomes are routing results, not
#: model failures; InjectedFault and real device errors DO count)
_TYPED_OUTCOMES = TYPED_OUTCOMES


def rollout_enabled() -> bool:
    """``DL4J_TPU_ROLLOUT`` kill switch (``0`` = single-version
    passthrough, byte-identical to direct ``GenerationPipeline`` use)."""
    return os.environ.get("DL4J_TPU_ROLLOUT", "1") != "0"


def request_fraction(x, request_key=None) -> float:
    """Deterministic [0, 1) routing coordinate for one request: the hash
    of ``request_key`` when given, else of the request payload (a bounded
    prefix of the bytes + shape/dtype — enough that distinct requests
    spread uniformly while the same request always routes the same
    way)."""
    if request_key is not None:
        data = repr(request_key).encode()
    else:
        arr = np.asarray(x)
        data = (arr.tobytes()[:4096] + str(arr.shape).encode()
                + str(arr.dtype).encode())
    digest = hashlib.blake2b(data, digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64


class ServingRouter:
    """Routes ``generate()`` across a registry's versions; owns at most
    one active :class:`CanaryRollout` at a time."""

    _live: "weakref.WeakSet[ServingRouter]" = weakref.WeakSet()

    def __init__(self, registry, primary: str):
        self._registry = registry
        self._primary = registry.get(primary)
        self._enabled = rollout_enabled()
        self._rollout: Optional[CanaryRollout] = None
        self._lock = threading.Lock()
        ServingRouter._live.add(self)
        if self._enabled:
            serving_metrics().traffic(self._primary.version).set(1.0)

    @property
    def primary(self):
        return self._primary

    @property
    def rollout(self) -> Optional[CanaryRollout]:
        return self._rollout

    # ------------------------------------------------------------ rollout
    def begin_rollout(self, candidate: str,
                      policy: Optional[RolloutPolicy] = None) -> CanaryRollout:
        """Start canarying ``candidate`` against the current primary."""
        if not self._enabled:
            raise RolloutConflictError(
                "rollouts are disabled (DL4J_TPU_ROLLOUT=0): deploy/retire "
                "still work, but traffic stays on the primary version")
        with self._lock:
            if self._rollout is not None and self._rollout.active:
                raise RolloutConflictError(
                    f"a rollout of {self._rollout.candidate.version!r} is "
                    "already active")
            cand = self._registry.get(candidate)
            if cand is self._primary:
                raise ValueError("candidate is already the primary")
            if cand.kind != self._primary.kind:
                # a mis-kinded rollout would fail every canary-routed
                # request with a wiring error the SLO gate never sees
                # (raised before the per-version accounting) — refuse at
                # the door instead
                raise ValueError(
                    f"candidate {candidate!r} is a {cand.kind} deploy "
                    f"but the primary {self._primary.version!r} is "
                    f"{self._primary.kind} — rollouts must not change "
                    "the serving surface")
            if not cand.admitting:
                raise RolloutConflictError(
                    f"candidate {candidate!r} is not live "
                    f"(state={cand.state})")
            self._rollout = CanaryRollout(self, self._registry,
                                          self._primary, cand,
                                          policy or RolloutPolicy())
            return self._rollout

    def _promote(self, rollout: CanaryRollout):
        """Rollout hit FULL: the candidate becomes primary and the old
        incumbent drains gracefully (in-flight requests complete)."""
        old, self._primary = self._primary, rollout.candidate
        old.drain(timeout_s=rollout.policy.drain_timeout_s)

    # ----------------------------------------------------------- generate
    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 request_key=None, on_token=None,
                 tenant=None, session_id: Optional[str] = None) -> np.ndarray:
        """Route one generation request across the registry's
        GENERATIVE versions — same deterministic hash split, per-version
        series, canary chaos point, and SLO-graded rollout as the
        reference's scoring ``output``; shadow scoring compares the full
        emitted token sequence (any mismatch is a divergence — sampled decode shadows
        should pin greedy or share the engine seed). ``on_token``
        streams per-token at step boundaries (the HTTP/SSE surface) —
        threaded to whichever version the hash split serves; shadow
        generations never stream."""
        if not self._enabled:
            # kind mismatch = ValueError, a drained generative primary =
            # typed ShutdownError
            if self._primary.kind != "generative":
                raise ValueError(
                    f"version {self._primary.version!r} is a "
                    f"{self._primary.kind} deploy — generate() needs a "
                    "deploy_generative version")
            gp = self._primary.gp
            if gp is None:
                raise ShutdownError(
                    f"version {self._primary.version!r} is not admitting "
                    f"generation (state={self._primary.state})")
            return gp.generate(
                prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                deadline_ms=deadline_ms, on_token=on_token, tenant=tenant,
                session_id=session_id,
                session_version=self._primary.version)
        rollout = self._rollout
        if rollout is None or not rollout.active:
            return self._serve_gen(self._primary, prompt, max_new_tokens,
                                   eos_id, deadline_ms, on_token=on_token,
                                   tenant=tenant, session_id=session_id)
        rollout.maybe_timed_evaluate()
        frac = request_fraction(prompt, request_key)
        candidate = rollout.candidate
        if (rollout.share > 0.0 and frac < rollout.share
                and candidate.admitting):
            try:
                return self._serve_gen(candidate, prompt, max_new_tokens,
                                       eos_id, deadline_ms, canary=True,
                                       on_token=on_token, tenant=tenant,
                                       session_id=session_id)
            finally:
                rollout.record_candidate_event()
        out = self._serve_gen(self._primary, prompt, max_new_tokens,
                              eos_id, deadline_ms, on_token=on_token,
                              tenant=tenant, session_id=session_id)
        if (rollout.stage == RolloutState.SHADOW and candidate.admitting
                and frac < rollout.policy.shadow_fraction):
            # shadow work must never affect the user's response — and a
            # full multi-token shadow GENERATION is seconds, not the one
            # extra forward the scoring shadow costs. Run it off-path;
            # the candidate event records when the shadow resolves, so
            # windows grade against metrics that exist.
            def _shadow(prompt=prompt, out=out):
                try:
                    self._shadow_generate(rollout, prompt, max_new_tokens,
                                          eos_id, out)
                finally:
                    rollout.record_candidate_event()

            threading.Thread(target=_shadow, daemon=True,
                             name="dl4j-shadow-generate").start()
        return out

    def _serve_gen(self, dv, prompt, max_new_tokens, eos_id, deadline_ms,
                   canary: bool = False, on_token=None,
                   tenant=None, session_id=None) -> np.ndarray:
        if dv.kind != "generative":
            # a wiring error, not a lifecycle state — never typed
            raise ValueError(
                f"version {dv.version!r} is a {dv.kind} deploy — "
                "generate() needs a deploy_generative version")
        gp = dv.gp
        if not dv.admitting or gp is None:
            raise ShutdownError(
                f"version {dv.version!r} is not admitting generation "
                f"(state={dv.state})")
        t0 = time.perf_counter()
        try:
            with dv.track():
                if canary and _faults.armed():
                    _faults.check("serving.canary")
                out = gp.generate(prompt, max_new_tokens=max_new_tokens,
                                  eos_id=eos_id, deadline_ms=deadline_ms,
                                  on_token=on_token, tenant=tenant,
                                  session_id=session_id,
                                  session_version=dv.version)
        except Exception as e:
            self._account(dv, t0, error=e)
            raise
        self._account(dv, t0)
        return out

    def _shadow_generate(self, rollout: CanaryRollout, prompt,
                         max_new_tokens, eos_id, incumbent_out):
        """Shadow-score one generation on the candidate (absorbed
        errors, exact-sequence divergence)."""
        dv = rollout.candidate
        obs = serving_metrics()
        gp = dv.gp
        if gp is None:
            return
        t0 = time.perf_counter()
        try:
            with dv.track():
                if _faults.armed():
                    _faults.check("serving.canary")
                out = gp.generate(prompt, max_new_tokens=max_new_tokens,
                                  eos_id=eos_id)
        # graftlint: disable=typed-errors — shadow traffic: a candidate
        # failure is SCORED (error counted per version), never allowed
        # to touch the incumbent's already-delivered response
        except Exception as e:
            self._account(dv, t0, error=e)
            obs.shadow(dv.version, "error").inc()
            return
        self._account(dv, t0)
        match = bool(np.array_equal(np.asarray(out),
                                    np.asarray(incumbent_out)))
        obs.shadow(dv.version, "match" if match else "diverged").inc()

    @staticmethod
    def _account(dv, t0: float, error: Optional[BaseException] = None):
        """One routed request's per-version accounting (success and
        every error path share it): latency + requests always, errors
        only for non-typed failures."""
        obs = serving_metrics()
        obs.latency(dv.version).observe(time.perf_counter() - t0)
        obs.requests(dv.version).inc()
        if error is not None and not isinstance(error, _TYPED_OUTCOMES):
            obs.errors(dv.version).inc()

    # ----------------------------------------------- shared-store serving
    # The multi-process front door routes by the SHARED store's stage and
    # share (every worker must agree on the split), then serves the
    # chosen version through these — the same per-version accounting,
    # drain tracking, and canary chaos point as the local rollout path,
    # without the local CanaryRollout state machine (the store's leader
    # grades the fleet-aggregated windows instead).

    def generate_on(self, version: str, prompt,
                    max_new_tokens: Optional[int] = None,
                    eos_id: Optional[int] = None,
                    deadline_ms: Optional[float] = None,
                    canary: bool = False, on_token=None,
                    tenant=None,
                    session_id: Optional[str] = None) -> np.ndarray:
        """Serve one generation request on the NAMED version."""
        return self._serve_gen(self._registry.get(version), prompt,
                               max_new_tokens, eos_id, deadline_ms,
                               canary=canary, on_token=on_token,
                               tenant=tenant, session_id=session_id)

    def resume_on(self, version: str, record: dict, on_token=None,
                  deadline_ms: Optional[float] = None, tenant=None,
                  session=None) -> np.ndarray:
        """Resume an ADOPTED session record on the NAMED version
        (fleet failover: the dead worker's journal, this worker's
        slots) — the same per-version accounting and drain tracking as
        :meth:`generate_on`, entering the pipeline through
        ``GenerationPipeline.resume``."""
        dv = self._registry.get(version)
        if dv.kind != "generative":
            raise ValueError(
                f"version {dv.version!r} is a {dv.kind} deploy — "
                "resume_on() needs a deploy_generative version")
        gp = dv.gp
        if not dv.admitting or gp is None:
            raise ShutdownError(
                f"version {dv.version!r} is not admitting generation "
                f"(state={dv.state})")
        t0 = time.perf_counter()
        try:
            with dv.track():
                out = gp.resume(record, on_token=on_token,
                                deadline_ms=deadline_ms, tenant=tenant,
                                session=session)
        except Exception as e:
            self._account(dv, t0, error=e)
            raise
        self._account(dv, t0)
        return out

    def repoint(self, version: str):
        """Re-point the primary at ``version`` (shared-store promotion:
        the store's leader declared FULL; this worker adopts it and the
        caller drains the old incumbent). Refuses a non-admitting or
        mis-kinded target — the same wiring guards begin_rollout makes."""
        with self._lock:
            dv = self._registry.get(version)
            if dv is self._primary:
                return
            if dv.kind != self._primary.kind:
                raise ValueError(
                    f"version {version!r} is a {dv.kind} deploy but the "
                    f"primary {self._primary.version!r} is "
                    f"{self._primary.kind} — repoint must not change the "
                    "serving surface")
            if not dv.admitting:
                raise ShutdownError(
                    f"version {version!r} is not admitting "
                    f"(state={dv.state})")
            self._primary = dv
            if self._enabled:
                serving_metrics().traffic(dv.version).set(1.0)

    # ------------------------------------------------------------ queries
    def snapshot(self) -> dict:
        rollout = self._rollout
        return {
            "enabled": self._enabled,
            "primary": self._primary.version,
            "primary_state": self._primary.state,
            "rollout": rollout.snapshot() if rollout is not None else None,
        }
