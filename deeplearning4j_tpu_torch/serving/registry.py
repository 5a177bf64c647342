"""Versioned model registry: deploy with warm-up, retire with drain.

Counterpart of ``deeplearning4j_tpu/serving/registry.py`` for generative
versions. :meth:`ModelRegistry.deploy_generative` builds a
``GenerationPipeline`` over a ``DecodeEngine`` and runs the engine's
whole step set once (``DecodeEngine.warm``: every prefill bucket, the
slot insert, the decode step and, with a draft, the speculative pair)
before the version admits traffic, so the first real request pays no
first-call cost — library handles, allocator growth, the int8 quant
gate. ``compile_watch`` notes each warm-up step with the cause
``serving_warmup``, as the reference does.

What the port leaves out, and why:

- The reference's persistent XLA compile cache
  (``async_runtime.configure_compile_cache``, ``DL4J_TPU_COMPILE_CACHE``)
  has no counterpart: the port runs eager steps and has no compiled
  executables to keep on disk. ``snapshot()`` keeps the
  ``compile_cache_dir`` key, always ``None``.
- The scoring lane, ``deploy`` and its bucket ``_warmup``, serves a
  DL4J network through ``ParallelInference``, which the port does not
  have yet (ROADMAP queue 1 item 8); a version here is always
  generative.

Retire goes through **graceful drain**: the version stops admitting, the
router's in-flight requests complete (bounded wait on the version's
in-flight count), any stragglers resolve with the typed
``ShutdownError`` via ``GenerationPipeline.shutdown`` — never dropped,
never double-resolved — and only then do the decode thread, breaker and
KV-cache pages release.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observability import compile_watch as _cw
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience.policy import CircuitBreaker
from deeplearning4j_tpu_torch.serving.metrics import serving_metrics

#: version lifecycle states, in order
WARMING, LIVE, DRAINING, RETIRED = "warming", "live", "draining", "retired"


class DeployedVersion:
    """One live model version: its ``GenerationPipeline`` (generative
    decode), lifecycle state, warmup record, and the in-flight count
    graceful drain waits on. The router enters :meth:`track` around
    every request it sends here."""

    def __init__(self, version: str, net, gp):
        self.version = version
        self.net = net
        self.gp = gp
        self.kind = "generative"
        self.state = WARMING
        self.admitting = False
        self.deployed_at = time.time()
        self.warmup_seconds: Optional[float] = None
        self.warmed_buckets: List[int] = []
        self._cond = threading.Condition()
        self._inflight = 0
        self._drain_done = threading.Event()

    @contextlib.contextmanager
    def track(self):
        """Count one request in flight on this version (drain barrier)."""
        with self._cond:
            self._inflight += 1
        try:
            yield
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Stop admitting, wait for in-flight requests to resolve, then
        release the serve pipeline. Returns True when the drain emptied
        cleanly; on timeout the shutdown still resolves every straggler
        with the typed ``ShutdownError`` (claimed exactly once). A
        second caller racing an in-progress drain (a retire() landing
        during a rollback) WAITS for that drain to finish instead of
        reporting success while requests are still in flight."""
        self.admitting = False
        with self._cond:
            if self.state == RETIRED:
                return True
            if self.state == DRAINING:
                owner = False
            else:
                self.state = DRAINING
                owner = True
        if not owner:
            self._drain_done.wait(max(0.0, timeout_s) + 10.0)
            return self.state == RETIRED
        _faults.record_event("serving_drain", version=self.version,
                             inflight=self.inflight())
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            drained = self._inflight == 0
        if self.gp is not None:
            self.gp.shutdown()
        with self._cond:
            self.state = RETIRED
        # release the strong refs so the device buffers (the KV-cache
        # pages) can go with the version (callers keep their own net
        # reference)
        self.gp = None
        self.net = None
        self._drain_done.set()
        return drained

    def snapshot(self) -> dict:
        return {
            "version": self.version,
            "kind": self.kind,
            "state": self.state,
            "admitting": self.admitting,
            "deployed_at": self.deployed_at,
            "warmup_seconds": self.warmup_seconds,
            "warmed_buckets": list(self.warmed_buckets),
            "inflight": self.inflight(),
        }


class ModelRegistry:
    """Holds N live versions; ``deploy`` warms, ``retire`` drains."""

    _live: "weakref.WeakSet[ModelRegistry]" = weakref.WeakSet()

    def __init__(self):
        self._versions: Dict[str, DeployedVersion] = {}
        self._reserving: set = set()    # names mid-deploy (TOCTOU guard)
        self._lock = threading.Lock()
        ModelRegistry._live.add(self)

    # ------------------------------------------------------------- deploy
    def _deploy_scaffold(self, version: str, build, warm) -> DeployedVersion:
        """The shared deploy lifecycle both deploy kinds run: one atomic
        name reservation (a concurrent deploy of the same name must fail
        HERE, not both build a pipeline and silently orphan one),
        registration, warmup with
        cleanup-on-failure (a version that failed to warm must not
        linger in WARMING with live serve threads, nor block a redeploy
        of its name), and the LIVE/admitting flip. ``build()`` returns
        the :class:`DeployedVersion`; ``warm(dv)`` returns the
        warmed-bucket list."""
        with self._lock:
            existing = self._versions.get(version)
            if (version in self._reserving
                    or (existing is not None
                        and existing.state != RETIRED)):
                state = ("deploying" if version in self._reserving
                         else existing.state)
                raise ValueError(f"version {version!r} already deployed "
                                 f"(state={state})")
            self._reserving.add(version)
        try:
            dv = build()
            with self._lock:
                self._versions[version] = dv
            t0 = time.perf_counter()
            try:
                dv.warmed_buckets = warm(dv)
            except Exception:
                dv.drain(timeout_s=0.0)
                with self._lock:
                    self._versions.pop(version, None)
                raise
            dv.warmup_seconds = time.perf_counter() - t0
        finally:
            with self._lock:
                self._reserving.discard(version)
        serving_metrics().warmup_seconds(version).set(dv.warmup_seconds)
        dv.state = LIVE
        dv.admitting = True
        return dv

    # -------------------------------------------------- generative deploy
    def deploy_generative(self, version: str, engine, warmup: bool = True,
                          **gp_kwargs) -> DeployedVersion:
        """Deploy a generative version: a
        :class:`~deeplearning4j_tpu_torch.parallel.generation.GenerationPipeline`
        over ``engine`` (a ``DecodeEngine``), running every prefill
        length bucket, the slot insert and the decode step once before
        the version admits traffic — the first real ``generate`` request
        runs no step signature for the first time. A speculative engine
        (built with a ``draft=``) warms the PAIR: the draft's
        prefill/insert set, the propose steps and the windowed verify
        step all run here, and retire's drain releases draft and target
        together (the engine owns both). The int8 KV
        numerics gate also runs here (first cache build), so a
        quant fallback is decided before traffic, never under it.
        ``gp_kwargs`` pass through to the pipeline constructor
        (``cache_pages=`` sizes the paged admission pool); a
        per-version circuit breaker is installed unless the caller
        provides one."""
        from deeplearning4j_tpu_torch.parallel.generation import GenerationPipeline

        def build():
            gp_kwargs.setdefault(
                "breaker", CircuitBreaker(f"generation.step:{version}"))
            gp = GenerationPipeline(engine, **gp_kwargs)
            return DeployedVersion(version, engine.model, gp)

        def warm(dv):
            if warmup:
                return self._warmup_generative(engine, dv.gp.slots)
            return []

        dv = self._deploy_scaffold(version, build, warm)
        _faults.record_event("serving_deploy", version=version,
                             generative=True,
                             warmup_seconds=round(dv.warmup_seconds, 4),
                             buckets=len(dv.warmed_buckets))
        return dv

    @staticmethod
    def _warmup_generative(engine, slots: int) -> List[int]:
        """Run the whole generative step set off the traffic path
        (``DecodeEngine.warm``); each first run it provokes is claimed
        as a warmup so /debug/compiles names the deploy behind it."""
        return engine.warm(
            slots, note=lambda **a: _cw.note_cause("serving_warmup", **a))

    # ------------------------------------------------------------ queries
    def get(self, version: str) -> DeployedVersion:
        with self._lock:
            dv = self._versions.get(version)
        if dv is None:
            raise KeyError(f"no deployed version {version!r}")
        return dv

    def versions(self) -> List[str]:
        with self._lock:
            return sorted(self._versions)

    def live_versions(self) -> List[str]:
        with self._lock:
            return sorted(v for v, dv in self._versions.items()
                          if dv.state == LIVE)

    # ------------------------------------------------------------- retire
    def retire(self, version: str, drain_timeout_s: float = 5.0) -> bool:
        """Graceful removal: drain (see :meth:`DeployedVersion.drain`)
        and forget the version. Returns True when the drain emptied
        before the timeout."""
        dv = self.get(version)
        drained = dv.drain(timeout_s=drain_timeout_s)
        with self._lock:
            self._versions.pop(version, None)
        _faults.record_event("serving_retire", version=version,
                             drained=drained)
        return drained

    def shutdown(self, drain_timeout_s: float = 5.0):
        """Retire every version (test teardown / process exit)."""
        for version in self.versions():
            try:
                self.retire(version, drain_timeout_s=drain_timeout_s)
            except KeyError:
                pass

    def snapshot(self) -> dict:
        with self._lock:
            versions = [dv.snapshot() for _, dv in sorted(
                self._versions.items())]
        return {"versions": versions,
                # no compile cache in the port (module doc)
                "compile_cache_dir": None}
