"""Flight recorder: hang watchdog + postmortem bundles.

A hung or crashed run used to leave nothing to debug from — the span ring,
the metrics registry, and every thread's stack die with the process (or
spin silently forever). The flight recorder is the always-on black box
(the production-monitoring posture of Abadi et al. arXiv:1605.08695 §9;
the postmortem decomposition mirrors the characterization data of Awan et
al. arXiv:1810.11112):

- **Watchdog**: training fit loops and ``ParallelInference`` requests
  *arm* the recorder while work is logically in flight and *progress* it
  on every completed step / device batch. An armed operation with no
  progress on ITS channels (``_PROGRESS_CHANNELS``: fits listen to
  train_step, requests to inference_batch — serving traffic completing
  cannot mask a wedged collective) for ``DL4J_TPU_HANG_SECONDS``
  (default 300) ⇒ one postmortem bundle per operation per stall episode.
  Idle processes (armed count 0) never false-positive.
- **Crash hooks**: ``sys.excepthook`` / ``threading.excepthook`` wrappers
  dump on fatal exceptions (then chain to the previous hooks), and an
  ``atexit`` hook dumps when ``DL4J_TPU_POSTMORTEM_ON_EXIT=1``.
- **Manual**: :meth:`FlightRecorder.dump` any time; ``UIServer`` exposes
  it at ``GET /debug/dump`` for live triage.

A bundle is a directory under ``DL4J_TPU_POSTMORTEM_DIR`` (default
``<tmpdir>/dl4j-tpu-postmortem``) containing:

- ``trace.json``   — Chrome trace of the global span ring (open in Perfetto)
- ``metrics.prom`` — Prometheus snapshot of the global registry
- ``threads.txt``  — every thread's Python stack (``sys._current_frames``)
- ``config.json``  — reason, armed operations, progress counters, the
  async-runtime knob snapshot (the fit loops' knobs), SLO health report,
  device-memory snapshot, and the ``DL4J_TPU_*`` environment
- ``compiles.json`` — compile-watch ring: the first run of every
  engine step signature, with the args' shapes
- ``deploy.json`` — versioned serving: deployed versions (lifecycle,
  warmup, in-flight), rollout stage/share and its SLO verdicts
- ``numerics.json`` — recent non-finite loss/grad events + last published
  numerics health per model kind
- ``resilience.json`` — fault plan + injection counts, circuit-breaker
  states, and the resilience event ring (retries, sheds, breaker
  transitions, restores, quarantines)
- ``tenants.json`` — multi-tenant QoS: per-tenant policies (weights,
  tiers, quotas), live bucket levels, and request/token/shed/cost
  counters (a death under load must name who was flooding)
- ``frontdoor.json`` — the HTTP serving front door: in-flight gate,
  lane routers, and the shared-store fleet view (multi-process mode)
- ``fleet.json`` — the fleet robustness layer: leader lease/term,
  demotions, store corruption/rebuild evidence, idempotency journal
- ``timeseries.json`` — the ringed registry timeseries and the
  watchtower's alert state (when the watchtower is enabled)
- ``generation.json`` — the generative decode layer: per-pipeline slot
  tables (who was decoding, at which position), queue depth, cache size
- ``sessions.json`` — the durable generation sessions: journal
  attachment, per-session status/seq/fence (what a survivor can adopt)
- ``perf.json`` — the cost observatory: per-entry-point FLOPs/bytes,
  live MFU vs. its rolling baseline, and roofline verdicts (was the
  process slow BEFORE it died?)

- ``traces.json`` — the trace store's pinned and recent traces (when
  ``trace_store`` is enabled)

The port's copy leaves out the reference's ``elastic.json`` section:
the elastic layer is not ported yet (ROADMAP queue 1 item 7B).

Kill switch: ``DL4J_TPU_FLIGHT_RECORDER=0`` disables the watchdog and the
crash hooks; explicit ``dump()`` calls always work.
"""
from __future__ import annotations

import atexit
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observability.registry import global_registry

DEFAULT_HANG_SECONDS = 300.0
DEFAULT_KEEP_BUNDLES = 8


def _keep_bundles() -> int:
    try:
        return max(1, int(os.environ.get("DL4J_TPU_POSTMORTEM_KEEP",
                                         DEFAULT_KEEP_BUNDLES)))
    except (TypeError, ValueError):
        return DEFAULT_KEEP_BUNDLES


def recorder_enabled() -> bool:
    """Watchdog/hook kill switch (read per call so tests can flip it)."""
    return os.environ.get("DL4J_TPU_FLIGHT_RECORDER", "1") != "0"


def postmortem_dir() -> str:
    return (os.environ.get("DL4J_TPU_POSTMORTEM_DIR")
            or os.path.join(tempfile.gettempdir(), "dl4j-tpu-postmortem"))


#: which progress channels prove an armed operation is alive, keyed by the
#: category before the ":" in its arm kind. An armed fit is only alive if
#: TRAIN STEPS land — inference batches completing elsewhere in the process
#: must not mask a wedged collective (and vice versa). Unknown categories
#: fall back to any-progress.
_PROGRESS_CHANNELS = {
    "fit": ("train_step",),
    "inference_request": ("inference_batch",),
    "generation_request": ("generation_step",),
}


class _Armed:
    """``with recorder.arm("fit:MLN"):`` — armed for the block's duration."""

    __slots__ = ("_rec", "_kind")

    def __init__(self, rec: "FlightRecorder", kind: str):
        self._rec = rec
        self._kind = kind

    def __enter__(self):
        self._rec._arm(self._kind)
        return self._rec

    def __exit__(self, *exc):
        self._rec._disarm(self._kind)
        return False


class FlightRecorder:
    """See module doc. One process-wide instance via
    :func:`global_flight_recorder`; tests construct their own with short
    thresholds."""

    def __init__(self, hang_seconds: Optional[float] = None,
                 check_interval: Optional[float] = None,
                 out_dir: Optional[str] = None):
        if hang_seconds is None:
            try:
                hang_seconds = float(os.environ.get(
                    "DL4J_TPU_HANG_SECONDS", DEFAULT_HANG_SECONDS))
            except ValueError:
                hang_seconds = DEFAULT_HANG_SECONDS
        self.hang_seconds = max(0.05, hang_seconds)
        self.check_interval = (check_interval if check_interval is not None
                               else min(5.0, max(0.25,
                                                 self.hang_seconds / 4)))
        self._out_dir = out_dir
        self._lock = threading.Lock()
        self._armed: Dict[str, int] = {}
        self._armed_since: Dict[str, float] = {}
        self._progress_counts: Dict[str, int] = {}
        self._kind_progress: Dict[str, float] = {}   # channel -> monotonic
        self._last_progress = time.monotonic()       # any-channel fallback
        self._stalled_kinds: set = set()   # one dump per kind per episode
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._fatal: Optional[str] = None
        self._dump_seq = 0
        # bundle names carry a per-instance nonce: after
        # reset_global_flight_recorder() the new recorder's seq restarts
        # at 1, and without the nonce it would silently overwrite (and
        # later evict) the previous incident's postmortem-<pid>-001
        self._instance = os.urandom(3).hex()
        self.dumps: List[str] = []     # retained bundle paths, oldest first

    # ------------------------------------------------------------- arming
    def arm(self, kind: str) -> _Armed:
        """Declare work in flight: while any arm() block is open, the
        watchdog treats missing progress as a hang."""
        return _Armed(self, kind)

    def _arm(self, kind: str):
        now = time.monotonic()
        with self._lock:
            idle = not self._armed
            n = self._armed.get(kind, 0)
            self._armed[kind] = n + 1
            if n == 0:
                # a fresh operation starts its own stall clock — a process
                # idle for an hour is not already mid-hang
                self._armed_since[kind] = now
                self._stalled_kinds.discard(kind)
        # hook/watchdog setup is idempotent but takes process-global
        # locks — do it only on the idle→armed transition, not once per
        # serving request (every BATCHED output() arms)
        if idle and recorder_enabled():
            self.install()
            self._ensure_watchdog()

    def _disarm(self, kind: str):
        with self._lock:
            n = self._armed.get(kind, 0) - 1
            if n > 0:
                self._armed[kind] = n
            else:
                self._armed.pop(kind, None)
                self._armed_since.pop(kind, None)
                self._stalled_kinds.discard(kind)

    def progress(self, kind: str = "step"):
        """Heartbeat: a unit of work completed (fit step, device batch).
        ``kind`` is the progress CHANNEL the watchdog matches against
        armed operations (see ``_PROGRESS_CHANNELS``)."""
        now = time.monotonic()
        self._last_progress = now
        # racy writes are fine — these feed the watchdog's staleness read
        # and postmortem context, not accounting
        self._kind_progress[kind] = now
        self._progress_counts[kind] = self._progress_counts.get(kind, 0) + 1

    # ----------------------------------------------------------- watchdog
    def _ensure_watchdog(self):
        if self._watchdog is not None:
            return
        with self._lock:
            if self._watchdog is not None:
                return
            t = threading.Thread(target=self._watch, daemon=True,
                                 name="dl4j-flight-recorder")
            self._watchdog = t
        t.start()

    def _progress_baseline(self, kind: str) -> float:
        """Latest proof-of-life for one armed operation: its relevant
        progress channels (NOT any progress — inference completing must
        not mask a wedged fit) or, for unknown categories, any channel;
        floored at the moment it armed."""
        channels = _PROGRESS_CHANNELS.get(kind.split(":", 1)[0])
        if channels is None:
            last = self._last_progress
        else:
            last = max((self._kind_progress.get(c, 0.0) for c in channels),
                       default=0.0)
        return max(last, self._armed_since.get(kind, 0.0))

    def _watch(self):
        while not self._stop.wait(self.check_interval):
            if not recorder_enabled():
                continue
            now = time.monotonic()
            newly_stalled = []
            with self._lock:
                for kind in sorted(self._armed):
                    stalled_for = now - self._progress_baseline(kind)
                    if stalled_for > self.hang_seconds:
                        if kind not in self._stalled_kinds:
                            self._stalled_kinds.add(kind)
                            newly_stalled.append((kind, stalled_for))
                    else:       # progress resumed: a NEW stall may dump
                        self._stalled_kinds.discard(kind)
            for kind, stalled_for in newly_stalled:
                self._safe_dump(f"hang: no progress for {stalled_for:.1f}s "
                                f"while {kind!r} in flight")

    def stop(self):
        """Terminal: stop the watchdog thread (test teardown / reset) and
        detach from the process-wide crash hooks."""
        self._stop.set()
        global _hook_target
        with _hook_lock:
            if _hook_target is self:
                # fall back to the global recorder (if it isn't us) so a
                # reset never leaves fatal exceptions unrecorded
                _hook_target = (_global_recorder
                                if _global_recorder is not self else None)

    # -------------------------------------------------------- crash hooks
    def install(self) -> "FlightRecorder":
        """Become the target of the process-wide crash hooks. The
        sys/threading excepthook wrappers and the atexit callback are
        installed ONCE per process and dispatch to whichever recorder is
        current — resetting/replacing recorders re-points the dispatch
        instead of wrapping hooks around hooks (which would dump one
        bundle per generation and pin every old recorder alive)."""
        global _hook_target
        with _hook_lock:
            _hook_target = self
        _install_process_hooks()
        return self

    def _on_fatal(self, exc_type, exc):
        self._fatal = f"{exc_type.__name__}: {exc}"
        self._safe_dump(f"fatal_exception:{exc_type.__name__}")

    def _on_thread_fatal(self, args):
        self._fatal = (f"{args.exc_type.__name__} in thread "
                       f"{getattr(args.thread, 'name', '?')}")
        self._safe_dump(f"thread_exception:{args.exc_type.__name__}")

    def _at_exit(self):
        self.stop()
        if os.environ.get("DL4J_TPU_POSTMORTEM_ON_EXIT") == "1":
            self._safe_dump("atexit")

    def _safe_dump(self, reason: str) -> Optional[str]:
        try:
            return self.dump(reason)
        except Exception:       # a broken dump must never mask the crash
            return None

    # ------------------------------------------------------------ dumping
    def dump(self, reason: str = "manual") -> str:
        """Write one postmortem bundle; returns its directory. Sections
        are independent best-effort — a wedged subsystem cannot veto the
        thread stacks that would explain the wedge."""
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        bundle = os.path.join(
            self._out_dir or postmortem_dir(),
            f"postmortem-{os.getpid()}-{self._instance}-{seq:03d}")
        os.makedirs(bundle, exist_ok=True)

        def section(fname: str, write):
            try:
                write(os.path.join(bundle, fname))
            except Exception as e:
                try:
                    with open(os.path.join(bundle, fname + ".error"),
                              "w") as f:
                        f.write(repr(e))
                except OSError:
                    pass

        from deeplearning4j_tpu_torch.observability.tracing import global_trace_sink
        section("trace.json",
                lambda p: global_trace_sink().export_json(p))
        section("metrics.prom", self._write_metrics)
        section("threads.txt", self._write_threads)
        section("config.json", lambda p: self._write_config(p, reason))
        # the PR-4 observatory: which signatures compiled what (a hang
        # during a retrace storm is a compile, not a collective) and the
        # numerics health at the moment of death
        section("compiles.json", self._write_compiles)
        section("numerics.json", self._write_numerics)
        # the PR-5 resilience layer: what was injected, which circuits
        # were open, and the retry/shed/restore/quarantine event trail —
        # a hang during a chaos run must name the chaos
        section("resilience.json", self._write_resilience)
        # the multi-tenant QoS layer: policies, quota bucket levels,
        # per-tenant counters — a death under a flooding tenant must
        # name who was flooding and who was shed
        section("tenants.json", self._write_tenants)
        # the serving layer: deployed versions, rollout stage/share and
        # the SLO verdicts behind them — a death mid-canary must name
        # which model had the traffic
        section("deploy.json", self._write_deploy)
        # the PR-6 cost observatory: per-fn cost/MFU/roofline at the
        # moment of death — a postmortem for "it got slow, then it hung"
        section("perf.json", self._write_perf)
        # the generative decode layer: slot table, positions, queue depth
        # — a hang mid-generation must name which slots were decoding
        section("generation.json", self._write_generation)
        # the durable-session layer: journal attachment, per-session
        # status/seq/fence — a death mid-stream must name which
        # sessions a survivor can adopt (section absent with
        # DL4J_TPU_SESSIONS=0 never exercised)
        section("sessions.json", self._write_sessions)
        # the HTTP front door: in-flight gate, lane routers, and (multi-
        # process mode) the shared fleet view — a death under load must
        # name what the wire surface was doing
        section("frontdoor.json", self._write_frontdoor)
        # the fleet robustness layer: leader lease/term, demotions,
        # store corruption/rebuild evidence, idempotency journal — a
        # death during a fleet chaos run must name who led, under which
        # term, and what was (or was not) executed twice
        section("fleet.json", self._write_fleet)
        # the trace-intelligence layer: the incident's pinned trace ids
        # assembled FLEET-WIDE (via the installed assembler) — a
        # coordinated capture ships the full cross-process request
        # story, not one worker's ring slice
        from deeplearning4j_tpu_torch.observability.trace_store import (
            trace_store_enabled)
        if trace_store_enabled():
            section("traces.json", self._write_traces)
        # the watchtower layer: the ringed registry timeseries (the
        # minutes BEFORE the trip) and the alert lifecycle state at the
        # moment of death — section absent with the switch off
        from deeplearning4j_tpu_torch.observability.timeseries import (
            watchtower_enabled)
        if watchtower_enabled():
            section("timeseries.json", self._write_timeseries)
        if reason.startswith("incident:"):
            # a coordinated peer capture: stamp the fleet-wide incident
            # id INTO the bundle so a postmortem directory groups every
            # worker's view of the same event
            inc_id = reason.split(":", 1)[1].strip()
            section("incident.json", lambda p: _write_json_file(p, {
                "incident_id": inc_id, "reason": reason,
                "pid": os.getpid(), "unix_time": time.time()}))
        try:
            global_registry().counter(
                "dl4j_postmortem_dumps_total",
                "flight-recorder bundles written, by trigger",
                label_names=("trigger",)).labels(
                    trigger=reason.split(":")[0].strip()).inc()
        except Exception:
            pass
        # bounded retention: a polled /debug/dump, a flapping watchdog, or
        # a crash-looping supervisor must not fill the disk — evict the
        # oldest postmortem-* dirs beyond DL4J_TPU_POSTMORTEM_KEEP
        # (default 8) by scanning the DIRECTORY, so bundles from earlier
        # recorder instances / process runs are bounded too
        keep = _keep_bundles()
        base = os.path.dirname(bundle)
        try:
            entries = [os.path.join(base, e) for e in os.listdir(base)
                       if e.startswith("postmortem-")
                       and os.path.isdir(os.path.join(base, e))]
            entries.sort(key=lambda p: (os.path.getmtime(p), p))
            for old in entries[:-keep]:
                shutil.rmtree(old, ignore_errors=True)
        except OSError:
            pass
        with self._lock:
            self.dumps.append(bundle)
            self.dumps = [p for p in self.dumps if os.path.isdir(p)]
        pub = _incident_publisher
        if pub is not None:
            try:
                pub(reason, bundle)
            except Exception:   # a broken publisher never masks the dump
                pass
        return bundle

    @staticmethod
    def _write_compiles(path: str):
        from deeplearning4j_tpu_torch.observability.compile_watch import (
            global_compile_watch)
        with open(path, "w") as f:
            json.dump(global_compile_watch().snapshot(), f, indent=2,
                      default=str)

    @staticmethod
    def _write_numerics(path: str):
        from deeplearning4j_tpu_torch.observability import numerics
        with open(path, "w") as f:
            json.dump(numerics.snapshot(), f, indent=2, default=str)

    @staticmethod
    def _write_resilience(path: str):
        from deeplearning4j_tpu_torch import resilience
        with open(path, "w") as f:
            json.dump(resilience.snapshot(), f, indent=2, default=str)

    @staticmethod
    def _write_deploy(path: str):
        from deeplearning4j_tpu_torch import serving
        with open(path, "w") as f:
            json.dump(serving.snapshot(), f, indent=2, default=str)

    @staticmethod
    def _write_tenants(path: str):
        from deeplearning4j_tpu_torch.resilience import qos
        with open(path, "w") as f:
            json.dump(qos.snapshot(), f, indent=2, default=str)

    @staticmethod
    def _write_perf(path: str):
        from deeplearning4j_tpu_torch.observability.cost_model import (
            global_cost_model)
        with open(path, "w") as f:
            json.dump(global_cost_model().snapshot(), f, indent=2,
                      default=str)

    @staticmethod
    def _write_generation(path: str):
        # never IMPORT the generation stack from a (possibly wedged)
        # dump path — a process that never used it gets an empty
        # section, not a fresh module-import under the import lock
        import sys as _sys
        gen = _sys.modules.get("deeplearning4j_tpu_torch.parallel.generation")
        pipelines = (gen.GenerationPipeline.live_snapshots()
                     if gen is not None else [])
        with open(path, "w") as f:
            json.dump({"pipelines": pipelines}, f, indent=2, default=str)

    @staticmethod
    def _write_frontdoor(path: str):
        # sys.modules guard, same rationale as _write_generation
        import sys as _sys
        fdm = _sys.modules.get("deeplearning4j_tpu_torch.serving.frontdoor")
        payload = (fdm.snapshot_all() if fdm is not None
                   else {"frontdoors": []})
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)

    @staticmethod
    def _write_fleet(path: str):
        # sys.modules guard, same rationale as _write_generation
        import sys as _sys
        fdm = _sys.modules.get("deeplearning4j_tpu_torch.serving.frontdoor")
        if fdm is not None:
            payload = fdm.fleet_snapshot()
        else:
            idm = _sys.modules.get(
                "deeplearning4j_tpu_torch.serving.idempotency")
            payload = {"idempotency": (idm.snapshot() if idm is not None
                                       else {}),
                       "frontdoors": []}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)

    @staticmethod
    def _write_sessions(path: str):
        # sys.modules guard, same rationale as _write_generation
        import sys as _sys
        sm = _sys.modules.get("deeplearning4j_tpu_torch.serving.session")
        payload = (sm.snapshot() if sm is not None
                   else {"enabled": None, "sessions": []})
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)

    @staticmethod
    def _write_timeseries(path: str):
        from deeplearning4j_tpu_torch.observability.timeseries import (
            global_timeseries)
        # sys.modules guard for the watchtower (same rationale as
        # _write_generation): a process that never beat it gets None,
        # not a fresh import under the import lock
        import sys as _sys
        wt = _sys.modules.get(
            "deeplearning4j_tpu_torch.observability.watchtower")
        payload = global_timeseries().snapshot()
        payload["alerts"] = (wt.global_watchtower().alerts.snapshot()
                             if wt is not None else None)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)

    @staticmethod
    def _write_traces(path: str):
        from deeplearning4j_tpu_torch.observability.trace_store import (
            global_trace_store)
        store = global_trace_store()
        pinned = store.pinned_ids()
        assembler = _trace_assembler
        traces = {}
        for tid in pinned:
            doc = None
            if assembler is not None:
                try:
                    doc = assembler(tid)
                except Exception as e:
                    doc = {"error": repr(e)}
            if doc is None:
                doc = store.get(tid)    # single-process fallback
            if doc is not None:
                traces[tid] = doc
        with open(path, "w") as f:
            json.dump({"pinned": pinned, "recent": store.recent(),
                       "traces": traces}, f, indent=2, default=str)

    @staticmethod
    def _write_metrics(path: str):
        with open(path, "w") as f:
            f.write(global_registry().render_prometheus())

    @staticmethod
    def _write_threads(path: str):
        names = {t.ident: t.name for t in threading.enumerate()}
        lines = []
        for tid, frame in sys._current_frames().items():
            lines.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
            lines.extend(l.rstrip("\n")
                         for l in traceback.format_stack(frame))
            lines.append("")
        with open(path, "w") as f:
            f.write("\n".join(lines))

    def _write_config(self, path: str, reason: str):
        from deeplearning4j_tpu_torch import async_runtime
        with self._lock:
            armed = dict(self._armed)
            progress = dict(self._progress_counts)
        cfg = {
            "reason": reason,
            "unix_time": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "fatal": self._fatal,
            "armed": armed,
            "progress_counts": progress,
            "seconds_since_progress": time.monotonic() - self._last_progress,
            "async_runtime": async_runtime.snapshot(),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith("DL4J_TPU_")},
        }
        try:        # the SLO view of the moment of death
            from deeplearning4j_tpu_torch.observability.slo import global_slo_engine
            cfg["health"] = global_slo_engine().evaluate()
        except Exception as e:
            cfg["health"] = {"error": repr(e)}
        try:        # HBM at the moment of death (None per device on CPU)
            from deeplearning4j_tpu_torch.observability import device_memory
            cfg["device_memory"] = device_memory.snapshot()
        except Exception as e:
            cfg["device_memory"] = {"error": repr(e)}
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2, default=str)


def _write_json_file(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)


_global_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()

# coordinated incident capture (fleet observability plane): a process-
# wide hook called after every bundle write with (reason, bundle_path).
# The serving front door wires this to the shared-store incident ledger
# so the LEADER can fan the capture out to every live worker.
_incident_publisher = None


def set_incident_publisher(fn) -> None:
    """Install (or clear, with None) the post-dump incident hook.  The
    hook runs OUTSIDE the recorder's lock, best-effort: a broken
    publisher must never mask the dump that tripped it."""
    global _incident_publisher
    _incident_publisher = fn


# fleet trace assembly for the bundle's traces.json: installed alongside
# the incident publisher (federation.install_incident_publisher); takes
# a trace id, returns the assembled cross-worker doc or None (then the
# local store payload is used)
_trace_assembler = None


def set_trace_assembler(fn) -> None:
    """Install (or clear, with None) the fleet trace assembler the
    bundle's ``traces.json`` section uses for pinned trace ids."""
    global _trace_assembler
    _trace_assembler = fn

# process-wide crash-hook plumbing: ONE set of excepthook wrappers + one
# atexit callback, dispatching to the currently-installed recorder
_hook_target: Optional[FlightRecorder] = None
_hook_lock = threading.Lock()
_process_hooks_installed = False


def _install_process_hooks():
    global _process_hooks_installed
    with _hook_lock:
        if _process_hooks_installed:
            return
        _process_hooks_installed = True
    prev_sys = sys.excepthook

    def _sys_hook(exc_type, exc, tb):
        target = _hook_target
        if (target is not None and recorder_enabled()
                and not issubclass(exc_type,
                                   (KeyboardInterrupt, SystemExit))):
            target._on_fatal(exc_type, exc)
        prev_sys(exc_type, exc, tb)

    sys.excepthook = _sys_hook
    prev_thread = threading.excepthook

    def _thread_hook(args):
        target = _hook_target
        if (target is not None and recorder_enabled()
                and args.exc_type is not SystemExit):
            target._on_thread_fatal(args)
        prev_thread(args)

    threading.excepthook = _thread_hook

    def _at_exit():
        target = _hook_target
        if target is not None:
            target._at_exit()

    atexit.register(_at_exit)


def global_flight_recorder() -> FlightRecorder:
    """THE process-wide recorder every built-in arm/progress point uses."""
    global _global_recorder
    if _global_recorder is None:
        with _recorder_lock:
            if _global_recorder is None:
                _global_recorder = FlightRecorder()
    return _global_recorder


def reset_global_flight_recorder(**kw) -> FlightRecorder:
    """Fresh recorder (test isolation); the old watchdog is stopped and
    the process crash hooks — if installed — re-point to the new one."""
    global _global_recorder, _hook_target
    with _recorder_lock:
        if _global_recorder is not None:
            _global_recorder.stop()
        _global_recorder = FlightRecorder(**kw)
        with _hook_lock:
            if _process_hooks_installed and _hook_target is None:
                _hook_target = _global_recorder
    return _global_recorder
