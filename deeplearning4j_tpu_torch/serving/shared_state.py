"""Shared rollout state for multi-process serving: one version set, N workers.

One Python process would otherwise own the whole deploy story:
registry, rollout stage, and drain state all lived in process memory, so
a second server process could disagree with the first about which
version was primary, where the canary split sat, or whether a drain had
finished. This module moves that state to a **file-backed shared store**
so ``tools/serve.py --workers N`` processes serve ONE consistent version
set:

- :class:`SharedStore` — a single JSON document with an atomic
  compare-and-swap write path: every commit goes through
  tmp + ``os.replace`` + fsync (the ``utils/serialization`` atomic-write
  discipline) under an ``fcntl`` file lock, and carries a monotonically
  increasing ``rev`` stamp plus a **content digest**. Readers never lock
  (rename is atomic — a read sees a complete document or the previous
  one, never a torn one); writers CAS on ``rev``
  (:meth:`SharedStore.try_replace`) or serialize through
  :meth:`SharedStore.update`. The lock is crash-safe: flock releases
  when a SIGKILLed worker's fd closes — and the lock wait is BOUNDED
  (:data:`STORE_LOCK_TIMEOUT_S`, typed
  :class:`~deeplearning4j_tpu_torch.serving.errors.StoreLockTimeout`), so a
  writer paused INSIDE its critical section cannot wedge the fleet.
- **Corruption recovery** — every read validates schema + digest; a
  corrupt/garbage document is **quarantined aside** (renamed next to the
  store, never deleted — it is postmortem evidence), counted
  (``dl4j_fleet_store_corruptions_total``), and the fleet document is
  **rebuilt** from worker re-registration plus each worker's local
  mirror of the sequenced history (the replay result of every
  transition it applied). Chaos drills drive this through the
  ``store.read`` / ``store.write`` fault points.
- :class:`SharedServingState` — the coordination layer the front door
  rides: worker registration + heartbeats + **lease-fenced leader
  election**, two serving *lanes* (``scoring`` / ``generative``) with a
  shared rollout state machine, deterministic hash-split routing every
  worker computes identically, and fleet-aggregated SLO windows the
  leader closes over aggregate deltas.

Lease-fenced leadership (``DL4J_TPU_FLEET_FENCE``, default on)
--------------------------------------------------------------
Heartbeat-only election is trusting: a SIGSTOP'd / GC-paused leader that
wakes after its TTL still believes ``is_leader`` and could close SLO
windows or move the rollout against a stale view. Under the fence the
store carries a ``leader`` record ``{worker, term, since}`` with a
**monotonically increasing term**:

- leadership changes ONLY when the holder's lease (its heartbeat)
  expires; the lowest-id alive worker then acquires with ``term + 1``
  (no lowest-id flap-back when a paused ex-leader wakes);
- every leader-only write (window close, stage advance, auto-rollback,
  promote) happens inside the serialized ``update`` transaction and is
  **fenced on the writer's term**: the transaction re-reads the leader
  record and a stale term means the write LOSES (the lane evaluation is
  skipped) instead of landing;
- demotion is detected at write time, counted
  (``dl4j_fleet_demotions_total``), and ringed;
- stage transitions are **monotonicity-guarded**: the stage can never
  move backward (canary ← ramp ← full) except via an explicit,
  history-sequenced rollback; every history event carries the writer's
  ``term`` so a drill can audit that terms are strictly monotonic with
  no interleaved fenced writes from two terms.

``DL4J_TPU_FLEET_FENCE=0`` restores the pre-fence lowest-alive-id
election byte-identically: no ``leader`` record, no term stamps, no
``dl4j_fleet_*`` leadership series.

Clock discipline: every heartbeat/window age is computed through
:func:`_age`, which clamps negative deltas to 0 — a wall-clock backward
jump reads as "fresh", never as instant leader death or an instantly
closed window.

A SIGKILLed worker's already-published window counters keep counting
toward the current window (its traffic happened); a respawned worker
reads the store at startup and **rejoins the same rollout stage** — the
kill/respawn drill in ``benchmarks/http_load.py`` pins both properties,
and ``--fleet-chaos`` adds the SIGSTOP-past-TTL + store-corruption
drill on top.
"""
from __future__ import annotations

import copy
import hashlib
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

try:
    import fcntl
except ImportError:                      # pragma: no cover - POSIX only
    fcntl = None

from deeplearning4j_tpu_torch.observability.slo import DEGRADED, FAILING, OK, _grade
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.serving.errors import (RolloutConflictError,
                                               StoreLockTimeout)

#: the two serving surfaces a fleet coordinates (a lane = one primary +
#: at most one rollout; classify rides scoring, generate rides generative)
LANES = ("scoring", "generative")

#: shared-rollout stages (the store's state machine starts at canary —
#: shadow scoring needs request-level output comparison, which is a
#: single-process concern the local CanaryRollout already owns)
CANARY, RAMP, FULL, ROLLED_BACK = "canary", "ramp", "full", "rolled_back"

#: forward-only stage order (the monotonicity guard; ROLLED_BACK is the
#: one sanctioned backward move and it is always history-sequenced)
_STAGE_RANK = {CANARY: 1, RAMP: 2, FULL: 3}

#: grading policy of one shared rollout (stored IN the document so every
#: worker — including one spawned mid-rollout — grades from the same
#: thresholds; ``None`` disables a grade, like the local RolloutPolicy)
DEFAULT_POLICY = {
    "canary_fraction": 0.05,
    "ramp_fractions": (0.25, 0.5),
    "window_seconds": 0.5,          # wall-clock window the leader closes
    "window_min_requests": 8,       # candidate samples a window needs
    "healthy_windows": 2,           # consecutive ok windows to advance
    "error_rate_degraded": 0.02,
    "error_rate_failing": 0.10,
    "latency_ratio_degraded": 2.0,  # candidate mean / primary mean
    "latency_ratio_failing": 4.0,
    "min_latency_n": 8,             # samples BOTH sides need for the ratio
}

#: heartbeats older than this mark a worker dead (leader re-election);
#: sized generously above the front door's sync cadence
WORKER_TTL_S = 3.0

#: bounded file-lock wait — a writer SIGSTOPped inside its critical
#: section must not wedge every other worker's sync beat forever
STORE_LOCK_TIMEOUT_S = 10.0

_HISTORY_CAP = 128


def fleet_fence_enabled() -> bool:
    """``DL4J_TPU_FLEET_FENCE`` kill switch (read live): ``0`` restores
    the pre-fence lowest-alive-id leadership byte-identically — no
    leader record, no terms, no demotion series."""
    return os.environ.get("DL4J_TPU_FLEET_FENCE", "1") != "0"


def _now() -> float:
    """Wall-clock read, one spelling — tests mock THIS to simulate a
    regressing clock without patching the global ``time`` module."""
    return time.time()


def _age(now: float, then) -> float:
    """Age of a timestamp with negative deltas clamped to 0: a backward
    wall-clock jump must read as "fresh", never as instant leader death
    or an instantly-closed window."""
    try:
        return max(0.0, float(now) - float(then or 0.0))
    except (TypeError, ValueError):
        return float("inf")


# ------------------------------------------------------- fleet metrics
def _fleet_counter(name: str, help_text: str):
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(name, help_text)
    return _faults.cached_metric_handle(("fleet", name), make)


def _demotions_total():
    return _fleet_counter(
        "dl4j_fleet_demotions_total",
        "leaders demoted at write time: the worker believed it held the "
        "lease but the store's term had moved on — its fenced write "
        "lost instead of landing")


def _corruptions_total():
    return _fleet_counter(
        "dl4j_fleet_store_corruptions_total",
        "shared-store documents that failed schema/digest validation "
        "and were quarantined aside (never deleted)")


def _failovers_total():
    return _fleet_counter(
        "dl4j_fleet_failovers_total",
        "connect/first-byte failovers the fleet proxy performed onto "
        "another live worker (forwarding the idempotency key, so each "
        "retry was safe by construction); re-exported from the shared "
        "store's proxy record")


def _leader_term_gauge():
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().gauge(
            "dl4j_fleet_leader_term",
            "the shared store's current leader term (monotonically "
            "increasing; a bump means the previous lease expired)")
    return _faults.cached_metric_handle(("fleet", "leader_term"), make)


class SharedStore:
    """One JSON document, atomically replaced, rev-stamped, digest-
    validated. See module doc."""

    def __init__(self, path: str,
                 lock_timeout_s: float = STORE_LOCK_TIMEOUT_S):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.lock_timeout_s = float(lock_timeout_s)
        self._file = os.path.join(path, "state.json")
        self._lockfile = os.path.join(path, ".state.lock")

    # -------------------------------------------------------------- read
    def read(self, _retries: int = 4) -> dict:
        """Lock-free validated read of the current document
        (``{"rev": 0}`` before the first commit). ``os.replace`` is
        atomic, so a reader racing a writer sees the old complete
        document, never a torn one. A document that parses but fails
        schema/digest validation is CORRUPT: quarantined aside and
        reported as empty — the fleet rebuilds it (see
        ``SharedServingState``)."""
        if _faults.armed():
            _faults.check("store.read")
        try:
            with open(self._file, encoding="utf-8") as f:
                ino = os.fstat(f.fileno()).st_ino
                raw = f.read()
        except OSError:
            return {"rev": 0}           # no document yet — a clean state
        try:
            doc = json.loads(raw)
        except ValueError:
            return self._quarantine("unparseable JSON", ino, _retries)
        problem = self._validate(doc)
        if problem is not None:
            return self._quarantine(problem, ino, _retries)
        return doc

    @staticmethod
    def _validate(doc) -> Optional[str]:
        """Schema + content-digest validation; None = good document."""
        if not isinstance(doc, dict):
            return f"document is {type(doc).__name__}, not an object"
        try:
            int(doc.get("rev", 0))
            int(doc.get("hseq", 0))
        except (TypeError, ValueError):
            return "rev/hseq not integral"
        for key in ("workers", "lanes", "windows", "leader"):
            if key in doc and not isinstance(doc[key], dict):
                return f"{key!r} is {type(doc[key]).__name__}, not an object"
        if "history" in doc and not isinstance(doc["history"], list):
            return "'history' is not a list"
        digest = doc.get("digest")
        if digest is not None and digest != _content_digest(doc):
            return "content digest mismatch (bit rot or a partial edit)"
        return None

    def _quarantine(self, problem: str, ino: int, retries: int) -> dict:
        """Move the corrupt document ASIDE (never delete — it is
        postmortem evidence), count it, and report the store empty so
        the fleet's rebuild path takes over. Racing readers both try
        the rename; exactly one wins, the loser finds nothing left.

        Readers are lock-free, so between our read and this rename a
        serialized writer may have COMMITTED a fresh good document —
        renaming that aside would throw away the fleet's latest state
        and count a phantom corruption. The inode check narrows the
        race to the stat→rename window (a committed doc is a NEW inode
        via tmp+``os.replace``): a moved-on inode means the corruption
        we read is already gone — re-read the current document
        instead."""
        try:
            if os.stat(self._file).st_ino != ino:
                if retries > 0:
                    return self.read(_retries=retries - 1)
                return {"rev": 0}       # doc keeps churning: stay empty
        except OSError:
            return {"rev": 0}           # already quarantined/removed
        aside = f"{self._file}.corrupt.{time.time_ns()}.{os.getpid()}"
        try:
            os.replace(self._file, aside)
        except OSError:
            aside = None                # another reader quarantined first
        if aside is not None:
            _corruptions_total().inc()
            _faults.record_event("store_corruption", problem=problem,
                                 quarantined=os.path.basename(aside))
        return {"rev": 0}

    # ------------------------------------------------------------- write
    @contextmanager
    def _locked(self, timeout_s: Optional[float] = None):
        if timeout_s is None:
            timeout_s = self.lock_timeout_s
        fd = os.open(self._lockfile, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            if fcntl is not None:
                deadline = time.monotonic() + timeout_s
                while True:
                    try:
                        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                        break
                    except OSError:
                        if time.monotonic() >= deadline:
                            raise StoreLockTimeout(
                                f"shared-store lock not acquired within "
                                f"{timeout_s:.1f}s — a writer died or "
                                "was paused inside its critical section")
                        time.sleep(0.01)
            yield
        finally:
            if fcntl is not None:
                try:
                    fcntl.flock(fd, fcntl.LOCK_UN)
                except OSError:         # pragma: no cover - defensive
                    pass
            os.close(fd)

    def _write(self, doc: dict):
        """tmp + fsync + atomic rename + directory fsync — a torn
        ``state.json`` must be impossible, even through a power cut
        (the ``utils/serialization`` atomic-write discipline). Stamps
        the content digest read() validates."""
        if _faults.armed():
            _faults.check("store.write")
        doc["digest"] = _content_digest(doc)
        tmp = f"{self._file}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._file)
        dirfd = os.open(os.path.dirname(self._file) or ".", os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)

    def try_replace(self, doc: dict, expected_rev: int) -> bool:
        """Compare-and-swap: commit ``doc`` only if the store is still at
        ``expected_rev``. Returns False (and writes nothing) on a lost
        race — the caller re-reads and retries."""
        with self._locked():
            cur = self.read()
            if int(cur.get("rev", 0)) != int(expected_rev):
                return False
            out = dict(doc)
            out["rev"] = int(expected_rev) + 1
            out["stamp"] = time.time()
            self._write(out)
            return True

    def update(self, mutate: Callable[[dict], Optional[dict]]) -> dict:
        """Serialized read-modify-write: run ``mutate(doc)`` (edit in
        place or return a replacement) under the file lock and commit
        with a bumped ``rev``. A raising ``mutate`` commits nothing."""
        with self._locked():
            doc = self.read()
            rev = int(doc.get("rev", 0))
            out = mutate(doc)
            if out is None:
                out = doc
            out["rev"] = rev + 1
            out["stamp"] = time.time()
            self._write(out)
            return out


def _content_digest(doc: dict) -> str:
    """Canonical digest over everything except the digest field itself
    (sorted keys, so writer dict order never matters)."""
    body = {k: v for k, v in doc.items() if k != "digest"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=str).encode()
    ).hexdigest()[:24]


def _zero() -> dict:
    return {"n": 0, "err": 0, "lat_sum": 0.0, "lat_n": 0}


def _agg(windows: dict, version: str) -> dict:
    """Sum one version's cumulative counters across every worker that
    ever published (dead workers included — their traffic happened)."""
    out = _zero()
    for per_worker in windows.values():
        w = per_worker.get(version)
        if not isinstance(w, dict):
            continue
        out["n"] += int(w.get("n", 0))
        out["err"] += int(w.get("err", 0))
        out["lat_sum"] += float(w.get("lat_sum", 0.0))
        out["lat_n"] += int(w.get("lat_n", 0))
    return out


def _delta(cur: dict, base: Optional[dict]) -> dict:
    base = base or _zero()
    return {k: max(0, cur[k] - base.get(k, 0)) if k != "lat_sum"
            else max(0.0, cur[k] - base.get(k, 0.0)) for k in cur}


class SharedServingState:
    """One worker's handle on the shared store. See module doc."""

    def __init__(self, store: SharedStore, worker_id: str,
                 routing_ttl_s: float = 0.2):
        self.store = store
        self.worker_id = str(worker_id)
        self._lock = threading.Lock()
        self._pending: Dict[str, dict] = {}       # version -> delta counters
        self._routing_ttl = float(routing_ttl_s)
        self._routing_cache: Tuple[float, dict] = (0.0, {})
        # the last routing view computed from a GOOD document — never
        # invalidated (only replaced), so a store blip or the one-beat
        # quarantine blackout can always serve stale-but-available
        self._last_good_view: dict = {}
        # history watermark starts at the store's CURRENT head: a fresh
        # handle (respawned worker) must adopt the present state, never
        # replay transitions it wasn't alive for (register() re-anchors
        # it too, but the sync thread may beat register in a race)
        try:
            self._applied_seq = int(store.read().get("hseq", 0))
        # graftlint: disable=typed-errors — a store blip (injected
        # store.read fault, transient fs) at construction must not kill
        # the worker; register() re-anchors the watermark right after
        except Exception:
            self._applied_seq = 0
        self._is_leader = False
        # the lease term this worker believes it leads under (None =
        # follower); compared against the store INSIDE every serialized
        # write — the fence
        self._term: Optional[int] = None
        self._demotions = 0
        self._rebuilds = 0
        self._failovers_seen = 0
        # this worker's own announcement (pid, port): re-applied on
        # every beat whose doc lacks it — the "worker re-registration"
        # half of the corruption-rebuild story
        self._reg: Optional[Tuple[int, int]] = None
        # local mirror of the durable fleet facts (lanes after every
        # applied transition + the sequenced history + leader term):
        # the rebuild source when the store doc is quarantined
        self._mirror: Optional[dict] = None

    # ------------------------------------------------------- registration
    def register(self, pid: int, port: int):
        """Announce this worker (called once at startup; the respawn
        drill re-registers under the same worker id and inherits the
        store's current stage — nothing here resets rollout state)."""
        wid = self.worker_id
        self._reg = (int(pid), int(port))

        def mutate(doc):
            self._maybe_rebuild(doc)
            workers = doc.setdefault("workers", {})
            workers[wid] = {"pid": int(pid), "port": int(port),
                            "heartbeat": _now(),
                            "started": _now()}
            doc.setdefault("lanes", {})
            doc.setdefault("windows", {}).setdefault(wid, {})
            doc.setdefault("history", [])
            doc.setdefault("hseq", 0)
        out = self.store.update(mutate)
        self._remember(out)
        # a (re)registered worker must not re-apply the fleet's past
        # transitions — its local deploys already reflect store state
        self._applied_seq = int(out.get("hseq", 0))

    def ensure_lane(self, lane: str, primary: str):
        """Set the lane's primary IF the lane is new — a respawned
        worker must adopt the fleet's current primary, not reset it."""
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}; one of {LANES}")

        def mutate(doc):
            self._maybe_rebuild(doc)
            lanes = doc.setdefault("lanes", {})
            lanes.setdefault(lane, {"primary": primary, "rollout": None})
        self._remember(self.store.update(mutate))

    # ------------------------------------------------------------ routing
    def routing(self, lane: str) -> dict:
        """The lane's live routing view (cached ``routing_ttl_s`` so the
        hot path reads the store a few times a second, not per request):
        ``{"primary", "candidate", "stage", "share", "active"}``.
        A failing store READ (injected ``store.read`` fault, transient
        fs) serves the last cached view — stale-but-available beats
        failing live traffic over a coordination-plane blip."""
        now = time.monotonic()
        with self._lock:
            at, cache = self._routing_cache
            if now - at < self._routing_ttl and lane in cache:
                return cache[lane]
        try:
            doc = self.store.read()
        # graftlint: disable=typed-errors — availability policy: a store
        # read blip must not fail live requests; the stale cached view
        # answers and the next beat refreshes it
        except Exception:
            _faults.record_event("store_read_fallback", lane=lane)
            return self._fallback_view(lane)
        if not doc.get("lanes"):
            with self._lock:
                have_good = bool(self._last_good_view)
            if have_good:
                # an empty document while we remember lanes = the doc
                # was just quarantined (corruption) and the rebuild
                # beat hasn't landed yet — a one-beat blackout must not
                # 404 live traffic; serve the last good view
                _faults.record_event("store_read_fallback", lane=lane,
                                     reason="empty_doc")
                return self._fallback_view(lane)
        view = {}
        for ln, st in (doc.get("lanes") or {}).items():
            ro = st.get("rollout") or {}
            view[ln] = {
                "primary": st.get("primary"),
                "candidate": ro.get("candidate"),
                "stage": ro.get("stage"),
                "share": float(ro.get("share", 0.0)),
                "active": bool(ro.get("active")),
            }
        with self._lock:
            self._routing_cache = (now, view)
            if view:
                self._last_good_view = view
        return view.get(lane, {"primary": None, "candidate": None,
                               "stage": None, "share": 0.0,
                               "active": False})

    def _fallback_view(self, lane: str) -> dict:
        """Stale-but-available routing: the TTL cache if it has the
        lane, else the last view computed from a good document."""
        with self._lock:
            _, cache = self._routing_cache
            view = cache.get(lane) or self._last_good_view.get(lane)
        return view or {"primary": None, "candidate": None,
                        "stage": None, "share": 0.0, "active": False}

    def pick(self, lane: str, frac: float) -> Tuple[Optional[str], bool]:
        """Deterministic hash-split: ``(version, is_canary)`` for one
        request's routing coordinate — every worker computes the same
        answer for the same request because both inputs (content hash,
        store share) are shared."""
        r = self.routing(lane)
        if (r["active"] and r["share"] > 0.0 and r["candidate"]
                and frac < r["share"]):
            return r["candidate"], True
        return r["primary"], False

    # ---------------------------------------------------------- recording
    def record(self, version: str, ok: bool, latency_s: float):
        """Accumulate one served request locally (flushed to the store by
        :meth:`sync` — per-request store writes would serialize the
        fleet on the file lock)."""
        with self._lock:
            w = self._pending.setdefault(version, _zero())
            w["n"] += 1
            if not ok:
                w["err"] += 1
            w["lat_sum"] += float(latency_s)
            w["lat_n"] += 1

    # ------------------------------------------------------------ rollout
    def begin_rollout(self, lane: str, candidate: str,
                      policy: Optional[dict] = None) -> dict:
        """Start a shared rollout of ``candidate`` on ``lane`` (refused
        while one is active — same contract as the local router)."""
        pol = dict(DEFAULT_POLICY)
        pol.update(policy or {})
        pol["ramp_fractions"] = list(pol["ramp_fractions"])

        def mutate(doc):
            self._maybe_rebuild(doc)
            st = (doc.setdefault("lanes", {})
                  .setdefault(lane, {"primary": None, "rollout": None}))
            ro = st.get("rollout")
            if ro and ro.get("active"):
                raise RolloutConflictError(
                    f"a shared rollout of {ro.get('candidate')!r} is "
                    f"already active on lane {lane!r}")
            if not st.get("primary"):
                raise RolloutConflictError(
                    f"lane {lane!r} has no primary to canary against "
                    "(ensure_lane first)")
            if st.get("primary") == candidate:
                raise ValueError("candidate is already the primary")
            windows = doc.get("windows") or {}
            st["rollout"] = {
                "candidate": candidate,
                "stage": CANARY,
                "share": float(pol["canary_fraction"]),
                "ramp_idx": -1,
                "healthy_streak": 0,
                "active": True,
                "reason": None,
                "policy": pol,
                "started": _now(),
                "window_started": _now(),
                # (a NEW rollout legally starts back at canary: the
                # monotonicity guard reads THIS dict, which replaces
                # the previous rollout's wholesale)
                # baseline at start: the fleet's lifetime counters must
                # not grade this rollout (the delta discipline the local
                # canary rules follow)
                "window_base": {
                    candidate: _agg(windows, candidate),
                    st.get("primary"): _agg(windows, st.get("primary")),
                },
            }
            self._note(doc, lane, None, CANARY,
                       share=pol["canary_fraction"],
                       **self._writer_stamp(doc, manual=True))
        out = self.store.update(mutate)
        self._remember(out)
        self._invalidate()
        return out

    def rollback(self, lane: str, reason: str = "manual") -> dict:
        """Explicit rollback — the ONE sanctioned backward stage move,
        always history-sequenced (the monotonicity guard's escape
        hatch)."""
        def mutate(doc):
            self._maybe_rebuild(doc)
            st = (doc.get("lanes") or {}).get(lane) or {}
            ro = st.get("rollout")
            if not ro or not ro.get("active"):
                return
            prev = ro["stage"]
            ro.update(stage=ROLLED_BACK, share=0.0, active=False,
                      reason=reason)
            self._note(doc, lane, prev, ROLLED_BACK, share=0.0,
                       reason=reason,
                       **self._writer_stamp(doc, manual=True))
        out = self.store.update(mutate)
        self._remember(out)
        self._invalidate()
        return out

    def _writer_stamp(self, doc: dict, manual: bool = False) -> dict:
        """The term stamp a history event carries under the fence (the
        drill's strict-monotonicity audit reads it). With the fence OFF
        events stay byte-identical to the pre-fence format — no new
        keys."""
        if not fleet_fence_enabled():
            return {}
        led = doc.get("leader") or {}
        out = {"term": int(led.get("term", 0))}
        if manual:
            out["manual"] = True
        return out

    @staticmethod
    def _note(doc: dict, lane: str, prev: Optional[str], new: str,
              **attrs):
        doc["hseq"] = int(doc.get("hseq", 0)) + 1
        event = {"seq": doc["hseq"], "at": _now(), "lane": lane,
                 "from": prev, "to": new}
        ro = ((doc.get("lanes") or {}).get(lane) or {}).get("rollout") or {}
        event["candidate"] = ro.get("candidate")
        event["primary"] = ((doc.get("lanes") or {}).get(lane)
                            or {}).get("primary")
        event.update(attrs)
        history = doc.setdefault("history", [])
        history.append(event)
        del history[:-_HISTORY_CAP]

    # ---------------------------------------------------------------- sync
    def sync(self) -> List[dict]:
        """One coordination beat (the front door's background thread
        calls this a few times a second): flush locally-accumulated
        window counters, heartbeat, maintain the leader lease, and —
        when this worker HOLDS the lease — close due windows over the
        FLEET aggregate and advance/roll back the shared stage, fenced
        on the lease term (see module doc). Returns the history events
        this worker has not yet applied locally (promotions/rollbacks →
        the caller repoints and drains its local deploys)."""
        with self._lock:
            pending, self._pending = self._pending, {}
        wid = self.worker_id

        def mutate(doc):
            self._maybe_rebuild(doc)
            workers = doc.setdefault("workers", {})
            me = workers.setdefault(wid, {"pid": os.getpid(), "port": 0,
                                          "started": _now()})
            if self._reg is not None and not me.get("port"):
                # re-registration: a rebuilt/reset doc lost this
                # worker's announcement — restore it or the proxy never
                # routes to this worker again
                me["pid"], me["port"] = self._reg
            me["heartbeat"] = _now()
            mine = doc.setdefault("windows", {}).setdefault(wid, {})
            for version, d in pending.items():
                w = mine.setdefault(version, _zero())
                w["n"] += d["n"]
                w["err"] += d["err"]
                w["lat_sum"] += d["lat_sum"]
                w["lat_n"] += d["lat_n"]
            now = _now()
            alive = sorted(
                w for w, rec in workers.items()
                if _age(now, rec.get("heartbeat", 0)) <= WORKER_TTL_S)
            if fleet_fence_enabled():
                self._fenced_leadership(doc, alive, now)
            else:
                # pre-fence semantics, byte-identical: lowest alive id
                # leads, no terms, no demotion accounting
                self._is_leader = bool(alive) and min(alive) == wid
                self._term = None
            if self._is_leader:
                for lane, st in (doc.get("lanes") or {}).items():
                    self._evaluate_lane(doc, lane, st)
        try:
            doc = self.store.update(mutate)
        except BaseException:
            # a failed store write must not LOSE the popped window
            # counters — merge them back so the next beat flushes them
            # (dropped samples would let the leader grade a window that
            # silently undercounts a failing candidate's errors)
            with self._lock:
                for version, d in pending.items():
                    w = self._pending.setdefault(version, _zero())
                    for k in d:
                        w[k] += d[k]
            raise
        self._remember(doc)
        self._invalidate()
        # re-export the proxy's failover count as a scrapeable worker
        # series (the proxy process itself has no /metrics surface);
        # the series only exists once a failover actually happened
        prox = doc.get("proxy") or {}
        try:
            fo = int(prox.get("failovers", 0))
        except (TypeError, ValueError):
            fo = 0
        if fo > self._failovers_seen:
            _failovers_total().inc(fo - self._failovers_seen)
            self._failovers_seen = fo
        elif fo < self._failovers_seen:
            self._failovers_seen = fo        # proxy restarted / rebuilt
        events = [e for e in doc.get("history", [])
                  if int(e.get("seq", 0)) > self._applied_seq]
        if events:
            self._applied_seq = max(int(e["seq"]) for e in events)
        return events

    # ------------------------------------------------------- leadership
    def _fenced_leadership(self, doc: dict, alive: List[str], now: float):
        """Lease maintenance + the write-time fence (runs INSIDE the
        serialized update — atomic with any leader-only write this beat
        performs). Leadership moves ONLY when the holder's lease (its
        heartbeat) expires; the successor bumps the term."""
        wid = self.worker_id
        led = doc.get("leader") or {}
        holder = led.get("worker")
        holder_rec = (doc.get("workers") or {}).get(holder) \
            if holder else None
        holder_alive = (
            holder_rec is not None
            and _age(now, holder_rec.get("heartbeat", 0)) <= WORKER_TTL_S)
        if not holder_alive and alive and min(alive) == wid:
            term = int(led.get("term", 0)) + 1
            doc["leader"] = {"worker": wid, "term": term, "since": now}
            _faults.record_event("leader_acquired", worker=wid, term=term,
                                 previous=holder)
        led = doc.get("leader") or {}
        cur_term = int(led.get("term", 0))
        i_lead = led.get("worker") == wid
        if (self._is_leader and self._term is not None
                and (not i_lead or cur_term != self._term)):
            # the fence caught a stale leader AT WRITE TIME: this worker
            # believed it held term N but the store moved on — its
            # leader-only writes this beat lose (skipped), counted
            self._demotions += 1
            _demotions_total().inc()
            _faults.record_event("leader_demoted", worker=wid,
                                 stale_term=self._term,
                                 current_term=cur_term,
                                 current_leader=led.get("worker"))
        self._is_leader = i_lead
        self._term = cur_term if i_lead else None
        _leader_term_gauge().set(float(cur_term))

    def _guard_stage(self, doc: dict, lane: str, ro: dict,
                     new_stage: str, new_idx: Optional[int] = None) -> bool:
        """Monotonicity guard: the stage can never move backward — and
        within RAMP the ramp index can never decrease — except via the
        explicit, history-sequenced ROLLED_BACK transition. A blocked
        move is ringed, never applied."""
        if new_stage == ROLLED_BACK:
            return True
        cur = ro.get("stage")
        backward = (_STAGE_RANK.get(new_stage, 0) < _STAGE_RANK.get(cur, 0)
                    or (new_stage == RAMP and cur == RAMP
                        and new_idx is not None
                        and new_idx < int(ro.get("ramp_idx", -1))))
        if backward:
            _faults.record_event("stage_regression_blocked", lane=lane,
                                 worker=self.worker_id,
                                 current=cur, attempted=new_stage,
                                 term=self._term)
            return False
        return True

    def _evaluate_lane(self, doc: dict, lane: str, st: dict):
        """Leader-only, fenced by the caller: close the lane's window if
        due and grade the fleet-aggregated deltas (error rate +
        latency-mean ratio; any non-ok grade rolls back, ok streaks
        advance — the local CanaryRollout's promotion discipline over
        shared counters)."""
        ro = st.get("rollout")
        if not ro or not ro.get("active"):
            return
        pol = ro.get("policy") or DEFAULT_POLICY
        now = _now()
        if _age(now, ro.get("window_started", now)) \
                < float(pol["window_seconds"]):
            return
        windows = doc.get("windows") or {}
        cand, prim = ro["candidate"], st.get("primary")
        base = ro.get("window_base") or {}
        cand_cur = _agg(windows, cand)
        prim_cur = _agg(windows, prim)
        d_cand = _delta(cand_cur, base.get(cand))
        d_prim = _delta(prim_cur, base.get(prim))
        if d_cand["n"] < int(pol["window_min_requests"]):
            return          # window stays open until samples arrive
        status = OK
        detail = {}
        rate = d_cand["err"] / d_cand["n"]
        detail["error_rate"] = rate
        status = _worst(status, _grade(rate, pol["error_rate_degraded"],
                                       pol["error_rate_failing"]))
        if (d_cand["lat_n"] >= int(pol["min_latency_n"])
                and d_prim["lat_n"] >= int(pol["min_latency_n"])
                and d_prim["lat_sum"] > 0):
            ratio = ((d_cand["lat_sum"] / d_cand["lat_n"])
                     / (d_prim["lat_sum"] / d_prim["lat_n"]))
            detail["latency_ratio"] = ratio
            status = _worst(status, _grade(
                ratio, pol["latency_ratio_degraded"],
                pol["latency_ratio_failing"]))
        ro["window_started"] = now
        ro["window_base"] = {cand: cand_cur, prim: prim_cur}
        ro["last_report"] = dict(detail, status=status,
                                 window_requests=d_cand["n"],
                                 **self._writer_stamp(doc))
        if status in (DEGRADED, FAILING):
            prev = ro["stage"]
            ro.update(stage=ROLLED_BACK, share=0.0, active=False,
                      reason=f"slo:{status} {detail}")
            self._note(doc, lane, prev, ROLLED_BACK, share=0.0,
                       reason=ro["reason"], **self._writer_stamp(doc))
            return
        ro["healthy_streak"] = int(ro.get("healthy_streak", 0)) + 1
        if ro["healthy_streak"] < int(pol["healthy_windows"]):
            return
        ro["healthy_streak"] = 0
        prev = ro["stage"]
        ramp = list(pol.get("ramp_fractions") or ())
        idx = int(ro.get("ramp_idx", -1)) + 1
        if idx < len(ramp):
            if not self._guard_stage(doc, lane, ro, RAMP, idx):
                return
            ro.update(stage=RAMP, share=float(ramp[idx]), ramp_idx=idx)
            self._note(doc, lane, prev, RAMP, share=ro["share"],
                       **self._writer_stamp(doc))
        else:
            if not self._guard_stage(doc, lane, ro, FULL):
                return
            old_primary = st.get("primary")
            ro.update(stage=FULL, share=1.0, active=False)
            st["primary"] = ro["candidate"]
            self._note(doc, lane, prev, FULL, share=1.0,
                       old_primary=old_primary, **self._writer_stamp(doc))

    # ------------------------------------------------ corruption rebuild
    def _remember(self, doc: dict):
        """Mirror the durable fleet facts this worker just observed in a
        COMMITTED document — the rebuild source after a quarantine."""
        try:
            lanes = copy.deepcopy(doc.get("lanes") or {})
        # graftlint: disable=typed-errors — the mirror is best-effort
        # redundancy; an uncopyable doc just skips one refresh
        except Exception:
            return
        with self._lock:
            self._mirror = {
                "rev": int(doc.get("rev", 0)),
                "hseq": int(doc.get("hseq", 0)),
                "lanes": lanes,
                "history": list(doc.get("history") or ()),
                "leader_term": int((doc.get("leader") or {})
                                   .get("term", 0)),
            }

    def _maybe_rebuild(self, doc: dict):
        """Inside a serialized write: when the document's rev regressed
        below this worker's mirror (a corrupt doc was quarantined and
        the store restarted empty), rebuild the fleet state — lanes
        restored to the replay result of every applied history event,
        the history itself re-seeded, the leader term carried forward
        (monotonicity survives the rebuild), and the active rollout's
        window re-baselined (its old aggregates died with the doc).
        Workers merge additively: the first rebuilder seeds, later ones
        only add lanes/history the seed lacked."""
        with self._lock:
            m = dict(self._mirror) if self._mirror else None
        if m is None or int(doc.get("rev", 0)) >= m["rev"]:
            return
        lanes = doc.setdefault("lanes", {})
        for lane, st in (m["lanes"] or {}).items():
            if lane in lanes:
                continue
            restored = copy.deepcopy(st)
            ro = restored.get("rollout")
            if ro and ro.get("active"):
                # the fleet's window counters died with the doc: an old
                # baseline would hold every delta at zero until the new
                # counters caught up — re-baseline at zero instead
                ro["window_base"] = {}
                ro["window_started"] = _now()
            lanes[lane] = restored
        if int(doc.get("hseq", 0)) < m["hseq"]:
            doc["hseq"] = m["hseq"]
            doc["history"] = list(m["history"])
        led = doc.get("leader") or {}
        if int(led.get("term", 0)) < m["leader_term"]:
            # term continuity: the next acquisition must bump PAST every
            # term ever granted, or the strict-monotonicity audit breaks
            doc["leader"] = {"worker": None, "term": m["leader_term"],
                             "since": _now()}
        doc["rebuilt"] = {"at": _now(), "by": self.worker_id,
                          "hseq": m["hseq"],
                          "n": int((doc.get("rebuilt") or {})
                                   .get("n", 0)) + 1}
        self._rebuilds += 1
        _faults.record_event("store_rebuilt", worker=self.worker_id,
                             hseq=m["hseq"], from_rev=m["rev"])

    def _invalidate(self):
        with self._lock:
            self._routing_cache = (0.0, {})

    # ------------------------------------------------------------ queries
    @property
    def is_leader(self) -> bool:
        return self._is_leader

    @property
    def leader_term(self) -> Optional[int]:
        """The term this worker currently leads under (None = follower)."""
        return self._term

    def alive_workers(self, ttl_s: float = WORKER_TTL_S) -> Dict[str, dict]:
        now = _now()
        return {w: rec for w, rec
                in (self.store.read().get("workers") or {}).items()
                if _age(now, rec.get("heartbeat", 0)) <= ttl_s}

    def snapshot(self) -> dict:
        doc = self.store.read()
        now = _now()
        workers = {
            w: dict(rec, alive=(_age(now, rec.get("heartbeat", 0))
                                <= WORKER_TTL_S))
            for w, rec in (doc.get("workers") or {}).items()}
        return {
            "path": self.store.path,
            "rev": doc.get("rev", 0),
            "worker_id": self.worker_id,
            "is_leader": self._is_leader,
            "fence": {
                "enabled": fleet_fence_enabled(),
                "leader": doc.get("leader"),
                "term": self._term,
                "demotions": self._demotions,
                "rebuilds": self._rebuilds,
            },
            "rebuilt": doc.get("rebuilt"),
            "proxy": doc.get("proxy"),
            "lanes": doc.get("lanes", {}),
            "workers": workers,
            "history": doc.get("history", [])[-16:],
        }


_SEVERITY = {OK: 0, DEGRADED: 1, FAILING: 2}


def _worst(a: str, b: str) -> str:
    return a if _SEVERITY[a] >= _SEVERITY[b] else b
