"""Durable generation sessions: journaling, adoption, exactly-once resume.

An in-flight generation stream used to be the one serving artifact that
died with its worker: idempotency keys made *unary* retries exactly-once
(PR 14) and the fleet plane survives a SIGKILL (PR 15), but a worker
dying mid-SSE silently truncated every stream it carried. This module is
the durable substrate that closes that gap — and the handoff format
ROADMAP item 4 (disaggregated prefill/decode) needs:

- every admitted generation gets a :class:`Session` record — prompt (and
  its hash), sampler config + base seed, the emitted-token log, and a
  per-session monotonic token **sequence number** (``seq`` == the token's
  index in the stream);
- the in-memory :class:`SessionTable` ring is the fast path (decode-hot
  appends are a list append, nothing else); a background
  :class:`SessionJournal` thread batches dirty sessions into the PR-11
  ``SharedStore`` under the worker's lease at step-boundary granularity
  — the decode loop only pokes an ``Event``;
- resume is deterministic because sampling is in-graph seeded
  (``fold_in(base_key, step)``, PR 10): a survivor re-prefills
  ``prompt + emitted_tokens`` and continues the stream (byte-identical
  under greedy — argmax ignores the folded step);
- adoption is **lease-fenced**: :func:`adopt` bumps the record's fence
  inside one serialized ``SharedStore.update``; the previous owner's
  next journal flush sees the higher fence, drops its write, and marks
  its local copy stolen so a stalled-but-alive worker can never
  double-decode (or double-journal) an adopted stream.

Knobs (all read live):

- ``DL4J_TPU_SESSIONS`` — kill switch (``0`` restores byte-identical
  pre-session behavior: no records, no ``id:`` SSE lines, no journal);
- ``DL4J_TPU_SESSION_JOURNAL_STEPS`` — journal cadence: a live session
  flushes once it has this many unjournaled tokens (finished or
  never-written sessions flush on the next beat regardless); the cadence
  bounds how many tokens a crash can lose;
- ``DL4J_TPU_SESSION_JOURNAL_BYTES`` — this worker's byte budget for its
  journaled blob in the store (oldest finished records evict first, then
  oldest live — evictions are counted, never silent);
- ``DL4J_TPU_SESSION_RING`` — in-memory table cap (same eviction order).

Observability: ``dl4j_session_*`` series, ``/debug/sessions`` on the
front door, and ``sessions.json`` in flight-recorder bundles.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observability import global_registry, on_registry_reset
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience.policy import ShedError

#: store records older than this are swept by the journal flush (a
#: finished session only needs to outlive the client's replay window)
FINISHED_TTL_S = 600.0

#: how often the journal thread wakes WITHOUT a step-boundary poke (the
#: poke is the normal path; this is the straggler sweep)
FLUSH_INTERVAL_S = 0.05


def sessions_enabled() -> bool:
    """``DL4J_TPU_SESSIONS`` kill switch, read live (``0`` restores
    byte-identical pre-session behavior, pinned by a test)."""
    return os.environ.get("DL4J_TPU_SESSIONS", "1") != "0"


def flush_interval_s() -> float:
    """``DL4J_TPU_SESSION_FLUSH_MS``: minimum spacing between journal
    store commits (default 250ms).  Per-token notifies coalesce into one
    batched commit per interval — a crash can lose at most this much of
    the tail, and deterministic resume regenerates exactly that suffix
    (seq dedup keeps delivery exactly-once), so staleness here trades
    only recompute, never correctness."""
    try:
        ms = float(os.environ.get("DL4J_TPU_SESSION_FLUSH_MS", "250"))
    except ValueError:
        ms = 250.0
    return max(0.01, ms / 1000.0)


def journal_cadence_steps() -> int:
    """``DL4J_TPU_SESSION_JOURNAL_STEPS``: unjournaled tokens a live
    session accumulates before the next beat flushes it."""
    try:
        return max(1, int(os.environ.get(
            "DL4J_TPU_SESSION_JOURNAL_STEPS", "8")))
    except ValueError:
        return 8


def journal_byte_budget() -> int:
    """``DL4J_TPU_SESSION_JOURNAL_BYTES``: this worker's byte budget for
    its sessions blob in the shared store."""
    try:
        return max(4096, int(os.environ.get(
            "DL4J_TPU_SESSION_JOURNAL_BYTES", str(256 * 1024))))
    except ValueError:
        return 256 * 1024


def ring_capacity() -> int:
    """``DL4J_TPU_SESSION_RING``: in-memory session table cap."""
    try:
        return max(8, int(os.environ.get("DL4J_TPU_SESSION_RING", "256")))
    except ValueError:
        return 256


def new_session_id() -> str:
    """A fresh globally-unique session id (the front door mints one per
    admitted generation unless the client/proxy supplied one)."""
    return "s-" + os.urandom(8).hex()


def prompt_hash(prompt) -> str:
    """Stable content hash of a prompt token sequence (the session
    record's identity check on resume)."""
    import numpy as np
    arr = np.asarray(prompt, np.int32).reshape(-1)
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()


class SessionLost(ShedError):
    """This worker's lease on a session was fenced off (another worker
    adopted it) — the local decode must stop; the adopter owns the
    stream now. A typed lifecycle outcome of failover (``ShedError``
    subclass), never an error-rate event."""


class _SessionMetrics:
    """Label-bound ``dl4j_session_*`` instruments (registry-reset safe,
    the _GenMetrics pattern)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        reg = global_registry()
        self.journal_writes = reg.counter(
            "dl4j_session_journal_writes_total",
            "batched session-journal commits into the shared store (one "
            "per flush beat that had dirty sessions, not per session)")
        self.journal_tokens = reg.counter(
            "dl4j_session_journal_tokens_total",
            "emitted tokens made durable by the session journal")
        self.adoptions = reg.counter(
            "dl4j_session_adoptions_total",
            "orphaned sessions this worker adopted from the store "
            "(lease-fenced; the previous owner can no longer journal)")
        self.resumes = reg.counter(
            "dl4j_session_resumes_total",
            "sessions re-entered via re-prefill of prompt + emitted "
            "tokens (local in-place fault resume + adopted failover)")
        self.lost_lease = reg.counter(
            "dl4j_session_lost_lease_total",
            "journal writes dropped because another worker fenced this "
            "one off (the local decode stops; no double-journal)")
        self.evicted = reg.counter(
            "dl4j_session_evicted_total",
            "session records evicted by the ring cap or the store byte "
            "budget, by surface",
            label_names=("surface",))
        self.live = reg.gauge(
            "dl4j_session_live",
            "sessions currently decoding on this worker")

    @classmethod
    def get(cls) -> "_SessionMetrics":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance


@on_registry_reset
def _drop_session_metrics():
    _SessionMetrics._instance = None


def session_metrics() -> "_SessionMetrics":
    """The label-bound session instruments (the pipeline's resume path
    lives in ``parallel/`` and must not reach for a private)."""
    return _SessionMetrics.get()


class Session:
    """One generation's durable record. The decode thread appends tokens
    (plain list append — CPython-atomic, no lock on the hot path); the
    journal thread snapshots a consistent prefix by reading ``len``
    first. Everything else is bookkeeping off the decode path."""

    __slots__ = ("sid", "prompt", "prompt_hash", "sampler", "seed",
                 "max_new_tokens", "eos_id", "tenant", "version",
                 "status", "tokens", "journaled", "status_journaled",
                 "fence", "stolen", "created", "updated", "resumed")

    def __init__(self, sid: str, prompt: List[int], sampler: dict,
                 seed: Optional[int], max_new_tokens: int,
                 eos_id: Optional[int], tenant: Optional[str] = None,
                 version: Optional[str] = None,
                 tokens: Optional[List[int]] = None, fence: int = 0):
        self.sid = str(sid)
        self.prompt = [int(t) for t in prompt]
        self.prompt_hash = prompt_hash(self.prompt)
        self.sampler = dict(sampler or {})
        self.seed = seed
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.tenant = tenant
        self.version = version
        self.status = "live"
        self.tokens: List[int] = [int(t) for t in (tokens or [])]
        # durable watermark: tokens[:journaled] are in the store
        self.journaled = len(self.tokens)
        self.status_journaled = "live"
        self.fence = int(fence)
        self.stolen = False
        self.created = time.time()
        self.updated = self.created
        self.resumed = 0

    def append(self, tok: int) -> int:
        """Record one emitted token; returns its sequence number."""
        self.tokens.append(int(tok))
        self.updated = time.time()
        return len(self.tokens) - 1

    def finish(self, status: str):
        """Terminal transition (idempotent — the first outcome wins, the
        same discipline as ``_Request.claim``)."""
        if self.status == "live":
            self.status = status
            self.updated = time.time()

    @property
    def seq(self) -> int:
        """Next sequence number == tokens emitted so far."""
        return len(self.tokens)

    def to_store_doc(self, n: int, owner: Optional[str]) -> dict:
        """The record as journaled (``tokens[:n]`` — a consistent prefix
        snapshot taken by the journal thread)."""
        return {
            "sid": self.sid,
            "prompt": list(self.prompt),
            "prompt_hash": self.prompt_hash,
            "sampler": dict(self.sampler),
            "seed": self.seed,
            "max_new_tokens": self.max_new_tokens,
            "eos_id": self.eos_id,
            "tenant": self.tenant,
            "version": self.version,
            "status": self.status,
            "tokens": list(self.tokens[:n]),
            "seq": int(n),
            "fence": int(self.fence),
            "owner": owner,
            "created": self.created,
            "updated": time.time(),
        }

    def summary(self) -> dict:
        return {
            "sid": self.sid,
            "status": self.status,
            "prompt_tokens": len(self.prompt),
            "prompt_hash": self.prompt_hash,
            "emitted": len(self.tokens),
            "journaled": self.journaled,
            "fence": self.fence,
            "stolen": self.stolen,
            "tenant": self.tenant,
            "version": self.version,
            "resumed": self.resumed,
            "created": self.created,
            "updated": self.updated,
        }


class SessionTable:
    """The in-memory ring of this process's sessions (the fast path).
    Bounded by ``DL4J_TPU_SESSION_RING``; finished sessions evict before
    live ones, oldest first, and every eviction is counted."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sessions: "Dict[str, Session]" = {}

    def begin(self, prompt, sampler: dict, seed, max_new_tokens: int,
              eos_id, tenant=None, version=None,
              sid: Optional[str] = None) -> Session:
        s = Session(sid or new_session_id(), list(map(int, prompt)),
                    sampler, seed, max_new_tokens, eos_id,
                    tenant=tenant, version=version)
        with self._lock:
            self._sessions[s.sid] = s
            self._evict_over_cap()
        self._publish_live()
        return s

    def adopt_local(self, record: dict) -> Session:
        """Mirror an adopted store record locally (the survivor journals
        the continued stream under the bumped fence)."""
        s = Session(record["sid"], record.get("prompt") or [],
                    record.get("sampler") or {}, record.get("seed"),
                    int(record.get("max_new_tokens") or 1),
                    record.get("eos_id"),
                    tenant=record.get("tenant"),
                    version=record.get("version"),
                    tokens=record.get("tokens") or [],
                    fence=int(record.get("fence") or 0))
        s.resumed = int(record.get("resumed") or 0) + 1
        with self._lock:
            self._sessions[s.sid] = s
            self._evict_over_cap()
        self._publish_live()
        return s

    def _evict_over_cap(self):
        # caller holds the lock
        cap = ring_capacity()
        if len(self._sessions) <= cap:
            return
        obs = _SessionMetrics.get()
        # graftlint: disable=lock-discipline — every caller already
        # holds self._lock (checker can't cross calls)
        by_age = sorted(self._sessions.values(),
                        key=lambda s: (s.status == "live", s.created))
        for s in by_age:
            if len(self._sessions) <= cap:
                break
            self._sessions.pop(s.sid, None)
            obs.evicted.labels(surface="ring").inc()

    def _publish_live(self):
        with self._lock:
            n = sum(1 for s in self._sessions.values()
                    if s.status == "live")
        _SessionMetrics.get().live.set(n)

    def get(self, sid: str) -> Optional[Session]:
        with self._lock:
            return self._sessions.get(sid)

    def items(self) -> List[Session]:
        with self._lock:
            return list(self._sessions.values())

    def dirty(self) -> List[Session]:
        """Sessions with unjournaled state: new tokens past the cadence,
        a terminal status not yet written, or never written at all."""
        cadence = journal_cadence_steps()
        out = []
        with self._lock:
            for s in self._sessions.values():
                if s.stolen:
                    continue
                n = len(s.tokens)
                if (s.journaled == 0 and s.status == "live"
                        and s.status_journaled == "live" and n == 0
                        and s.created == s.updated):
                    # brand new, no tokens yet: write the admission
                    # record so a crash before the first boundary is
                    # still resumable
                    out.append(s)
                elif n - s.journaled >= cadence:
                    out.append(s)
                elif s.status != s.status_journaled:
                    out.append(s)
                elif s.journaled == 0 and (n > 0 or s.status != "live"):
                    out.append(s)
        return out

    def clear(self):
        with self._lock:
            self._sessions.clear()
        self._publish_live()


class SessionJournal:
    """The batched store writer. ``attach(store, worker_id)`` arms it
    (one daemon thread); ``notify()`` is the decode loop's step-boundary
    poke (an ``Event.set`` — the ONLY hot-path cost). Every flush is one
    serialized ``SharedStore.update`` carrying every dirty session, with
    the fence check inside the mutate: a record whose store fence
    outruns the local one was adopted elsewhere — the write is dropped,
    the local session marked stolen, and the pipeline stops decoding it
    at the next boundary."""

    def __init__(self, table: SessionTable):
        self._table = table
        self._store = None
        self._worker_id: Optional[str] = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ wiring
    def attach(self, store, worker_id: str):
        """Arm journaling into ``store`` under this worker's lease.
        Idempotent; re-attach swaps the target (tests)."""
        with self._lock:
            self._store = store
            self._worker_id = str(worker_id)
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="dl4j-session-journal")
                self._thread.start()

    def detach(self):
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        with self._lock:
            self._store = None
            self._worker_id = None
            self._thread = None

    @property
    def attached(self) -> bool:
        return self._store is not None

    @property
    def worker_id(self) -> Optional[str]:
        return self._worker_id

    def notify(self):
        """Step-boundary poke from the decode loop (cheap; no-op when
        not attached)."""
        # skip the Event.set when a poke is already pending — set()
        # takes the condition lock even when redundant, and this runs
        # once per decode step on the hot path
        if self._store is not None and not self._wake.is_set():
            self._wake.set()

    # ------------------------------------------------------------- flush
    def _run(self):
        while not self._stop.is_set():
            self._wake.wait(timeout=FLUSH_INTERVAL_S)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.flush()
            # graftlint: disable=typed-errors — a store blip must never
            # kill the journal thread; the next beat retries the batch
            except Exception:
                pass
            # coalesce: per-token notifies must not become per-token
            # store commits — hold the beat closed for the flush
            # interval so the next commit batches everything that
            # accumulated (bounded staleness; resume regenerates it)
            self._stop.wait(flush_interval_s())

    def flush(self) -> int:
        """One batched commit of every dirty session. Returns the number
        of sessions written (tests call this synchronously)."""
        store, wid = self._store, self._worker_id
        if store is None or wid is None:
            return 0
        dirty = self._table.dirty()
        if not dirty:
            return 0
        # snapshot consistent prefixes OFF the mutate (the decode thread
        # keeps appending; the store write must carry a stable n)
        batch = []
        for s in dirty:
            n = len(s.tokens)
            batch.append((s, n, s.status, s.to_store_doc(n, wid)))
        stolen: List[Session] = []
        written: List[tuple] = []
        budget = journal_byte_budget()
        evicted = {"n": 0}

        def mutate(doc):
            written.clear()
            stolen.clear()
            evicted["n"] = 0
            blob = doc.setdefault("sessions", {})
            for s, n, status, rec in batch:
                cur = blob.get(s.sid)
                if cur is not None and int(cur.get("fence") or 0) > s.fence:
                    # adopted elsewhere: the fence outran us — drop the
                    # write and stop decoding locally
                    stolen.append(s)
                    continue
                blob[s.sid] = rec
                written.append((s, n, status))
            # sweep + byte budget over THIS worker's records only (other
            # workers own their slices; never touch them)
            now = time.time()
            mine = [(k, r) for k, r in blob.items()
                    if r.get("owner") == wid]
            for k, r in mine:
                if (r.get("status") != "live"
                        and now - float(r.get("updated") or 0)
                        > FINISHED_TTL_S):
                    blob.pop(k, None)
            mine = [(k, r) for k, r in blob.items()
                    if r.get("owner") == wid]
            size = sum(len(json.dumps(r, default=str)) for _, r in mine)
            if size > budget:
                # finished first, then oldest live — bounded growth is
                # a hard property, not a best effort
                order = sorted(mine, key=lambda kr: (
                    kr[1].get("status") == "live",
                    float(kr[1].get("updated") or 0)))
                for k, r in order:
                    if size <= budget:
                        break
                    size -= len(json.dumps(r, default=str))
                    blob.pop(k, None)
                    evicted["n"] += 1

        store.update(mutate)
        obs = _SessionMetrics.get()
        if written:
            obs.journal_writes.inc()
        new_tokens = 0
        for s, n, status in written:
            new_tokens += max(0, n - s.journaled)
            s.journaled = max(s.journaled, n)
            s.status_journaled = status
        if new_tokens:
            obs.journal_tokens.inc(new_tokens)
        for s in stolen:
            s.stolen = True
            obs.lost_lease.inc()
            _faults.record_event("session_lost_lease", sid=s.sid,
                                 worker=wid)
        if evicted["n"]:
            obs.evicted.labels(surface="store").inc(evicted["n"])
        self._table._publish_live()
        return len(written)


# ------------------------------------------------------------ singletons
_table = SessionTable()
_journal = SessionJournal(_table)


def global_sessions() -> SessionTable:
    return _table


def global_journal() -> SessionJournal:
    return _journal


# -------------------------------------------------------------- adoption
def adopt(store, sid: str, worker_id: str) -> dict:
    """Fence-bump ``sid``'s store record to ``worker_id`` and return it.

    Runs inside ONE serialized ``SharedStore.update`` — the adoption and
    the fence bump are atomic, so exactly one survivor wins a contested
    orphan and the loser (or the stalled previous owner) is fenced off
    on its next journal write. Raises ``KeyError`` when the session was
    never journaled (nothing durable to adopt)."""
    out = {}

    def mutate(doc):
        blob = doc.setdefault("sessions", {})
        rec = blob.get(sid)
        if rec is None:
            raise KeyError(f"session {sid!r} is not in the store "
                           "(never journaled, or already swept)")
        rec = dict(rec)
        rec["fence"] = int(rec.get("fence") or 0) + 1
        prev = rec.get("owner")
        rec["owner"] = str(worker_id)
        rec["adopted_from"] = prev
        rec["resumed"] = int(rec.get("resumed") or 0) + 1
        rec["updated"] = time.time()
        blob[sid] = rec
        out.clear()
        out.update(rec)

    store.update(mutate)
    _SessionMetrics.get().adoptions.inc()
    _faults.record_event("session_adopt", sid=sid, worker=worker_id,
                         fence=out.get("fence"),
                         adopted_from=out.get("adopted_from"))
    return out


def store_record(store, sid: str) -> Optional[dict]:
    """Read one session record from the store (no fencing — the
    adoption decision path and the debug surfaces)."""
    try:
        doc = store.read()
    # graftlint: disable=typed-errors — a torn read answers "not found";
    # the caller's adoption attempt will surface the real failure
    except Exception:
        return None
    rec = (doc.get("sessions") or {}).get(sid)
    return dict(rec) if rec is not None else None


# -------------------------------------------------------------- snapshot
def snapshot() -> dict:
    """The ``/debug/sessions`` payload (also ``sessions.json`` in
    flight-recorder bundles)."""
    return {
        "enabled": sessions_enabled(),
        "worker": _journal.worker_id,
        "journal_attached": _journal.attached,
        "cadence_steps": journal_cadence_steps(),
        "byte_budget": journal_byte_budget(),
        "ring_capacity": ring_capacity(),
        "sessions": sorted((s.summary() for s in _table.items()),
                           key=lambda d: d["created"]),
    }


def reset_for_tests():
    """Drop every in-memory session and detach the journal (test
    teardown; mirrors the registry-reset discipline)."""
    _journal.detach()
    _table.clear()
