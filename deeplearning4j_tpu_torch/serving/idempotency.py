"""Idempotent request retries: the front door's result journal.

A client (or the fleet proxy's connect-failover) that retries after a
worker death cannot know whether the original request executed — and a
re-executed generation double-charges the tenant's token debt and
double-spends device work. The fix is the standard idempotency-key
contract: the caller stamps ``X-Dl4j-Idempotency-Key`` on
``/v1/classify`` / ``/v1/generate``; the door journals one outcome per
key and a retried key **returns the original outcome** (or attaches to
the still-in-flight request) without re-executing — so QoS token debt is
charged exactly once per key, by construction.

Journal policy (who gets remembered):

- an outcome reached AFTER execution began — success, deadline, stream
  cancel, device error — is **resolved** into the journal: partial work
  may have been charged, so a retry must replay, never re-run;
- a rejection BEFORE execution (quota 429 at the door, the in-flight
  gate, the disabled switch) **abandons** the key: nothing ran, nothing
  was charged, and a later retry deserves a real attempt;
- a retry arriving while the original is still executing **attaches**:
  it waits (bounded) for the in-flight resolution and returns it.

The journal is bounded two ways: resolved entries expire after
``DL4J_TPU_IDEMPOTENCY_TTL_S`` (default 600 s — longer than any sane
client retry horizon) and the table caps at
``DL4J_TPU_IDEMPOTENCY_MAX`` entries (default 4096; oldest RESOLVED
entries evicted first, in-flight entries never). Keys above the cap are
served untracked (at-least-once, counted) rather than refused —
availability over bookkeeping.

Every replay served is counted (``dl4j_fleet_idempotent_replays_total``)
and the per-key execution counts are exported on ``/debug/fleet`` /
``fleet.json`` — the fleet chaos drill audits "zero duplicate
executions" directly from this table.

Kill switch ``DL4J_TPU_IDEMPOTENCY=0`` (read live): the header is inert,
no journal exists, no new metric series — byte-identical pre-journal
behavior.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from deeplearning4j_tpu_torch.resilience import faults as _faults

#: the idempotency-key request header (absent = no journal interaction)
IDEMPOTENCY_HEADER = "X-Dl4j-Idempotency-Key"

#: the response header a replayed/attached outcome carries
REPLAY_HEADER = "X-Dl4j-Idempotent-Replay"

NEW, INFLIGHT, DONE = "new", "inflight", "done"


def idempotency_enabled() -> bool:
    """``DL4J_TPU_IDEMPOTENCY`` kill switch (read live, per request)."""
    return os.environ.get("DL4J_TPU_IDEMPOTENCY", "1") != "0"


def journal_ttl_s() -> float:
    """``DL4J_TPU_IDEMPOTENCY_TTL_S``: how long a resolved outcome
    stays replayable."""
    try:
        return max(1.0, float(
            os.environ.get("DL4J_TPU_IDEMPOTENCY_TTL_S", 600.0)))
    except (TypeError, ValueError):
        return 600.0


def journal_max_entries() -> int:
    """``DL4J_TPU_IDEMPOTENCY_MAX``: journal table cap."""
    try:
        return max(16, int(os.environ.get("DL4J_TPU_IDEMPOTENCY_MAX",
                                          4096)))
    except (TypeError, ValueError):
        return 4096


def _replays_total():
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_fleet_idempotent_replays_total",
            "retried idempotency keys served from the result journal "
            "(or attached to the in-flight original) WITHOUT "
            "re-executing — each one is a prevented duplicate "
            "execution / double charge")
    return _faults.cached_metric_handle(("fleet", "idem_replays"), make)


class _Entry:
    __slots__ = ("key", "state", "code", "payload", "event", "created",
                 "resolved_at", "executions", "replays")

    def __init__(self, key: str):
        self.key = key
        self.state = INFLIGHT
        self.code: Optional[int] = None
        self.payload: Optional[dict] = None
        self.event = threading.Event()
        self.created = time.monotonic()
        self.resolved_at: Optional[float] = None
        self.executions = 0
        self.replays = 0


class ResultJournal:
    """Bounded, TTL'd key → outcome table. One per process (the
    journal's exactly-once scope is the worker — a cross-process retry
    that lands on a DIFFERENT worker only re-executes when the original
    worker died with its un-charged work, which is the safe case)."""

    def __init__(self, ttl_s: Optional[float] = None,
                 max_entries: Optional[int] = None):
        self._ttl = ttl_s
        self._max = max_entries
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._untracked = 0     # keys served at-least-once past the cap

    def _ttl_s(self) -> float:
        return self._ttl if self._ttl is not None else journal_ttl_s()

    def _cap(self) -> int:
        return self._max if self._max is not None else journal_max_entries()

    # ------------------------------------------------------------ begin
    def begin(self, key: str) -> Tuple[Optional[_Entry], str]:
        """First sight of ``key`` → a fresh INFLIGHT entry + ``"new"``
        (the caller executes and must resolve/abandon). A known key →
        its entry + ``"inflight"``/``"done"`` (the caller replays).
        ``(None, "new")`` = the table is saturated with in-flight work:
        the request is served untracked rather than refused."""
        key = str(key)[:256]
        now = time.monotonic()
        with self._lock:
            self._purge_locked(now)
            entry = self._entries.get(key)
            if entry is not None:
                return entry, entry.state
            if len(self._entries) >= self._cap():
                if not self._evict_locked():
                    self._untracked += 1
                    return None, NEW
            entry = self._entries[key] = _Entry(key)
            return entry, NEW

    def _purge_locked(self, now: float):
        # graftlint: disable=lock-discipline — *_locked contract: every
        # caller holds self._lock around this helper
        stale = [k for k, e in self._entries.items()
                 if e.resolved_at is not None
                 and now - e.resolved_at > self._ttl_s()]
        for k in stale:
            del self._entries[k]

    def _evict_locked(self) -> bool:
        """Drop the oldest RESOLVED entry; in-flight entries are never
        evicted (evicting one would detach its eventual resolution)."""
        # graftlint: disable=lock-discipline — *_locked contract: every
        # caller holds self._lock around this helper
        for k, e in self._entries.items():
            if e.state == DONE:
                del self._entries[k]
                return True
        return False

    # ------------------------------------------------------- resolution
    def mark_executing(self, key: str):
        """Execution actually began under ``key`` — from here on, ANY
        outcome (success, deadline, cancel, device error) must be
        resolved, never abandoned: partial work may have been charged."""
        with self._lock:
            entry = self._entries.get(str(key)[:256])
            if entry is not None:
                entry.executions += 1

    def resolve(self, key: str, code: int, payload: dict):
        with self._lock:
            entry = self._entries.get(str(key)[:256])
            if entry is None or entry.state == DONE:
                return
            entry.code = int(code)
            entry.payload = dict(payload or {})
            entry.state = DONE
            entry.resolved_at = time.monotonic()
        entry.event.set()

    def abandon(self, key: str):
        """A pre-execution rejection: forget the key so a later retry
        gets a real attempt (waiters re-drive through begin())."""
        with self._lock:
            entry = self._entries.pop(str(key)[:256], None)
        if entry is not None:
            entry.event.set()

    # ----------------------------------------------------------- replay
    def await_outcome(self, entry: _Entry,
                      timeout_s: float = 30.0) -> Optional[Tuple[int, dict]]:
        """Wait for the entry's resolution (immediate when DONE) and
        count the replay. None = the original is still executing past
        the wait (caller answers retry-later) or the key was abandoned
        mid-wait (caller may re-begin)."""
        if not entry.event.wait(timeout=max(0.0, timeout_s)):
            return None
        if entry.state != DONE:
            return None                   # abandoned: key forgotten
        with self._lock:
            entry.replays += 1
        _replays_total().inc()
        _faults.record_event("idempotent_replay", key=entry.key,
                             code=entry.code)
        return entry.code, dict(entry.payload or {})

    # ---------------------------------------------------------- queries
    def snapshot(self) -> dict:
        """``/debug/fleet`` / ``fleet.json`` payload — per-key execution
        counts are the drill's duplicate-execution audit surface."""
        with self._lock:
            entries = {
                k: {"state": e.state, "code": e.code,
                    "executions": e.executions, "replays": e.replays,
                    "age_s": round(time.monotonic() - e.created, 3)}
                for k, e in self._entries.items()}
            untracked = self._untracked
        return {
            "enabled": idempotency_enabled(),
            "ttl_s": self._ttl_s(),
            "max_entries": self._cap(),
            "size": len(entries),
            "untracked": untracked,
            "replays": sum(e["replays"] for e in entries.values()),
            "duplicate_executions": sum(
                max(0, e["executions"] - 1) for e in entries.values()),
            "entries": entries,
        }


# ------------------------------------------------------ process wiring
_journal: Optional[ResultJournal] = None
_journal_lock = threading.Lock()


def global_journal() -> ResultJournal:
    global _journal
    if _journal is None:
        with _journal_lock:
            if _journal is None:
                _journal = ResultJournal()
    return _journal


def reset_global_journal() -> ResultJournal:
    global _journal
    with _journal_lock:
        _journal = ResultJournal()
    return _journal


def snapshot() -> dict:
    """Never constructs the journal: a process that saw no idempotency
    keys reports an empty table."""
    if _journal is None:
        return {"enabled": idempotency_enabled(), "size": 0,
                "untracked": 0, "replays": 0, "duplicate_executions": 0,
                "entries": {}}
    return global_journal().snapshot()
