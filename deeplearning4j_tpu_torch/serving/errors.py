"""Typed serving-control-plane errors.

The data plane speaks the resilience taxonomy (ShedError /
DeadlineExceeded / CircuitOpenError...); the rollout control plane used
to raise bare ``RuntimeError`` for lifecycle refusals, which graftlint's
typed-errors rule now forbids in ``serving/`` — callers (the front
door's admin routes, drills, operators' scripts) need to distinguish "a
rollout is already active" from a real failure.  Subclassing
``RuntimeError`` keeps every pre-existing ``except RuntimeError`` /
``pytest.raises(RuntimeError)`` caller working unchanged.

Dependency-free on purpose: both ``router`` (numpy) and
``shared_state`` (stdlib-only, multi-process) import it.
"""
from __future__ import annotations


class RolloutConflictError(RuntimeError):
    """A rollout lifecycle request was refused because of current state
    (one already active, rollouts disabled, candidate not live, lane
    has no primary) — retryable after the state changes; maps to HTTP
    409 on the front door."""


class StoreLockTimeout(RuntimeError):
    """The shared-store file lock could not be acquired within the
    bounded wait — a writer crashed or was paused (SIGSTOP) INSIDE its
    critical section.  Typed so the sync loop treats it like any other
    transient store failure (window counters merge back, the next beat
    retries) instead of the whole fleet wedging forever on ``flock``."""
