"""Typed resilience outcomes the port raises.

A copy of the error classes of ``deeplearning4j_tpu/resilience/policy.py``
that this slice needs; retry, deadline and circuit-breaker policies come
with the serving plane.
"""
from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base of the typed resilience outcomes."""


class ShedError(ResilienceError):
    pass


class CachePagesExhausted(ShedError):
    """The paged KV-cache pool ran out of free pages — a LOAD outcome
    (the pool admits by actual cached tokens, so a burst of long
    generations can outgrow it), shed typed at a decode step boundary
    or at admission. Retryable by the caller once resident pages drain;
    never an error-rate event (``ShedError`` subclass)."""
