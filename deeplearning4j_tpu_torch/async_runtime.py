"""Async hot-path configuration: the knobs the fit loops read.

Counterpart of ``deeplearning4j_tpu/async_runtime.py``, the knobs of its
training half:

- ``DevicePrefetchIterator`` (``data/iterators.py``) copies batch *k+1* to
  the card while step *k* runs;
- the fit loops (``nn/multilayer.py``, ``nn/graph.py``) keep the loss on
  the card and fetch it every ``score_sync_every()`` steps, so the host
  runs ahead of the device instead of waiting on each step.

Kill switch: ``DL4J_TPU_ASYNC=0`` makes both synchronous. Values are read
per call, so tests can flip them with ``monkeypatch.setenv``.

============================  =======  ==========================================
``DL4J_TPU_ASYNC``            ``1``    master switch; ``0`` = fully synchronous
``DL4J_TPU_PREFETCH_DEPTH``   ``2``    device batches buffered ahead of the step
``DL4J_TPU_SCORE_EVERY``      ``16``   steps between loss materializations
============================  =======  ==========================================

The serving knobs (``DL4J_TPU_INFLIGHT``, ``default_buckets``) wait with
``ParallelInference``; the XLA compile cache has no counterpart.
:func:`snapshot` gives every live value to the flight recorder's
``config.json``.
"""
from __future__ import annotations

import os


def async_enabled() -> bool:
    """The kill switch (read per call so tests can flip it)."""
    return os.environ.get("DL4J_TPU_ASYNC", "1") != "0"


def _int_env(name: str, default: int, floor: int = 1) -> int:
    try:
        return max(floor, int(os.environ.get(name, default)))
    except (TypeError, ValueError):
        return default


def prefetch_depth() -> int:
    """Device batches the prefetch thread keeps ready ahead of the step."""
    return _int_env("DL4J_TPU_PREFETCH_DEPTH", 2)


def score_sync_every() -> int:
    """Steps between blocking loss fetches in a deferred fit loop; the
    fetch always happens at epoch end."""
    return _int_env("DL4J_TPU_SCORE_EVERY", 16)


def snapshot() -> dict:
    """Every live knob value, with the observability and resilience
    switches that shape what a step computes."""
    from deeplearning4j_tpu_torch.observability.compile_watch import (
        compile_watch_enabled)
    from deeplearning4j_tpu_torch.observability.numerics import (
        numerics_enabled, skip_on_nonfinite)
    from deeplearning4j_tpu_torch.resilience.faults import resilience_enabled
    from deeplearning4j_tpu_torch.resilience.policy import (
        default_deadline_ms)
    return {
        "async_enabled": async_enabled(),
        "prefetch_depth": prefetch_depth(),
        "score_sync_every": score_sync_every(),
        "compile_watch_enabled": compile_watch_enabled(),
        "numerics_enabled": numerics_enabled(),
        "numerics_skip_on_nonfinite": skip_on_nonfinite(),
        "resilience_enabled": resilience_enabled(),
        "fault_spec": os.environ.get("DL4J_TPU_FAULTS", ""),
        "default_deadline_ms": default_deadline_ms(),
    }
