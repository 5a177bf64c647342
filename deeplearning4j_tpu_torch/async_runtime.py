"""Async hot-path configuration: the knobs the fit loops and the serving
pipeline read.

Counterpart of ``deeplearning4j_tpu/async_runtime.py``:

- ``DevicePrefetchIterator`` (``data/iterators.py``) copies batch *k+1* to
  the card while step *k* runs;
- the fit loops (``nn/multilayer.py``, ``nn/graph.py``) keep the loss on
  the card and fetch it every ``score_sync_every()`` steps, so the host
  runs ahead of the device instead of waiting on each step;
- ``ParallelInference`` (``parallel/inference.py``) runs a batcher →
  dispatcher → completer pipeline with up to ``inflight_limit()`` batches
  on the card (each staged in pinned memory, copied without blocking, its
  end marked by a CUDA event) and pads to power-of-two buckets instead of
  ``batch_limit``.

Kill switch: ``DL4J_TPU_ASYNC=0`` makes all three synchronous (one batch
in flight, padded to ``batch_limit``). Values are read per call, so tests
can flip them with ``monkeypatch.setenv``.

============================  =======  ==========================================
``DL4J_TPU_ASYNC``            ``1``    master switch; ``0`` = fully synchronous
``DL4J_TPU_PREFETCH_DEPTH``   ``2``    device batches buffered ahead of the step
``DL4J_TPU_SCORE_EVERY``      ``16``   steps between loss materializations
``DL4J_TPU_INFLIGHT``         ``2``    serving batches dispatched but uncompleted
============================  =======  ==========================================

The XLA compile cache has no counterpart.
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


def inflight_limit() -> int:
    """Serving pipeline depth: device batches dispatched but not yet
    completed (dispatch batch k+1 while k's results copy back)."""
    return _int_env("DL4J_TPU_INFLIGHT", 2)


def default_buckets(batch_limit: int) -> tuple:
    """Power-of-two padding buckets up to and including ``batch_limit``.

    Each bucket is one batch shape the card runs (its own cuDNN algorithm
    choices, paid once by the deploy's warm-up); padding to the next
    bucket instead of to ``batch_limit`` trades a small bounded set of
    shapes (log2(limit) + 1) for far less padded work at partial
    occupancy.
    """
    out, b = [], 1
    while b < batch_limit:
        out.append(b)
        b <<= 1
    out.append(batch_limit)
    return tuple(sorted(set(out)))


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
        "inflight_limit": inflight_limit(),
        "compile_watch_enabled": compile_watch_enabled(),
        "numerics_enabled": numerics_enabled(),
        "numerics_skip_on_nonfinite": skip_on_nonfinite(),
        "resilience_enabled": resilience_enabled(),
        "fault_spec": os.environ.get("DL4J_TPU_FAULTS", ""),
        "default_deadline_ms": default_deadline_ms(),
    }
