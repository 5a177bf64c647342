"""The shared request record of the port's serving loops.

Counterpart of the ``_Request`` of ``deeplearning4j_tpu/parallel/
inference.py``: the exactly-once resolution machinery (``claim()``) that
``GenerationPipeline``'s ``_GenRequest`` rides. ``ParallelInference``
itself, with its ``_ServingMetrics`` and ``InferenceMode``, is not ported
yet: it serves a DL4J network's ``.output``, which the port does not
have until ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import threading


class _Request:
    __slots__ = ("x", "event", "result", "error", "ctx", "t_enqueue_us",
                 "deadline", "tenant", "_claim_lock", "_claimed")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error = None
        # QoS tenant label (None when QoS is off — the request behaves
        # exactly as pre-tenant requests did)
        self.tenant = None
        # causal trace context captured at enqueue: the serve threads stamp
        # this request's queue_wait/bucket_pad/dispatch/device/complete
        # phases into ITS trace, so one trace_id follows the request across
        # the batcher→dispatcher→completer pipeline
        self.ctx = None
        self.t_enqueue_us = 0.0
        # optional Deadline: checked by the batcher before padding, the
        # dispatcher before an in-flight slot is taken, and the completer
        # before handing the slice back
        self.deadline = None
        # exactly-once resolution: every path that would set
        # result/error (completer, _fail, shed, the caller's deadline
        # walk-away) must win claim() first — two racing resolvers can
        # never both count a shed or overwrite each other's outcome
        self._claim_lock = threading.Lock()
        self._claimed = False

    def claim(self) -> bool:
        with self._claim_lock:
            if self._claimed:
                return False
            self._claimed = True
            return True
