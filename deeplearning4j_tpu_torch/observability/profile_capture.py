"""On-demand device profiling: drive ``profiler/xprof.py``'s
DeviceProfiler in a RUNNING process and keep a parsed top-K per-op
device-time table.

Counterpart of ``deeplearning4j_tpu/observability/profile_capture.py``:

    capture(steps=N)  — trace until N more work units (fit iterations +
                        serving device batches) complete, bounded by
                        ``timeout_s``
    snapshot()        — the retained parsed captures

(the reference's UI server serves both as ``GET /debug/profile``; the UI
server comes with ROADMAP queue 1 item 10). A capture is one
``torch.profiler`` trace, written as Chrome-trace JSON under the
postmortem directory (``profile-<pid>-<nonce>-<seq>/trace.json``) and
parsed into:

- ``top_ops``  — device time per kernel name (the CUDA kernels CUPTI
  timed on the card), aggregated and sorted; with no device events (a
  CPU capture) the host's ``aten`` ops are the fallback
- ``modules``  — time per ``record_function`` range (the nets'
  ``<Net>._train_step`` and ``<Net>._output_jit``, the counterpart of the
  reference's per-XLA-module executions)

The reference parses XPlane protos through TensorFlow; the record keys
are the same. Retention is capped like postmortem bundles: trace
directories beyond ``DL4J_TPU_POSTMORTEM_KEEP`` are evicted oldest-first
(trace files are multi-MB; the parsed tables are small and ride a
bounded ring). One capture runs at a time — the profiler is
process-global (:class:`CaptureBusy`). A capture profiles the card
unless the capture was built with ``device="cpu"``.

Kill switch: ``DL4J_TPU_PROFILE=0`` refuses captures.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observability.flight_recorder import (_keep_bundles,
                                                              postmortem_dir)
from deeplearning4j_tpu_torch.observability.registry import global_registry

#: retained parsed capture records (metadata + tables, small)
_RING_CAPACITY = 16

#: hard ceiling on one capture's wall time, whatever the caller asked for
_MAX_TIMEOUT_S = 60.0


class ProfileDisabled(RuntimeError):
    """DL4J_TPU_PROFILE=0 — captures are refused."""


class CaptureBusy(RuntimeError):
    """A capture is already running (the profiler is process-global)."""


def profile_enabled() -> bool:
    """Kill switch (read per call so tests can flip it)."""
    return os.environ.get("DL4J_TPU_PROFILE", "1") != "0"


def _work_units() -> int:
    """Completed work units the capture waits on: fit iterations + serving
    device batches — the same clocks the flight recorder's progress
    channels beat on."""
    from deeplearning4j_tpu_torch.observability.train_metrics import (
        total_iterations)
    n = total_iterations()
    inst = global_registry().get("dl4j_inference_batches_total")
    if inst is not None:
        n += int(sum(child.value for _, child in inst.series()))
    return n


# -------------------------------------------------------------- trace parse
def _trace_events(logdir: str) -> List[dict]:
    """The complete ("X") events of every Chrome-trace JSON in
    ``logdir``."""
    out = []
    for f in glob.glob(os.path.join(logdir, "**", "*.json"),
                       recursive=True):
        with open(f) as fh:
            doc = json.load(fh)
        evs = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        out.extend(e for e in evs
                   if isinstance(e, dict) and e.get("ph") == "X")
    return out


def _rows(agg: Dict[str, List[float]], key: str, top=None) -> List[dict]:
    rows = sorted(((k, v[0], v[1]) for k, v in agg.items()),
                  key=lambda r: -r[1])
    return [{key: k, "total_seconds": sec, "count": c}
            for k, sec, c in (rows if top is None else rows[:top])]


def parse_top_ops(logdir: str, top: int = 20) -> Dict[str, List[dict]]:
    """Aggregate per-kernel and per-range time out of a trace dir.

    Device kernels (``cat`` "kernel": durations CUPTI measured on the
    card) are authoritative; when there are none (a CPU capture), the
    host's ``cpu_op`` events are the fallback. ``modules`` sums the
    ``record_function`` ranges (``user_annotation``)."""
    op_agg: Dict[str, List[float]] = {}
    mod_agg: Dict[str, List[float]] = {}
    host_agg: Dict[str, List[float]] = {}
    for ev in _trace_events(logdir):
        cat, dur = ev.get("cat"), float(ev.get("dur", 0.0)) / 1e6
        agg = {"kernel": op_agg, "user_annotation": mod_agg,
               "cpu_op": host_agg}.get(cat)
        if agg is None or dur <= 0:
            continue
        a = agg.setdefault(str(ev.get("name")), [0.0, 0])
        a[0] += dur
        a[1] += 1
    return {
        "top_ops": _rows(op_agg or host_agg, "op", top),
        "modules": _rows(mod_agg, "module"),
        "source": "device" if op_agg else "host",
    }


class ProfileCapture:
    """Bounded ring of parsed captures + the capture mutex. One
    process-wide instance via :func:`global_profile_capture`."""

    def __init__(self, out_dir: Optional[str] = None, device=None):
        self._out_dir = out_dir
        self.device = device           # None = the card, at capture time
        self._busy = threading.Lock()
        self._ring_lock = threading.Lock()
        self._ring: deque = deque(maxlen=_RING_CAPACITY)
        self._seq = 0
        self._instance = os.urandom(3).hex()

    def _base_dir(self) -> str:
        return self._out_dir or postmortem_dir()

    def capture(self, steps: int = 1, timeout_s: float = 5.0,
                top: int = 20) -> dict:
        """Profile until ``steps`` more work units complete (or
        ``timeout_s``), parse, retain, return the record."""
        if not profile_enabled():
            raise ProfileDisabled("device profiling disabled "
                                  "(DL4J_TPU_PROFILE=0)")
        if not self._busy.acquire(blocking=False):
            raise CaptureBusy("a profile capture is already running")
        try:
            from deeplearning4j_tpu_torch.profiler.xprof import DeviceProfiler

            with self._ring_lock:
                self._seq += 1
                seq = self._seq
            trace_dir = os.path.join(
                self._base_dir(),
                f"profile-{os.getpid()}-{self._instance}-{seq:03d}")
            timeout_s = min(max(0.1, float(timeout_s)), _MAX_TIMEOUT_S)
            steps = max(1, int(steps))
            prof = DeviceProfiler(trace_dir, device=self.device)
            prof.start()
            # counted from the moment the profiler records: its first
            # start in a process takes seconds, and units finished during
            # it are not in the trace
            base = _work_units()
            t0 = time.monotonic()
            try:
                while (time.monotonic() - t0 < timeout_s
                       and _work_units() - base < steps):
                    time.sleep(0.02)
            finally:
                prof.stop()
            record = {
                "id": f"{os.getpid()}-{self._instance}-{seq:03d}",
                "trace_dir": trace_dir,
                "unix_ts": time.time(),
                "duration_seconds": time.monotonic() - t0,
                "steps_requested": steps,
                "steps_seen": _work_units() - base,
            }
            try:
                record.update(parse_top_ops(trace_dir, top=top))
            except Exception as e:      # unreadable trace: the trace dir
                record["parse_error"] = repr(e)   # still exists on disk
            self._prune()
            with self._ring_lock:
                self._ring.append(record)
            return record
        finally:
            self._busy.release()

    def _prune(self):
        """Evict trace dirs beyond the postmortem retention cap (the same
        knob bundles honor — trace files are multi-MB)."""
        keep = _keep_bundles()
        base = self._base_dir()
        try:
            entries = [os.path.join(base, e) for e in os.listdir(base)
                       if e.startswith("profile-")
                       and os.path.isdir(os.path.join(base, e))]
            entries.sort(key=lambda p: (os.path.getmtime(p), p))
            # the just-written trace dir is in the listing (newest) — the
            # same oldest-first eviction bundles use
            for old in entries[:-keep]:
                shutil.rmtree(old, ignore_errors=True)
        except OSError:
            pass

    def snapshot(self) -> dict:
        with self._ring_lock:
            captures = [dict(r) for r in self._ring]
        return {"enabled": profile_enabled(), "captures": captures}

    def clear(self):
        with self._ring_lock:
            self._ring.clear()


_global_capture: Optional[ProfileCapture] = None
_capture_lock = threading.Lock()


def global_profile_capture() -> ProfileCapture:
    """THE process-wide capture ring (the reference's UI server serves it
    as ``/debug/profile``)."""
    global _global_capture
    if _global_capture is None:
        with _capture_lock:
            if _global_capture is None:
                _global_capture = ProfileCapture()
    return _global_capture


def reset_global_profile_capture(**kw) -> ProfileCapture:
    global _global_capture
    with _capture_lock:
        _global_capture = ProfileCapture(**kw)
    return _global_capture
