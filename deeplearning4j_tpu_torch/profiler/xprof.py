"""Device-level profiling bridge over ``torch.profiler``.

Counterpart of ``deeplearning4j_tpu/profiler/xprof.py``, which wraps
``jax.profiler`` (XPlane traces for XProf/TensorBoard) behind the
start/stop surface the reference exposes through
``Nd4j.getExecutioner().setProfilingConfig``. Here the same surface drives
``torch.profiler``: on the card it records CUDA activity (each kernel's
device time, through CUPTI) beside the host's ops, on the CPU (only when
asked, ``device="cpu"``) the host's ops alone. Every thread's ops are
recorded where this PyTorch can (``profile_all_threads``), so serving
threads show in a capture started from another thread; the card's kernels
are recorded process-wide either way. :meth:`DeviceProfiler.stop` writes
the trace as Chrome-trace JSON (``trace.json``, opens in Perfetto) under
``log_dir`` and keeps the profile for :attr:`DeviceProfiler.profile`.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch

from deeplearning4j_tpu_torch._device import resolve_device

#: the trace file :meth:`DeviceProfiler.stop` writes in ``log_dir``
TRACE_FILE = "trace.json"


def _default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "dl4j_tpu_profile")


def _all_threads_config():
    """``profile_all_threads`` where this PyTorch has it, else None (the
    profiling thread's host ops only)."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


class DeviceProfiler:
    """ref-analog surface: start/stop + annotate (OpProfiler's scoped
    sections, but for the device timeline). ``device`` ``None`` means the
    card."""

    def __init__(self, log_dir: Optional[str] = None, device=None):
        self.log_dir = log_dir or _default_log_dir()
        self.device = resolve_device(device)
        self.profile = None            # the last stopped torch.profiler run
        self._prof = None

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def start(self):
        if self._prof is not None:
            return self
        os.makedirs(self.log_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        kw = {}
        cfg = _all_threads_config()
        if cfg is not None:
            kw["experimental_config"] = cfg
        prof = torch.profiler.profile(activities=acts, **kw)
        prof.start()
        self._prof = prof
        return self

    def stop(self) -> str:
        prof, self._prof = self._prof, None
        if prof is not None:
            if self.device.type == "cuda":
                # every kernel launched so far lands in the trace
                torch.cuda.synchronize(self.device)
            prof.stop()
            prof.export_chrome_trace(os.path.join(self.log_dir, TRACE_FILE))
            self.profile = prof
        return self.log_dir

    @contextlib.contextmanager
    def trace(self, name: Optional[str] = None):
        """Scoped trace: ``with prof.trace("step"): step(...)``."""
        started = self._prof is None
        if started:
            self.start()
        try:
            with torch.profiler.record_function(name or "section"):
                yield self
        finally:
            if started:
                self.stop()

    @staticmethod
    def annotate(name: str):
        """Standalone annotation context (a named range on the timeline)."""
        return torch.profiler.record_function(name)


def profile_step(fn, *args, log_dir: Optional[str] = None, iters: int = 3,
                 device=None):
    """One-shot helper: trace ``iters`` calls of a step on ``device``
    (``None`` = the card) after one call outside the trace; returns
    (last_output, trace_dir, wall_seconds_per_iter)."""
    prof = DeviceProfiler(log_dir, device=device)
    sync = (torch.cuda.synchronize if prof.device.type == "cuda"
            else (lambda *a: None))
    out = fn(*args)                      # first-call costs outside
    sync(prof.device)
    prof.start()
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        sync(prof.device)
        wall = (time.perf_counter() - t0) / iters
    finally:
        trace_dir = prof.stop()          # never leave the profiler running
    return out, trace_dir, wall
