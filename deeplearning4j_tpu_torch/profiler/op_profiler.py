"""Eager op profiler and NaN/Inf panic modes: counterpart of
``deeplearning4j_tpu/profiler/op_profiler.py`` (ref:
``org.nd4j.linalg.profiler.{OpProfiler,ProfilerConfig}``, NAN_PANIC /
INF_PANIC).

It instruments the op registry's ``exec_op`` (``ops/registry.py``), the
dispatch every op of a SameDiff graph's eager walk goes through, so it
times and checks each graph op by name. Timings publish into the port's
metrics registry as the ``dl4j_eager_op_seconds{op=...}`` histogram;
:class:`OpStats` is a view over that series (``reset()`` re-bases the
views, the registry stays cumulative).

An op on the card is timed by CUDA events recorded around it on the
current stream, read after the end event completes (the op's device
time; each timed op waits for the card, as the reference blocks on each
result); an op on the CPU by the host clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.observability import (global_registry,
                                                    on_registry_reset)
from deeplearning4j_tpu_torch.observability.registry import Histogram
from deeplearning4j_tpu_torch.ops import registry as _registry


@dataclasses.dataclass
class ProfilerConfig:
    """ref: ProfilerConfig builder flags."""
    op_timing: bool = False          # aggregate time per op name
    check_for_nan: bool = False      # NAN_PANIC: raise on a NaN output
    check_for_inf: bool = False      # INF_PANIC: raise on an Inf output
    verbose: bool = False            # print each eager op

    def apply(self):
        """The reference also flips ``jax_debug_nans`` for jitted code;
        every op of the port runs through ``exec_op``, so there is no
        other knob to set."""
        return self


class OpStats:
    """Windowed view over one op's registry series (re-based by reset)."""

    __slots__ = ("_hist", "_n0", "_s0")

    def __init__(self, hist_child):
        self._hist = hist_child
        self._n0 = 0
        self._s0 = 0.0

    def _rebase(self):
        self._n0 = self._hist.count
        self._s0 = self._hist.sum

    @property
    def invocations(self) -> int:
        return self._hist.count - self._n0

    @property
    def total_seconds(self) -> float:
        return self._hist.sum - self._s0

    @property
    def average_ms(self) -> float:
        return (self.total_seconds / self.invocations * 1e3
                if self.invocations else 0.0)


class _StatsView(dict):
    """``profiler.stats[name]``: lazily binds a view to the op's series."""

    def __init__(self, profiler: "OpProfiler"):
        super().__init__()
        self._profiler = profiler

    def __missing__(self, name: str) -> OpStats:
        st = OpStats(self._profiler._hist.labels(op=name))
        self[name] = st
        return st


def _leaves(out):
    return out if isinstance(out, (tuple, list)) else [out]


class OpProfiler:
    """Process-wide profiler over the registry's ``exec_op`` (ref:
    ``OpProfiler#getInstance``)."""

    _instance: Optional["OpProfiler"] = None

    def __init__(self):
        self.config = ProfilerConfig()
        self._bind()
        self._installed = False
        self._orig_exec = None

    def _bind(self):
        self._hist = global_registry().histogram(
            "dl4j_eager_op_seconds",
            "per-op time on the eager exec_op dispatch path "
            "(OpProfiler op_timing mode)", label_names=("op",))
        if not self._hist._enabled:
            # the metrics kill switch silences the export, not this tool
            # the caller opted into: keep a private series
            self._hist = Histogram("dl4j_eager_op_seconds",
                                   label_names=("op",), _enabled=True)
        self.stats: Dict[str, OpStats] = _StatsView(self)

    @classmethod
    def get_instance(cls) -> "OpProfiler":
        if cls._instance is None:
            cls._instance = OpProfiler()
        return cls._instance

    getInstance = get_instance

    # ----------------------------------------------------------- lifecycle
    def set_config(self, config: ProfilerConfig):
        self.config = config
        config.apply()
        if (config.op_timing or config.check_for_nan or config.check_for_inf
                or config.verbose):
            self._install()
        else:
            self._uninstall()
        return self

    setConfig = set_config

    def _install(self):
        if self._installed:
            return
        self._orig_exec = _registry.exec_op
        profiler = self

        def profiled_exec(name, *args, **attrs):
            cfg = profiler.config
            if not cfg.op_timing:
                out = profiler._orig_exec(name, *args, **attrs)
            elif any(isinstance(a, torch.Tensor) and a.is_cuda
                     for a in args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = profiler._orig_exec(name, *args, **attrs)
                end.record()
                end.synchronize()
                profiler.stats[name]._hist.observe(
                    start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                out = profiler._orig_exec(name, *args, **attrs)
                profiler.stats[name]._hist.observe(time.perf_counter() - t0)
            if cfg.verbose:
                print(f"[op] {name}")
            if cfg.check_for_nan or cfg.check_for_inf:
                profiler._panic_check(name, out)
            return out

        _registry.exec_op = profiled_exec
        self._installed = True

    def _uninstall(self):
        if not self._installed:
            return
        _registry.exec_op = self._orig_exec
        self._installed = False

    def _panic_check(self, name, out):
        for leaf in _leaves(out):
            if not isinstance(leaf, torch.Tensor) or leaf.is_meta \
                    or not leaf.is_floating_point():
                continue
            if self.config.check_for_nan and bool(torch.isnan(leaf).any()):
                raise FloatingPointError(
                    f"NAN_PANIC: op {name!r} produced NaN")
            if self.config.check_for_inf and bool(torch.isinf(leaf).any()):
                raise FloatingPointError(
                    f"INF_PANIC: op {name!r} produced Inf")

    # ------------------------------------------------------------- reports
    def reset(self):
        """Zero the report window (registry series stay cumulative)."""
        for st in self.stats.values():
            st._rebase()

    def print_results(self) -> str:
        lines = [f"{'op':<28}{'calls':>8}{'total ms':>12}{'avg ms':>10}"]
        for name, st in sorted(self.stats.items(),
                               key=lambda kv: -kv[1].total_seconds):
            if not st.invocations:
                continue
            lines.append(f"{name:<28}{st.invocations:>8}"
                         f"{st.total_seconds * 1e3:>12.2f}"
                         f"{st.average_ms:>10.3f}")
        out = "\n".join(lines)
        print(out)
        return out

    printResults = print_results


@on_registry_reset
def _rebind_profiler():
    if OpProfiler._instance is not None:
        OpProfiler._instance._bind()
