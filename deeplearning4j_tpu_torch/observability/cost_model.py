"""Cost-model accounting: per-entry-point FLOPs/bytes, live MFU,
roofline grading.

Counterpart of ``deeplearning4j_tpu/observability/cost_model.py``. The
reference AOT re-lowers a jitted entry point after each fresh compile and
reads XLA's ``cost_analysis()``. The port has no lowering to read: the
caller's thunk returns the step's own ``(flops, bytes)``, counted
analytically from the model config and the step's shapes (the engine's
``account_decode`` / ``account_spec`` / prefill accounting: the matmul
FLOPs of the projections, MLP and head, attention over the live context,
and the weights, KV pages and logits read and written). The count runs
once per new step signature, keyed to ``compile_watch``'s per-fn count,
so steady-state cost is one dict lookup and an int compare.

- **Live MFU**: callers feed measured step durations into a rolling
  window; ``dl4j_mfu{fn}`` = FLOPs / (rolling-mean seconds × peak
  FLOP/s).
- **Roofline verdict**: arithmetic intensity (FLOPs / bytes) against the
  ridge point of a per-platform peak-FLOPs / HBM-bandwidth table —
  ``compute_bound`` or ``memory_bound``. The ``gpu`` row is an NVIDIA
  H100 SXM5's published dense bf16 rate and HBM3 bandwidth (989 TFLOP/s,
  3.35 TB/s). Overridable via ``DL4J_TPU_PEAK_FLOPS`` (FLOP/s) and
  ``DL4J_TPU_HBM_GBPS`` (GB/s) so CPU tests are deterministic.
- **Regression reference**: a slow EWMA of the live MFU is each fn's own
  rolling baseline; :class:`~.slo.PerfRegressionRule` grades sustained
  drops on ``/health`` + ``/alerts``. The baseline freezes while a
  violation is in progress so a real regression cannot normalize itself
  away.

Surfaces: ``perf.json`` in flight-recorder bundles, :meth:`snapshot`.

Serving buckets (:func:`maybe_account_bucket`) count a DL4J network's
forward the same way: its products' FLOPs at the bucket's rows, from the
layers' ``InputType`` chain (``nn/_network.py`` ``layer_flops``).

Known approximation: the analytic count holds the matmuls, the attention
products and the bytes that must move, and leaves out elementwise work
(LayerNorm, GELU, softmax, sampling, BatchNormalization, pooling), which
XLA's count includes. Serving MFU is a lower bound: a bucket's duration
runs from dispatch to completion and includes pipeline queueing.

Kill switch: ``DL4J_TPU_COST_MODEL=0`` (accounting + MFU timing no-op)
under the ``DL4J_TPU_METRICS=0`` master.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.observability import compile_watch as _cw
from deeplearning4j_tpu_torch.observability.registry import (global_registry,
                                                             metrics_enabled,
                                                             on_registry_reset)

#: step-duration samples the live MFU averages over — a window-spanning
#: mean, so a step whose timing is dispatch-only and the sync step that
#: absorbs its device time read as their true per-step time together
_TIMES_MAX = 64

#: slow EWMA weight for the per-fn MFU baseline the regression rule
#: grades against (half-life ~70 samples — a sustained drop is caught
#: long before the reference erodes)
_BASELINE_ALPHA = 0.01

#: fractional MFU drop below its rolling baseline that counts as a
#: regression. ONE constant on purpose: slo.PerfRegressionRule derives
#: its default ``drop`` from it, and the baseline EWMA freezes at the
#: same margin — a drop the rule would flag can never erode its own
#: reference. A custom rule with a smaller drop loses that guarantee.
PERF_REGRESSION_DROP = 0.3

#: per-device peak dense FLOP/s and HBM bandwidth (bytes/s) by
#: platform. ``gpu``: one NVIDIA H100 SXM5 (NVIDIA's published dense bf16
#: rate and HBM3 bandwidth). CPU numbers are order-of-magnitude
#: placeholders — tests pin the table via the env knobs for determinism.
_PEAK_DEFAULTS = {
    "gpu": (989e12, 3.35e12),    # H100 SXM5 bf16, HBM3
    "cpu": (1e11, 5e10),
}


def cost_model_enabled() -> bool:
    """Kill switch (read per call so tests can flip it)."""
    return (metrics_enabled()
            and os.environ.get("DL4J_TPU_COST_MODEL", "1") != "0")


_platform_cache: Optional[str] = None


def note_device(device) -> None:
    """Set the platform from the device an accounted step's tensors live
    on (``cuda`` → ``gpu``, else ``cpu``). The engine calls this with its
    own device when it accounts a step."""
    global _platform_cache
    _platform_cache = ("gpu" if getattr(device, "type", str(device))
                       .startswith("cuda") else "cpu")


def _platform() -> str:
    return _platform_cache or "cpu"


def peak_flops() -> float:
    """Per-chip peak FLOP/s: ``DL4J_TPU_PEAK_FLOPS`` else platform table."""
    env = os.environ.get("DL4J_TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    return _PEAK_DEFAULTS.get(_platform(), _PEAK_DEFAULTS["cpu"])[0]


def hbm_bytes_per_second() -> float:
    """Per-chip HBM bandwidth: ``DL4J_TPU_HBM_GBPS`` (GB/s) else table."""
    env = os.environ.get("DL4J_TPU_HBM_GBPS")
    if env:
        try:
            return float(env) * 1e9
        except ValueError:
            pass
    return _PEAK_DEFAULTS.get(_platform(), _PEAK_DEFAULTS["cpu"])[1]


def ridge_intensity() -> float:
    """FLOPs/byte at which the roofline's compute and memory ceilings
    meet — programs above it can saturate the MXU, below it HBM rules."""
    return peak_flops() / max(hbm_bytes_per_second(), 1.0)


def _publish_cost(fn: str, flops: float, byts: float):
    """The ONE registration site for the per-fn cost gauges (account and
    record_cost must agree on name + help text)."""
    reg = global_registry()
    reg.gauge("dl4j_cost_flops",
              "cost-model FLOPs per execution of the engine "
              "entry point (analytic count from its shapes)",
              label_names=("fn",)).labels(fn=fn).set(float(flops))
    reg.gauge("dl4j_cost_bytes",
              "cost-model bytes accessed per execution of the "
              "engine entry point (analytic count from its shapes)",
              label_names=("fn",)).labels(fn=fn).set(float(byts))


class _Entry:
    """Per-fn accounting state (no lock of its own — CostModel's lock)."""

    __slots__ = ("flops", "bytes", "signature", "source", "error",
                 "analyzed_count", "analyze_calls", "times", "count",
                 "mfu", "bw_util", "baseline_mfu", "g_mfu")

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.signature = None
        self.source = None            # "analytic" once accounted
        self.error = None
        self.analyzed_count = -1      # compile-watch count last analyzed at
        self.analyze_calls = 0        # how often cost analysis actually ran
        self.times = deque(maxlen=_TIMES_MAX)
        self.count = 0                # lifetime duration samples
        self.mfu = None               # rolling-window MFU
        self.bw_util = None           # rolling-window HBM-bandwidth util
        self.baseline_mfu = None      # slow EWMA (regression reference)
        self.g_mfu = None             # cached gauge child


class CostModel:
    """Per-fn cost/time/MFU store. One process-wide instance via
    :func:`global_cost_model`; tests may construct their own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._collectives: Dict[str, Dict[str, float]] = {}
        self._compression: Dict[str, Dict[str, object]] = {}
        self._scales: Dict[str, int] = {}     # fn -> devices executing it

    # -------------------------------------------------------- accounting
    def has_entry(self, fn: str) -> bool:
        with self._lock:
            return fn in self._entries

    def needs_account(self, fn: str, probe_fn: Optional[str] = None) -> bool:
        """True when ``fn`` has never been analyzed, or compile_watch has
        counted a new (re)trace of ``probe_fn`` since the last analysis —
        the 'fires exactly once per compile' contract."""
        count = _cw.global_compile_watch().count_for(probe_fn or fn)
        with self._lock:
            e = self._entries.get(fn)
            return e is None or e.analyzed_count != count

    def account(self, fn: str, cost_thunk: Callable[[], Tuple[float, float]],
                probe_fn: Optional[str] = None,
                signature: Optional[str] = None) -> Optional[dict]:
        """Run ``cost_thunk()``, which returns the step's analytic
        ``(flops, bytes)`` at the signature that just ran, and record it.
        Failures are recorded on the entry, never raised into the step."""
        count = _cw.global_compile_watch().count_for(probe_fn or fn)
        with self._lock:
            e = self._entries.setdefault(fn, _Entry())
            e.analyzed_count = count
            e.analyze_calls += 1
        try:
            flops, byts = (float(v) for v in cost_thunk())
            with self._lock:
                # re-fetch: a concurrent clear()/invalidate() may have
                # dropped the entry between the two locked sections
                e = self._entries.setdefault(fn, _Entry())
                e.flops, e.bytes = flops, byts
                e.signature = signature
                e.source = "analytic"
                e.error = None
            _publish_cost(fn, flops, byts)
            return {"flops": flops, "bytes": byts}
        except Exception as err:          # accounting is best-effort telemetry
            with self._lock:
                e = self._entries.get(fn)
                if e is not None:     # don't resurrect a concurrent clear()
                    e.error = repr(err)
            return None

    def record_cost(self, fn: str, flops: float, bytes_accessed: float = 0.0,
                    signature: Optional[str] = None):
        """Record externally computed costs (a bench's own count of a
        step it times)."""
        if not cost_model_enabled():      # same contract as every hook:
            return                        # the kill switch keeps it empty
        with self._lock:
            e = self._entries.setdefault(fn, _Entry())
            e.flops = float(flops)
            e.bytes = float(bytes_accessed or 0.0)
            e.signature = signature
            e.source = "external"
            e.analyze_calls += 1
        _publish_cost(fn, flops, bytes_accessed or 0.0)

    def invalidate(self, fn: str):
        """Drop one entry so the next step re-accounts it."""
        with self._lock:
            self._entries.pop(fn, None)

    def note_collectives(self, fn: str, bytes_by_op: Dict[str, float]):
        """Attach the analytic per-step collective traffic expectation to
        an entry (ShardedTrainer's allreduce / reduce-scatter+all-gather
        payload) — served next to the measured cost on /debug/perf."""
        with self._lock:
            self._collectives[fn] = {k: float(v)
                                     for k, v in bytes_by_op.items()}

    def note_compression(self, fn: str, info: Dict[str, object]):
        """Attach (merge) gradient-compression facts to an entry — the
        ThresholdAlgorithm in force, the analytic wire payload vs dense
        bytes, and the last synced encoded fraction — served as
        ``grad_compression`` next to the collective bytes on /debug/perf
        and in perf.json bundles."""
        with self._lock:
            self._compression.setdefault(fn, {}).update(info)

    def set_scale(self, fn: str, devices: int):
        """Sharded entries report GLOBAL program FLOPs — their roofline
        peak is ``devices`` chips, not one."""
        with self._lock:
            self._scales[fn] = max(1, int(devices))

    # ------------------------------------------------------------ timing
    def observe_time(self, fn: str, seconds: float):
        """Feed one measured execution duration; recomputes the rolling
        MFU/BW utilization and updates the regression baseline."""
        if seconds <= 0:
            return
        peak = peak_flops()
        hbm = hbm_bytes_per_second()
        with self._lock:
            e = self._entries.setdefault(fn, _Entry())
            e.times.append(float(seconds))
            e.count += 1
            if not e.flops:
                return
            scale = self._scales.get(fn, 1)
            mean_s = sum(e.times) / len(e.times)
            e.mfu = e.flops / (mean_s * peak * scale)
            e.bw_util = e.bytes / (mean_s * hbm * scale) if e.bytes else None
            # regression reference: slow EWMA, FROZEN at the SAME margin
            # PerfRegressionRule grades at — a drop the rule would flag
            # must not drag its own baseline down and self-heal the alert
            if e.baseline_mfu is None:
                e.baseline_mfu = e.mfu
            elif e.mfu >= e.baseline_mfu * (1.0 - PERF_REGRESSION_DROP):
                e.baseline_mfu += _BASELINE_ALPHA * (e.mfu - e.baseline_mfu)
            mfu, gauge = e.mfu, e.g_mfu
        if gauge is None:
            gauge = global_registry().gauge(
                "dl4j_mfu",
                "live model-FLOPs utilisation of the jitted entry point: "
                "cost-model FLOPs / (rolling-mean step seconds x peak "
                "FLOP/s from the DL4J_TPU_PEAK_FLOPS-overridable table)",
                label_names=("fn",)).labels(fn=fn)
            with self._lock:
                ent = self._entries.get(fn)   # clear() may have raced us
                if ent is not None:
                    ent.g_mfu = gauge
        gauge.set(mfu)

    def flops_for(self, fn: str) -> float:
        """Accounted FLOPs of one entry (0.0 when never analyzed) — the
        cheap read the per-tenant cost attribution uses per batch/step
        (one lock + dict lookup, no snapshot)."""
        with self._lock:
            e = self._entries.get(fn)
            return e.flops if e is not None else 0.0

    # ----------------------------------------------------------- queries
    def regression_view(self) -> List[Tuple[str, float, float, int]]:
        """(fn, rolling_mfu, baseline_mfu, samples) for every entry with
        both — the PerfRegressionRule's read surface."""
        with self._lock:
            return [(fn, e.mfu, e.baseline_mfu, e.count)
                    for fn, e in self._entries.items()
                    if e.mfu is not None and e.baseline_mfu]

    def entry(self, fn: str) -> Optional[dict]:
        snap = self.snapshot()
        return snap["fns"].get(fn)

    def snapshot(self) -> dict:
        """The /debug/perf + perf.json payload."""
        peak = peak_flops()
        hbm = hbm_bytes_per_second()
        ridge = peak / max(hbm, 1.0)
        fns = {}
        with self._lock:
            # times MUST be copied under the lock: observe_time appends
            # concurrently and list() over a mutating deque raises
            items = [(fn, e, list(e.times))
                     for fn, e in self._entries.items()]
            collectives = {k: dict(v) for k, v in self._collectives.items()}
            compression = {k: dict(v) for k, v in self._compression.items()}
            scales = dict(self._scales)
        for fn, e, times in items:
            mean_s = (sum(times) / len(times)) if times else None
            intensity = (e.flops / e.bytes) if e.bytes else None
            rec = {
                "flops": e.flops or None,
                "bytes_accessed": e.bytes or None,
                "arithmetic_intensity": intensity,
                "signature": e.signature,
                "source": e.source,
                "analyze_calls": e.analyze_calls,
                "error": e.error,
                "samples": e.count,
                "recent_seconds_mean": mean_s,
                "mfu": e.mfu,
                "bw_utilization": e.bw_util,
                "baseline_mfu": e.baseline_mfu,
                "mfu_vs_baseline": (e.mfu / e.baseline_mfu
                                    if e.mfu is not None and e.baseline_mfu
                                    else None),
                "roofline_verdict": (
                    None if intensity is None
                    else "compute_bound" if intensity >= ridge
                    else "memory_bound"),
                "devices": scales.get(fn, 1),
            }
            if fn in collectives:
                rec["collective_bytes_per_step"] = collectives[fn]
            if fn in compression:
                rec["grad_compression"] = compression[fn]
            fns[fn] = rec
        return {
            "enabled": cost_model_enabled(),
            "platform": _platform(),
            "peak_flops": peak,
            "hbm_bytes_per_second": hbm,
            "ridge_intensity": ridge,
            "fns": fns,
        }

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._collectives.clear()
            self._compression.clear()
            self._scales.clear()


# --------------------------------------------------------- process wiring
_global_model: Optional[CostModel] = None
_model_lock = threading.Lock()


def global_cost_model() -> CostModel:
    """THE process-wide cost model every built-in hook records into."""
    global _global_model
    if _global_model is None:
        with _model_lock:
            if _global_model is None:
                _global_model = CostModel()
    return _global_model


def reset_global_cost_model() -> CostModel:
    global _global_model
    with _model_lock:
        _global_model = CostModel()
    return _global_model


# ------------------------------------------------------------ hook helpers
def on_step(probe_fn: str, fn: str, seconds: float,
            cost_thunk: Callable[[], Tuple[float, float]]):
    """The one-line step hook: observe the step duration and (only when
    compile_watch counted a new signature of ``probe_fn``) re-account
    the entry point's cost. ``fn`` may differ from ``probe_fn`` when a
    wrapper renames the entry."""
    if not cost_model_enabled():
        return
    cm = global_cost_model()
    if cm.needs_account(fn, probe_fn):
        cm.account(fn, cost_thunk, probe_fn=probe_fn)
    cm.observe_time(fn, seconds)


def bucket_fn(model, target: int) -> str:
    """Per-serving-bucket entry name, e.g.
    ``MultiLayerNetwork._output_jit[b8]`` — bounded cardinality (the
    bucket set is log2(batch_limit)+1 per model kind). The name keeps the
    reference's ``_output_jit``: the port's serving probe notes its first
    runs under that name (``nn/_network.py``)."""
    return f"{type(model).__name__}._output_jit[b{int(target)}]"


def maybe_account_bucket(model, target: int, x):
    """Account one serving shape bucket (called after the batch that ran
    it). Keyed to the model's ``_output_jit`` first-run count: a bucket
    run at a new signature — or a different same-class model running its
    first bucket — refreshes every bucket's FLOPs on next use. The thunk
    counts analytically (``output_cost``: the products' FLOPs at
    ``target`` rows, the params and ``x`` read once) and runs nothing on
    the card. Two same-class models serving the SAME bucket shape share
    one entry (the last to account wins), as in the reference. A model
    without ``output_cost`` (a caller's wrapper) is not accounted."""
    if not cost_model_enabled():
        return
    cost = getattr(model, "output_cost", None)
    if cost is None:
        return
    fn = bucket_fn(model, target)
    probe = f"{type(model).__name__}._output_jit"
    cm = global_cost_model()
    if not cm.needs_account(fn, probe_fn=probe):
        return
    note_device(getattr(model, "device", "cpu"))
    cm.account(fn, lambda: cost(int(target), x), probe_fn=probe)


def observe_bucket_time(model, target: int, seconds: float):
    """Feed one device-batch dispatch→complete duration into the bucket's
    MFU (under multi-in-flight dispatch this includes queueing, so
    serving MFU is a lower bound — see module doc)."""
    if not cost_model_enabled():
        return
    global_cost_model().observe_time(bucket_fn(model, target), seconds)


@on_registry_reset
def _clear_model():
    # gauge handles and compile-count anchors die with the registry
    if _global_model is not None:
        _global_model.clear()
