"""Process-wide metrics registry — the measurement substrate every layer
publishes into (tentpole of the observability PR; design follows the
TensorFlow position that monitoring is core infrastructure, Abadi et al.
arXiv:1605.08695 §9, and the Prometheus data model).

Three instrument kinds, all label-aware and thread-safe:

- :class:`Counter`   — monotonically increasing float (events, bytes)
- :class:`Gauge`     — last-written value (queue depth, in-flight requests)
- :class:`Histogram` — fixed-bucket counts (Prometheus ``_bucket`` series)
  PLUS a bounded reservoir for quantile summaries (p50/p95/p99) — the
  fixed buckets serve scrapes cheaply, the reservoir serves in-process
  latency introspection exactly.

Kill switch: ``DL4J_TPU_METRICS=0`` turns every instrument into a no-op at
*creation* time — the hot-path cost degenerates to one attribute lookup and
one short-circuit branch, keeping instrumented-by-default overhead honest
(acceptance: <5% on the lenet step, benchmarks/obs_overhead.py).
"""
from __future__ import annotations

import bisect
import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def metrics_enabled() -> bool:
    """The documented kill switch (read per call so tests can flip it)."""
    return os.environ.get("DL4J_TPU_METRICS", "1") != "0"


def _validate_labels(names: Sequence[str]):
    for n in names:
        if not n or not all(c.isalnum() or c == "_" for c in n):
            raise ValueError(f"invalid label name {n!r}")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r'\"')
                     .replace("\n", r"\n"))
        for k, v in pairs)
    return "{" + body + "}"


class _Instrument:
    """Shared label-child bookkeeping. A child is the per-label-value
    series; the unlabeled instrument IS its own sole child."""

    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 label_names: Sequence[str] = (), _enabled: bool = True):
        self.name = name
        self.description = description
        self.label_names = tuple(label_names)
        _validate_labels(self.label_names)
        self._children: Dict[Tuple[str, ...], _Instrument] = {}
        self._lock = threading.Lock()
        self._enabled = _enabled

    def labels(self, *values, **kw):
        """Child instrument for one label-value combination (prometheus
        client idiom: ``counter.labels(op="add").inc()``)."""
        if kw:
            try:
                values = tuple(str(kw[n]) for n in self.label_names)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
        return child

    def _make_child(self):
        raise NotImplementedError

    def _series(self) -> List[Tuple[Tuple[str, ...], "_Instrument"]]:
        with self._lock:
            return list(self._children.items())

    def series(self) -> List[Tuple[Tuple[str, ...], "_Instrument"]]:
        """Live ``(label_values, child)`` pairs WITHOUT creating any — the
        unlabeled instrument is its own sole child. The public
        enumeration surface for renderers and SLO rules."""
        if self.label_names:
            return self._series()
        return [((), self)]


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name="", description="", label_names=(), _enabled=True):
        super().__init__(name, description, label_names, _enabled)
        self._value = 0.0

    def _make_child(self) -> "Counter":
        return Counter(_enabled=self._enabled)

    def inc(self, amount: float = 1.0):
        if not self._enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name="", description="", label_names=(), _enabled=True):
        super().__init__(name, description, label_names, _enabled)
        self._value = 0.0

    def _make_child(self) -> "Gauge":
        return Gauge(_enabled=self._enabled)

    def set(self, value: float):
        if not self._enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        if not self._enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def set_to_current_time(self):
        self.set(time.time())

    @property
    def value(self) -> float:
        return self._value


#: default duration buckets (seconds) — spans 0.1 ms .. 60 s, the range a
#: training step / inference request / checkpoint save actually lands in
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_RESERVOIR_MAX = 2048


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name="", description="", label_names=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS, _enabled=True):
        super().__init__(name, description, label_names, _enabled)
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = tuple(b)
        self._counts = [0] * (len(b) + 1)      # +Inf bucket at the end
        self._sum = 0.0
        self._count = 0
        self._reservoir: List[float] = []
        self._res_i = 0                        # ring cursor once full
        # last exemplar per bucket index: (value, labels, unix_ts) —
        # memory bounded by bucket count; a tail bucket's exemplar carries
        # the trace_id of a request that actually landed there, linking a
        # /metrics scrape straight to its trace (OpenMetrics exemplars)
        self._exemplars: Dict[int, Tuple[float, Dict[str, str], float]] = {}

    def _make_child(self) -> "Histogram":
        return Histogram(buckets=self.buckets, _enabled=self._enabled)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None):
        if not self._enabled:
            return
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if exemplar:
                self._exemplars[idx] = (value, dict(exemplar), time.time())
            if len(self._reservoir) < _RESERVOIR_MAX:
                self._reservoir.append(value)
            else:   # ring overwrite: bounded memory, recency-biased
                self._reservoir[self._res_i] = value
                self._res_i = (self._res_i + 1) % _RESERVOIR_MAX

    def exemplars(self) -> Dict[int, Tuple[float, Dict[str, str], float]]:
        """Snapshot of the per-bucket-index exemplars."""
        with self._lock:
            return dict(self._exemplars)

    def time(self):
        """``with hist.time(): ...`` — observe the block's wall seconds."""
        return _HistogramTimer(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def quantile(self, q: float) -> float:
        """Reservoir quantile (exact over the retained window)."""
        with self._lock:
            data = sorted(self._reservoir)
        if not data:
            return float("nan")
        if q <= 0:
            return data[0]
        if q >= 1:
            return data[-1]
        pos = q * (len(data) - 1)
        lo = int(pos)
        frac = pos - lo
        hi = min(lo + 1, len(data) - 1)
        return data[lo] * (1 - frac) + data[hi] * frac

    def percentiles(self, qs: Iterable[float] = (0.5, 0.95, 0.99)
                    ) -> Dict[float, float]:
        return {q: self.quantile(q) for q in qs}


class _HistogramTimer:
    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Instrument factory + Prometheus text renderer.

    ``counter/gauge/histogram`` are get-or-create: repeated calls with the
    same name return the SAME instrument, so independent modules publish
    into shared series without coordination (the process-wide contract).
    """

    def __init__(self, enabled: Optional[bool] = None):
        self._instruments: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()
        self._enabled_override = enabled

    @property
    def enabled(self) -> bool:
        if self._enabled_override is not None:
            return self._enabled_override
        return metrics_enabled()

    def _get_or_create(self, cls, name, description, label_names, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, not {cls.kind}")
                return inst
            inst = cls(name, description, tuple(label_names),
                       _enabled=self.enabled, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, description: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, description, label_names)

    def gauge(self, name: str, description: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, description, label_names)

    def histogram(self, name: str, description: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, description, label_names,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def clear(self):
        """Drop every instrument (test isolation; live handles detach)."""
        with self._lock:
            self._instruments.clear()

    # --------------------------------------------------- prometheus render
    def render_prometheus(self, openmetrics: bool = False) -> str:
        """Text exposition (the /metrics payload). Default is strict
        format 0.0.4 — exemplars are NOT legal there and would fail a real
        Prometheus scrape, so they only render under ``openmetrics=True``
        (the OpenMetrics-flavored output, ``# EOF``-terminated), which
        UIServer serves on Accept-header negotiation."""
        out: List[str] = []
        with self._lock:
            insts = [self._instruments[n] for n in sorted(self._instruments)]
        for inst in insts:
            # OpenMetrics names counter FAMILIES without the _total suffix
            # (samples keep it); a strict OM parser rejects a suffix-less
            # counter sample, which would take the whole target down
            family = inst.name
            if (openmetrics and inst.kind == "counter"
                    and family.endswith("_total")):
                family = family[:-len("_total")]
            out.append(f"# HELP {family} {inst.description or inst.name}")
            out.append(f"# TYPE {family} {inst.kind}")
            for lvals, child in inst.series():
                if inst.kind == "histogram":
                    self._render_histogram(out, inst, lvals, child,
                                           exemplars=openmetrics)
                else:
                    out.append(
                        f"{inst.name}"
                        f"{_fmt_labels(inst.label_names, lvals)} "
                        f"{_fmt_value(child.value)}")
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + ("\n" if out else "")

    @staticmethod
    def _fmt_exemplar(ex) -> str:
        """OpenMetrics exemplar suffix: `` # {labels} value timestamp``.
        Appended only to bucket lines that have one; plain lines keep the
        0.0.4 shape, and the suffix still ends in a float so naive
        line-splitting scrapers keep working."""
        if ex is None:
            return ""
        value, labels, ts = ex
        body = _fmt_labels((), (), tuple(labels.items()))
        return f" # {body} {_fmt_value(value)} {ts:.3f}"

    @classmethod
    def _render_histogram(cls, out: List[str], inst, lvals, child: Histogram,
                          exemplars: bool = False):
        cum = 0
        counts = child.bucket_counts()
        exs = child.exemplars() if exemplars else {}
        for i, (bound, c) in enumerate(zip(child.buckets, counts)):
            cum += c
            out.append(
                f"{inst.name}_bucket"
                f"{_fmt_labels(inst.label_names, lvals, (('le', _fmt_value(bound)),))}"
                f" {cum}{cls._fmt_exemplar(exs.get(i))}")
        cum += counts[-1]
        out.append(
            f"{inst.name}_bucket"
            f"{_fmt_labels(inst.label_names, lvals, (('le', '+Inf'),))}"
            f" {cum}{cls._fmt_exemplar(exs.get(len(child.buckets)))}")
        out.append(f"{inst.name}_sum"
                   f"{_fmt_labels(inst.label_names, lvals)}"
                   f" {_fmt_value(child.sum)}")
        out.append(f"{inst.name}_count"
                   f"{_fmt_labels(inst.label_names, lvals)}"
                   f" {child.count}")


_global_registry: Optional[MetricsRegistry] = None
_global_lock = threading.Lock()


def global_registry() -> MetricsRegistry:
    """THE process-wide registry every built-in instrumentation point uses."""
    global _global_registry
    if _global_registry is None:
        with _global_lock:
            if _global_registry is None:
                _global_registry = MetricsRegistry()
    return _global_registry


_reset_hooks: List = []


def on_registry_reset(fn):
    """Register a callback fired by :func:`reset_global_registry` — modules
    that cache label-bound handles use it to drop them so they re-bind."""
    _reset_hooks.append(fn)
    return fn


def reset_global_registry():
    """Fresh global registry (test isolation)."""
    global _global_registry
    with _global_lock:
        _global_registry = MetricsRegistry()
    for fn in list(_reset_hooks):
        fn()
