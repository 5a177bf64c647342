"""Fleet observability plane: cross-process trace propagation, metrics
federation, fleet health rollup, and coordinated incident capture.

The registry, tracing, SLO and cost layers form a deep *per-process*
observatory; the serving fleet (proxy + N workers + leader + shared
store) would otherwise be observable only one process at a time.
This module is the fleet-level half (the cross-host
posture of Abadi et al. arXiv:1605.08695 §9 — aggregated metrics and
request-scoped tracing are what make a multi-process system debuggable):

- **Trace propagation**: the ``X-Dl4j-Trace-Id`` / ``X-Dl4j-Parent-Id``
  request headers carry the caller's :class:`TraceContext` across
  process hops.  :func:`inbound_context` joins an HTTP handler to it
  (or pre-allocates a fresh root id so EVERY response path can carry
  the header); :func:`inject_trace_headers` rewrites a buffered raw
  request so the proxy's upstream hop forwards its own context — one
  request is ONE trace id across proxy span, worker span ring, response
  header and SSE stream, including across an idempotent-replay
  failover.
- **Metrics federation**: :func:`render_fleet` scrapes every live
  worker's ``/metrics`` (worker set from the SharedStore registry),
  merges the Prometheus text streams with a ``worker`` label injected
  per series (cardinality bounded by a ``tenant_label``-style fold to
  ``__other__`` beyond ``DL4J_TPU_FLEET_WORKER_TOP_N``), and folds in
  the local process's own series.  A dead worker yields a partial
  result plus ``dl4j_fleet_scrape_errors_total{worker}`` — never a 500
  because one worker died.
- **Fleet health**: :class:`FleetHealth` grades the federated view
  through the existing :class:`SLOEngine` rule machinery — worst-worker
  latency quantile, fleet error rate, workers-alive vs registered,
  leader-term staleness — with per-worker attribution; the leader
  publishes the rollup into the shared store (:func:`publish_rollup`)
  so ``/debug/fleet`` shows one consistent verdict.
- **Incident capture**: a tripped flight recorder posts an incident
  record into the store (:func:`post_incident`, wired by
  :func:`install_incident_publisher`); every worker's
  :func:`incident_beat` sees the leader's fan-out and dumps its own
  bundle stamped with the SAME incident id (``reason="incident:<id>"``
  writes ``incident.json`` into the bundle), so one incident yields a
  fleet-wide set of bundles under the existing
  ``DL4J_TPU_POSTMORTEM_KEEP`` retention.

Kill switch: ``DL4J_TPU_FLEET_OBS=0`` (read live) restores the
pre-fleet-observability behavior byte-identically — inbound trace
headers are ignored, the fleet endpoints 404, the proxy opens no spans
and injects nothing, and the incident protocol is inert.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch.observability.registry import (_fmt_labels,
                                                       _fmt_value,
                                                       global_registry,
                                                       on_registry_reset)
from deeplearning4j_tpu_torch.observability.slo import (FAILING, OK, SLOEngine,
                                                  SLORule, _grade,
                                                  global_slo_engine)
from deeplearning4j_tpu_torch.observability.timeseries import (
    timeseries_payload, watchtower_enabled)
from deeplearning4j_tpu_torch.observability.trace_store import (
    global_trace_store, trace_store_enabled)
from deeplearning4j_tpu_torch.observability.tracing import (TraceContext,
                                                      current_context,
                                                      global_trace_sink)
from deeplearning4j_tpu_torch.observability.watchtower import (
    PAGE, WARN, BurnRateDetector, ChangePointDetector, ThresholdDetector,
    Watchtower, global_watchtower, incident_cooldown_s)

__all__ = [
    "TRACE_HEADER", "PARENT_HEADER", "fleet_obs_enabled", "worker_top_n",
    "scrape_timeout_s", "health_interval_s", "parse_trace_id",
    "inbound_context", "trace_context_from_bytes", "inject_trace_headers",
    "parse_prometheus", "merge_prometheus", "fold_workers",
    "scrape_workers", "render_fleet", "FleetHealth", "publish_rollup",
    "post_incident", "incident_beat", "install_incident_publisher",
    "FleetAdminServer",
    "scrape_worker_traces", "fleet_recent_traces", "assemble_trace",
    "assembled_chrome_trace", "handle_trace_route", "PHASES",
    "FleetWatch", "fleet_default_detectors", "publish_alerts",
    "handle_alerts_route",
]

#: the cross-process trace headers (the front door already EMITTED the
#: first one; the fleet plane makes both flow inbound and proxy→worker)
TRACE_HEADER = "X-Dl4j-Trace-Id"
PARENT_HEADER = "X-Dl4j-Parent-Id"

#: worker heartbeat freshness window — ONE constant with
#: ``serving.shared_state.WORKER_TTL_S`` (spelled locally so this module
#: never imports the serving tree at import time: frontdoor imports us)
_WORKER_TTL_S = 3.0

#: shared-store incident list cap (newest kept) and the window inside
#: which a fanned-out incident still triggers peer captures — an
#: ancient record must not dump-storm a freshly joined worker
_INCIDENT_CAP = 16
_INCIDENT_FRESH_S = 600.0


def fleet_obs_enabled() -> bool:
    """``DL4J_TPU_FLEET_OBS`` kill switch, resolved LIVE per call —
    flipping it off restores the per-process behavior without a
    restart."""
    return os.environ.get("DL4J_TPU_FLEET_OBS", "1") != "0"


def worker_top_n() -> int:
    """Workers beyond the first N (sorted ids) fold their ``worker``
    label to ``__other__`` — the qos ``tenant_label`` cardinality
    posture applied to the fleet dimension."""
    try:
        return max(1, int(os.environ.get("DL4J_TPU_FLEET_WORKER_TOP_N",
                                         16)))
    except (TypeError, ValueError):
        return 16


def scrape_timeout_s() -> float:
    """Per-worker ``/metrics`` scrape timeout: one wedged worker must
    cost one bounded wait, not the whole federation response."""
    try:
        return max(0.05, float(os.environ.get(
            "DL4J_TPU_FLEET_SCRAPE_TIMEOUT_S", 2.0)))
    except (TypeError, ValueError):
        return 2.0


def health_interval_s() -> float:
    """How often the LEADER re-evaluates and publishes the fleet health
    rollup into the shared store."""
    try:
        return max(0.05, float(os.environ.get(
            "DL4J_TPU_FLEET_HEALTH_INTERVAL_S", 5.0)))
    except (TypeError, ValueError):
        return 5.0


# ------------------------------------------------------ trace propagation

_ID_RE = re.compile(r"^[0-9a-f]{8,32}$")


def parse_trace_id(value) -> Optional[str]:
    """A caller-supplied trace/span id, validated: 8–32 lowercase hex
    chars (the W3C trace-context id alphabet).  Anything else — absent,
    empty, injection-shaped — is None: ids land in response headers and
    log lines, so they must never round-trip arbitrary bytes."""
    if not value:
        return None
    v = str(value).strip().lower()
    return v if _ID_RE.match(v) else None


def _fresh_id() -> str:
    return os.urandom(8).hex()


def inbound_context(headers) -> TraceContext:
    """The request's trace context from its inbound headers (any mapping
    with ``.get``, e.g. ``http.server``'s message object).  A valid
    caller id joins the caller's trace (parent optional); otherwise a
    fresh root id is pre-allocated so EVERY response path — including
    the pre-span early exits — can carry ``X-Dl4j-Trace-Id``."""
    tid = parse_trace_id(headers.get(TRACE_HEADER))
    if tid is None:
        return TraceContext(_fresh_id(), None)
    return TraceContext(tid, parse_trace_id(headers.get(PARENT_HEADER)))


def trace_context_from_bytes(hmap: Dict[bytes, bytes]) -> TraceContext:
    """Same as :func:`inbound_context` for the proxy's buffered request
    (lowercased ``bytes`` header map from ``_read_request``)."""
    def get(name: str):
        v = hmap.get(name.lower().encode("ascii"))
        return v.decode("ascii", "replace") if v is not None else None
    tid = parse_trace_id(get(TRACE_HEADER))
    if tid is None:
        return TraceContext(_fresh_id(), None)
    return TraceContext(tid, parse_trace_id(get(PARENT_HEADER)))


def inject_trace_headers(raw: bytes, trace_id: Optional[str],
                         parent_id: Optional[str]) -> bytes:
    """Rewrite a buffered raw HTTP request so the upstream hop carries
    OUR trace context: any existing trace/parent header lines are
    stripped (a client must not spoof past the proxy's span) and the
    proxy's are inserted.  The body is untouched; a head the splitter
    can't find (non-CRLF framing) passes through unmodified."""
    if trace_id is None:
        return raw
    head, sep, body = raw.partition(b"\r\n\r\n")
    if not sep:
        return raw
    drop = (TRACE_HEADER.lower().encode() + b":",
            PARENT_HEADER.lower().encode() + b":")
    lines = [ln for i, ln in enumerate(head.split(b"\r\n"))
             if i == 0 or not ln.lower().startswith(drop)]
    lines.append(TRACE_HEADER.encode() + b": " + trace_id.encode())
    if parent_id is not None:
        lines.append(PARENT_HEADER.encode() + b": " + parent_id.encode())
    return b"\r\n".join(lines) + sep + body


# ------------------------------------------------------ prometheus merge

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return (v.replace(r"\n", "\n").replace(r"\"", '"')
            .replace("\\\\", "\\"))


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                        float]]]:
    """Minimal 0.0.4 text parse: ``{sample_name: [(labels, value)]}``.
    Comment/blank lines are skipped; unparseable sample lines are
    dropped (a half-written scrape must not fail the federation)."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        try:
            value = float(m.group(3))
        except ValueError:
            continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(m.group(2) or "")}
        out.setdefault(m.group(1), []).append((labels, value))
    return out


def fold_workers(worker_ids) -> Dict[str, str]:
    """Worker-label fold (the ``tenant_label`` posture): the first
    top-N sorted ids keep their own label, the rest share
    ``__other__`` — a 500-worker fleet cannot explode the label space
    of every federated series."""
    ids = sorted(worker_ids)
    keep = set(ids[:worker_top_n()])
    return {w: (w if w in keep else "__other__") for w in ids}


def merge_prometheus(parts) -> str:
    """Merge Prometheus text streams into one exposition.  ``parts`` is
    an iterable of ``(worker_label, text)`` — a ``worker`` label is
    injected into every sample that doesn't already carry one (a
    worker's own ``worker``-labeled series, e.g. the scrape-error
    counter, keeps its attribution), HELP/TYPE are first-wins per
    family, and samples that collide after the label fold sum."""
    fams: Dict[str, dict] = {}

    def fam_entry(name: str) -> dict:
        return fams.setdefault(name, {"help": None, "type": None,
                                      "samples": {}})

    for label, text in parts:
        fam = None
        for line in text.splitlines():
            if line.startswith("# HELP "):
                name, _, help_text = line[len("# HELP "):].partition(" ")
                ent = fam_entry(name)
                if ent["help"] is None:
                    ent["help"] = help_text
                fam = name
            elif line.startswith("# TYPE "):
                name, _, kind = line[len("# TYPE "):].partition(" ")
                ent = fam_entry(name)
                if ent["type"] is None:
                    ent["type"] = kind.strip()
                fam = name
            elif not line or line.startswith("#"):
                continue
            else:
                m = _SAMPLE_RE.match(line)
                if m is None:
                    continue
                try:
                    value = float(m.group(3))
                except ValueError:
                    continue
                sname = m.group(1)
                labels = {k: _unescape(v) for k, v
                          in _LABEL_RE.findall(m.group(2) or "")}
                if label is not None and "worker" not in labels:
                    labels["worker"] = str(label)
                # histogram/summary child samples (name_bucket/_sum/
                # _count) group under the family the TYPE line named
                fam_name = (fam if fam and sname.startswith(fam)
                            else sname)
                ent = fam_entry(fam_name)
                key = (sname, tuple(sorted(labels.items())))
                ent["samples"][key] = ent["samples"].get(key, 0.0) + value
    out: List[str] = []
    for fam_name in sorted(fams):
        ent = fams[fam_name]
        if not ent["samples"]:
            continue
        out.append(f"# HELP {fam_name} {ent['help'] or fam_name}")
        out.append(f"# TYPE {fam_name} {ent['type'] or 'untyped'}")
        for sname, litems in sorted(ent["samples"]):
            out.append(sname + _fmt_labels((), (), litems) + " "
                       + _fmt_value(ent["samples"][(sname, litems)]))
    return "\n".join(out) + "\n"


# -------------------------------------------------------------- scraping

_scrape_obs_cache: Optional[tuple] = None
_scrape_err_children: Dict[str, object] = {}


def _scrape_obs():
    global _scrape_obs_cache
    if _scrape_obs_cache is None:
        reg = global_registry()
        _scrape_obs_cache = (
            reg.counter("dl4j_fleet_scrape_errors_total",
                        "federation scrapes of a live-registered worker "
                        "that failed (dead/wedged worker — the merged "
                        "output is partial, never a 500)",
                        label_names=("worker",)),
            reg.histogram("dl4j_fleet_scrape_seconds",
                          "wall time of one worker /metrics scrape "
                          "during federation"))
    return _scrape_obs_cache


def _scrape_error(worker: str):
    child = _scrape_err_children.get(worker)
    if child is None:
        child = _scrape_err_children[worker] = _scrape_obs()[0].labels(
            worker=worker)
    return child


@on_registry_reset
def _drop_scrape_obs():
    global _scrape_obs_cache
    _scrape_obs_cache = None
    _scrape_err_children.clear()


def scrape_workers(store) -> Tuple[dict, Dict[str, str], Dict[str, str]]:
    """Scrape every live-registered worker's ``/metrics``: returns
    ``(store_doc, {worker: text}, {worker: error})``.  Liveness is the
    store heartbeat (the proxy's own freshness rule); an unreachable
    live worker lands in ``errors`` and bumps
    ``dl4j_fleet_scrape_errors_total{worker}`` — partial data is an
    answer, a dead worker is not an exception."""
    try:
        doc = store.read()
    except Exception as e:
        return {"error": repr(e)}, {}, {"__store__": repr(e)}
    now = time.time()
    timeout = scrape_timeout_s()
    texts: Dict[str, str] = {}
    errors: Dict[str, str] = {}
    for wid, rec in sorted((doc.get("workers") or {}).items()):
        if not isinstance(rec, dict) or not rec.get("port"):
            continue
        if now - float(rec.get("heartbeat", 0) or 0) > _WORKER_TTL_S:
            continue                       # expired: not live, not an error
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{int(rec['port'])}/metrics",
                    timeout=timeout) as r:
                texts[wid] = r.read().decode("utf-8", "replace")
            _scrape_obs()[1].observe(time.perf_counter() - t0)
        except Exception as e:
            errors[wid] = repr(e)
            _scrape_error(wid).inc()
    return doc, texts, errors


def render_fleet(store, local_worker: str = "proxy",
                 registry=None) -> str:
    """The ``/metrics/fleet`` payload: every live worker's series with a
    ``worker`` label (fold-bounded cardinality), plus the LOCAL
    process's own series (the proxy's failover/circuit/queue counters,
    and the scrape-error counter naming any unreachable worker) under
    ``worker="<local_worker>"``."""
    _doc, texts, _errors = scrape_workers(store)
    fold = fold_workers(texts)
    parts = [(fold[w], texts[w]) for w in sorted(texts)]
    reg = registry if registry is not None else global_registry()
    parts.append((local_worker, reg.render_prometheus()))
    return merge_prometheus(parts)


# -------------------------------------------------------- trace assembly

#: waterfall phase decomposition: assembled span names → the request
#: phase they account to (the serving pipeline's queue→prefill→decode→
#: dispatch shape; names are lint-bounded by the span-names checker)
PHASES = {
    "queue_wait": ("queue_wait", "slot_wait"),
    "prefill": ("prefill",),
    "decode": ("decode_step",),
    "dispatch": ("inference_dispatch",),
}


def _fetch_worker_json(port: int, path: str,
                       timeout: float) -> Optional[dict]:
    """One worker debug-endpoint fetch; an HTTP 404 is a clean miss
    (the worker simply doesn't hold that trace) and returns None, any
    other failure raises for the caller's errors map."""
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{int(port)}{path}", timeout=timeout) as r:
            doc = json.loads(r.read().decode("utf-8", "replace"))
            return doc if isinstance(doc, dict) else None
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


def _live_worker_ports(doc) -> List[Tuple[str, int]]:
    now = time.time()
    out: List[Tuple[str, int]] = []
    for wid, rec in sorted((doc.get("workers") or {}).items()):
        if not isinstance(rec, dict) or not rec.get("port"):
            continue
        if now - float(rec.get("heartbeat", 0) or 0) > _WORKER_TTL_S:
            continue
        out.append((wid, int(rec["port"])))
    return out


def scrape_worker_traces(store, trace_id: str
                         ) -> Tuple[dict, Dict[str, dict],
                                    Dict[str, str]]:
    """Every live worker's LOCAL retained payload for ``trace_id`` (the
    ``?local=1`` form — fan-out must never recurse into another
    fan-out): ``(store_doc, {worker: payload}, {worker: error})``.
    Workers that don't hold the id are absent, not errors; a dead
    worker lands in ``errors`` exactly like a ``/metrics`` federation
    scrape — partial assembly is an answer."""
    try:
        doc = store.read()
    except Exception as e:
        return {"error": repr(e)}, {}, {"__store__": repr(e)}
    timeout = scrape_timeout_s()
    payloads: Dict[str, dict] = {}
    errors: Dict[str, str] = {}
    for wid, port in _live_worker_ports(doc):
        try:
            got = _fetch_worker_json(
                port, f"/debug/trace/{trace_id}?local=1", timeout)
            if got is not None:
                payloads[wid] = got
        except Exception as e:
            errors[wid] = repr(e)
            _scrape_error(wid).inc()
    return doc, payloads, errors


def fleet_recent_traces(store, local_worker: str = "proxy",
                        limit: int = 64) -> dict:
    """The fleet ``/debug/trace/recent`` payload: every live worker's
    retained-trace summaries (scraped ``?local=1``) merged with the
    local store's, each stamped with its holding worker, newest
    first."""
    try:
        doc = store.read()
    except Exception as e:
        doc, errors = {"error": repr(e)}, {"__store__": repr(e)}
        live = []
    else:
        errors = {}
        live = _live_worker_ports(doc)
    timeout = scrape_timeout_s()
    entries: List[dict] = []
    for wid, port in live:
        try:
            got = _fetch_worker_json(
                port, f"/debug/trace/recent?local=1&limit={int(limit)}",
                timeout)
        except Exception as e:
            errors[wid] = repr(e)
            _scrape_error(wid).inc()
            continue
        for t in ((got or {}).get("traces") or []):
            if isinstance(t, dict):
                entries.append({**t, "worker": wid})
    for t in global_trace_store().recent(limit=limit):
        entries.append({**t, "worker": local_worker})
    entries.sort(key=lambda t: -float(t.get("at", 0) or 0))
    return {"traces": entries[:max(1, int(limit))],
            "partial": bool(errors), "scrape_errors": errors}


def _assembled_depths(spans: List[dict]) -> Dict[str, int]:
    """Parent-chain depth across the ASSEMBLED span set (a worker span
    whose parent lives in the proxy nests under it; each record's local
    ``depth`` only knows its own process)."""
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    depths: Dict[str, int] = {}

    def depth_of(sid: str, hops: int = 0) -> int:
        if sid in depths:
            return depths[sid]
        if hops > 64:                      # cycle guard on hostile ids
            return 0
        s = by_id.get(sid)
        parent = s.get("parent_id") if s else None
        d = (depth_of(parent, hops + 1) + 1
             if parent and parent in by_id else 0)
        depths[sid] = d
        return d

    for s in spans:
        if s.get("span_id"):
            depth_of(s["span_id"])
    return depths


def assemble_trace(store, trace_id: str,
                   local_payload: Optional[dict] = None,
                   local_worker: str = "proxy") -> Optional[dict]:
    """Stitch one trace id's spans from every live worker (plus the
    local store's copy) into a single cross-worker waterfall: spans
    tagged with their holding worker, phase decomposition per
    :data:`PHASES`, per-span tenant attribution, and honest
    ``partial``/``scrape_errors`` when a worker couldn't answer.
    Returns None when NO process holds the id (the 404 case)."""
    _doc, payloads, errors = scrape_worker_traces(store, trace_id)
    if local_payload is not None:
        payloads = {**payloads, local_worker: local_payload}
    return _doc_from_payloads(trace_id, payloads, errors)


def _doc_from_payloads(trace_id: str, payloads: Dict[str, dict],
                       errors: Dict[str, str]) -> Optional[dict]:
    if not payloads:
        return None
    spans: List[dict] = []
    reasons: Dict[str, str] = {}
    for wid in sorted(payloads):
        p = payloads[wid]
        if p.get("reason"):
            reasons[wid] = p["reason"]
        for s in (p.get("spans") or []):
            if isinstance(s, dict):
                spans.append({**s, "worker": wid})
    if not spans:
        return None
    spans.sort(key=lambda s: float(s.get("ts_us", 0) or 0))
    depths = _assembled_depths(spans)
    ids = {s["span_id"] for s in spans if s.get("span_id")}
    roots = [s for s in spans
             if not s.get("parent_id") or s["parent_id"] not in ids]
    root = max(roots or spans,
               key=lambda s: float(s.get("dur_us", 0) or 0))
    t0 = float(spans[0].get("ts_us", 0) or 0)
    end = max(float(s.get("ts_us", 0) or 0)
              + float(s.get("dur_us", 0) or 0) for s in spans)
    phases = {
        phase: round(sum(float(s.get("dur_us", 0) or 0) for s in spans
                         if s.get("name") in names), 1)
        for phase, names in PHASES.items()}
    waterfall = [
        {"name": s.get("name"), "worker": s["worker"],
         "tenant": (s.get("attrs") or {}).get("tenant"),
         "offset_us": round(float(s.get("ts_us", 0) or 0) - t0, 1),
         "dur_us": round(float(s.get("dur_us", 0) or 0), 1),
         "depth": depths.get(s.get("span_id"), 0),
         "error": bool(s.get("error")
                       or (s.get("attrs") or {}).get("error_type"))}
        for s in spans]
    return {
        "trace_id": trace_id,
        "workers": sorted(payloads),
        "reasons": reasons,
        "partial": bool(errors),
        "scrape_errors": errors,
        "root": {"name": root.get("name"), "worker": root["worker"],
                 "error": bool(root.get("error")),
                 "error_type": (root.get("error_type")
                                or (root.get("attrs") or {})
                                .get("error_type")),
                 "attrs": root.get("attrs") or {}},
        "duration_us": round(end - t0, 1),
        "phases": phases,
        "n_spans": len(spans),
        "waterfall": waterfall,
        "spans": spans,
    }


def assembled_chrome_trace(doc: dict) -> List[dict]:
    """An assembled trace as Chrome trace events with per-worker
    namespacing (satellite fix): each worker gets its own integer
    ``pid`` (named via process_name metadata) so two workers' thread
    ids can't collide on one track, and flow-event ids are namespaced
    ``"<worker>:<span_id>"`` strings so concatenated exports from N
    processes can't alias each other's arrows.  Flow pairs are emitted
    for every parent→child edge that crosses a (worker, thread)
    boundary — including the proxy→worker hop one process's export
    could never draw."""
    spans = doc.get("spans") or []
    pid_of = {w: i + 1 for i, w in enumerate(sorted(doc.get("workers")
                                                    or []))}
    events: List[dict] = []
    for wid, pid in sorted(pid_of.items(), key=lambda kv: kv[1]):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": wid}})
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    for s in spans:
        pid = pid_of.get(s.get("worker"), 0)
        ev = {"name": s.get("name"), "ph": "X",
              "ts": s.get("ts_us"), "dur": s.get("dur_us"),
              "pid": pid, "tid": s.get("tid"), "cat": "host",
              "args": {**(s.get("attrs") or {}),
                       "trace_id": s.get("trace_id"),
                       "span_id": s.get("span_id"),
                       "parent_id": s.get("parent_id"),
                       "worker": s.get("worker")}}
        if s.get("error"):
            ev["args"]["error"] = True
            if s.get("error_type"):
                ev["args"]["error_type"] = s["error_type"]
        events.append(ev)
        parent = by_id.get(s.get("parent_id")) if s.get("parent_id") \
            else None
        if parent is None:
            continue
        if (parent.get("worker"), parent.get("tid")) == (s.get("worker"),
                                                         s.get("tid")):
            continue            # same-track nesting needs no arrow
        s_ts = min(float(parent.get("ts_us", 0) or 0),
                   float(s.get("ts_us", 0) or 0))
        flow_id = f"{s.get('worker')}:{s.get('span_id')}"
        events.append({"name": "handoff", "cat": "flow", "ph": "s",
                       "id": flow_id, "ts": s_ts,
                       "pid": pid_of.get(parent.get("worker"), 0),
                       "tid": parent.get("tid")})
        events.append({"name": "handoff", "cat": "flow", "ph": "f",
                       "bp": "e", "id": flow_id,
                       "ts": max(float(s.get("ts_us", 0) or 0), s_ts),
                       "pid": pid, "tid": s.get("tid")})
    return events


def handle_trace_route(path: str, query: Dict[str, list],
                       store=None, local_worker: str = "local",
                       fleet: bool = False) -> Tuple[int, object]:
    """Shared ``/debug/trace*`` routing for all three HTTP surfaces
    (front door, UIServer, proxy admin): ``(status, json_payload)``.

    - ``/debug/trace/recent`` — retained summaries with why-kept
      reasons; fleet surfaces fan out (``?local=1`` pins it local — the
      form fan-out itself requests, so scrapes can't recurse).
    - ``/debug/trace/<id>`` — the assembled cross-worker waterfall on
      fleet surfaces, the raw local payload with ``?local=1`` or on a
      plain worker; ``?format=chrome`` exports Perfetto-loadable
      events.  Unknown/invalid ids are a 404, never a 500.
    """
    q = query or {}
    local_only = (q.get("local", ["0"]) or ["0"])[0] == "1"
    as_fleet = (fleet and store is not None and not local_only
                and fleet_obs_enabled())
    chrome = (q.get("format", [""]) or [""])[0] == "chrome"
    st = global_trace_store()
    p = path.rstrip("/")
    if p in ("/debug/trace", "/debug/trace/recent"):
        try:
            limit = max(1, int((q.get("limit", ["64"]) or ["64"])[0]))
        except (TypeError, ValueError):
            limit = 64
        if as_fleet:
            return 200, fleet_recent_traces(store, local_worker, limit)
        return 200, {"worker": local_worker,
                     "traces": st.recent(limit=limit)}
    tid = (parse_trace_id(p[len("/debug/trace/"):])
           if p.startswith("/debug/trace/") else None)
    if tid is None:
        return 404, {"error": "NotFound", "path": path}
    local = st.get(tid)
    if local_only and not chrome:
        # the fan-out wire format: the RAW store payload (reason +
        # spans), exactly what scrape_worker_traces re-stitches
        if local is None:
            return 404, {"error": "NotFound", "trace_id": tid}
        return 200, {**local, "worker": local_worker}
    if as_fleet:
        doc = assemble_trace(store, tid, local_payload=local,
                             local_worker=local_worker)
    else:
        doc = _doc_from_payloads(tid, {local_worker: local} if local
                                 else {}, {})
    if doc is None:
        return 404, {"error": "NotFound", "trace_id": tid}
    if chrome:
        return 200, assembled_chrome_trace(doc)
    return 200, doc


# ---------------------------------------------------------- fleet health

class _FleetRule(SLORule):
    """Base for fleet rules: graded from the :class:`FleetHealth`
    snapshot (the federated scrape + store doc), not the local registry
    the engine passes — the whole point is the OTHER processes."""

    def __init__(self, name: str, description: str, fleet: "FleetHealth"):
        super().__init__(name, description)
        self._fleet = fleet


def _bucket_quantile(le_cum: Dict[float, float], q: float) -> float:
    """Prometheus-style histogram quantile over summed cumulative
    bucket counts: linear interpolation within the winning bucket; a
    quantile landing in the +Inf bucket answers the highest finite
    bound (the honest 'at least this much')."""
    bounds = sorted(le_cum)
    total = le_cum.get(float("inf"), 0.0)
    if total <= 0:
        return float("nan")
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound in bounds:
        cum = le_cum[bound]
        if cum >= target:
            if bound == float("inf"):
                finite = [b for b in bounds if b != float("inf")]
                return finite[-1] if finite else float("nan")
            if cum <= prev_cum:
                return bound
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return float("nan")


class _WorstWorkerLatencyRule(_FleetRule):
    """Worst worker wins (the LatencyQuantileRule posture lifted to the
    fleet): a drowning worker must not hide behind healthy peers."""

    def __init__(self, fleet, metric: str = "dl4j_http_latency_seconds",
                 quantile: float = 0.99, degraded: float = 1.0,
                 failing: float = 5.0, min_count: int = 16):
        super().__init__("fleet_worst_worker_p99",
                         f"worst worker p{int(quantile * 100)} of "
                         f"{metric} across the fleet", fleet)
        self.metric = metric
        self.quantile = quantile
        self.degraded = degraded
        self.failing = failing
        self.min_count = min_count

    def _evaluate(self, registry) -> dict:
        worst, worst_wid = None, None
        for wid, parsed in sorted(self._fleet.snap["workers"].items()):
            le_cum: Dict[float, float] = {}
            for labels, value in parsed.get(self.metric + "_bucket", ()):
                le = labels.get("le")
                if le is None:
                    continue
                try:
                    bound = float(le)
                except ValueError:
                    continue
                le_cum[bound] = le_cum.get(bound, 0.0) + value
            if le_cum.get(float("inf"), 0.0) < self.min_count:
                continue
            q = _bucket_quantile(le_cum, self.quantile)
            if q == q and (worst is None or q > worst):
                worst, worst_wid = q, wid
        if worst is None:
            return {"status": OK,
                    "detail": f"<{self.min_count} samples on every "
                              f"worker"}
        return {"status": _grade(worst, self.degraded, self.failing),
                "value": worst, "quantile": self.quantile,
                "worker": worst_wid,
                "detail": f"worker {worst_wid}: "
                          f"p{int(self.quantile * 100)}={worst:.4g}s",
                "degraded_above": self.degraded,
                "failing_above": self.failing}


class _FleetErrorRateRule(_FleetRule):
    """Fleet-wide 5xx fraction of ``dl4j_http_requests_total``, with
    the worst single worker named for attribution."""

    def __init__(self, fleet, metric: str = "dl4j_http_requests_total",
                 degraded: float = 0.02, failing: float = 0.10,
                 min_requests: int = 20):
        super().__init__("fleet_error_rate",
                         f"fleet-wide 5xx fraction of {metric}", fleet)
        self.metric = metric
        self.degraded = degraded
        self.failing = failing
        self.min_requests = min_requests

    def _evaluate(self, registry) -> dict:
        total = errors = 0.0
        per: Dict[str, float] = {}
        for wid, parsed in sorted(self._fleet.snap["workers"].items()):
            wt = we = 0.0
            for labels, value in parsed.get(self.metric, ()):
                wt += value
                if str(labels.get("code", "")).startswith("5"):
                    we += value
            total += wt
            errors += we
            if wt > 0:
                per[wid] = we / wt
        if total < self.min_requests:
            return {"status": OK, "requests": total,
                    "detail": f"<{self.min_requests} requests"}
        rate = errors / total
        worst = max(per, key=per.get) if per else None
        return {"status": _grade(rate, self.degraded, self.failing),
                "value": rate, "requests": total, "worker": worst,
                "detail": (f"worst worker {worst}: "
                           f"{per.get(worst, 0.0):.2%}" if worst
                           else "no per-worker data"),
                "degraded_above": self.degraded,
                "failing_above": self.failing}


class _WorkersAliveRule(_FleetRule):
    """Registered vs alive (store heartbeats) plus scrape reachability:
    zero alive with registrations is failing; any missing/unreachable
    worker is a page naming exactly who is gone."""

    def __init__(self, fleet):
        super().__init__("fleet_workers_alive",
                         "store-registered workers with fresh "
                         "heartbeats, all reachable for scrape", fleet)

    def _evaluate(self, registry) -> dict:
        doc = self._fleet.snap["doc"]
        workers = {w: r for w, r in (doc.get("workers") or {}).items()
                   if isinstance(r, dict)}
        if not workers:
            return {"status": OK, "detail": "no workers registered"}
        now = time.time()
        alive = sorted(
            w for w, r in workers.items()
            if now - float(r.get("heartbeat", 0) or 0) <= _WORKER_TTL_S)
        stale = sorted(set(workers) - set(alive))
        unreachable = sorted(set(self._fleet.snap["errors"]) - {"__store__"})
        missing = sorted(set(stale) | set(unreachable))
        if not alive:
            status = FAILING
        elif missing:
            status = "degraded"
        else:
            status = OK
        return {"status": status, "value": float(len(alive)),
                "registered": len(workers), "missing": missing,
                "detail": (f"missing workers: {', '.join(missing)}"
                           if missing
                           else f"{len(alive)}/{len(workers)} alive")}


class _LeaderStalenessRule(_FleetRule):
    """The leader record's holder must itself be alive: a stale leader
    heartbeat means stage transitions and rollups have no author."""

    def __init__(self, fleet):
        super().__init__("fleet_leader_staleness",
                         "the recorded leader's heartbeat freshness "
                         "(a fleet without a live leader cannot "
                         "advance rollouts or publish rollups)", fleet)

    def _evaluate(self, registry) -> dict:
        doc = self._fleet.snap["doc"]
        workers = doc.get("workers") or {}
        leader = doc.get("leader") or {}
        holder = leader.get("worker")
        if holder is None:
            if workers:
                return {"status": "degraded",
                        "detail": "workers registered but no leader "
                                  "recorded"}
            return {"status": OK, "detail": "no fleet"}
        rec = workers.get(holder) or {}
        age = time.time() - float(rec.get("heartbeat", 0) or 0)
        return {"status": _grade(age, _WORKER_TTL_S, 3 * _WORKER_TTL_S),
                "value": age, "worker": holder,
                "term": leader.get("term"),
                "detail": f"leader {holder} (term {leader.get('term')}) "
                          f"heartbeat {age:.1f}s old",
                "degraded_above": _WORKER_TTL_S,
                "failing_above": 3 * _WORKER_TTL_S}


class FleetHealth:
    """``/health/fleet`` — the whole fleet graded through the existing
    :class:`SLOEngine` machinery over the federated scrape.  Each
    ``evaluate()``/``alerts()`` re-scrapes (the answer is current, not
    last-beat), and every non-ok rule result names the worst worker."""

    def __init__(self, store, worker_id: str = "proxy"):
        self._store = store
        self.worker_id = worker_id
        self.snap: dict = {"workers": {}, "errors": {}, "doc": {},
                           "at": 0.0}
        self._engine = SLOEngine(rules=[
            _WorstWorkerLatencyRule(self),
            _FleetErrorRateRule(self),
            _WorkersAliveRule(self),
            _LeaderStalenessRule(self),
        ])

    def refresh(self) -> dict:
        doc, texts, errors = scrape_workers(self._store)
        self.snap = {
            "workers": {w: parse_prometheus(t) for w, t in texts.items()},
            "errors": errors, "doc": doc, "at": time.time()}
        return self.snap

    def evaluate(self) -> dict:
        self.refresh()
        report = self._engine.evaluate()
        report["by"] = self.worker_id
        report["workers_scraped"] = sorted(self.snap["workers"])
        report["scrape_errors"] = dict(self.snap["errors"])
        return report

    def alerts(self) -> dict:
        self.refresh()
        return self._engine.alerts()


def publish_rollup(store, worker_id: str, term, report: dict) -> None:
    """The LEADER's fleet-health verdict into the shared store — one
    consistent answer every worker's ``/debug/fleet`` shows, instead of
    N processes each grading a different scrape instant."""
    stamp = {
        "status": report.get("status"),
        "failing_rules": report.get("failing_rules", []),
        "degraded_rules": report.get("degraded_rules", []),
        "workers_scraped": report.get("workers_scraped", []),
        "scrape_errors": report.get("scrape_errors", {}),
        "by": worker_id,
        "term": term,
        "at": time.time(),
    }

    def mutate(doc):
        doc["fleet_health"] = stamp
    store.update(mutate)


# ----------------------------------------------------- fleet watchtower

def fleet_default_detectors(fleet: "FleetWatch"):
    """The LEADER's fleet-level watch rules, graded from the federated
    scrape (the :class:`_FleetRule` posture lifted to the watchtower):
    fleet-wide 5xx burn, worst-worker p99 step change, and a plain
    bound on missing workers."""
    return [
        BurnRateDetector(
            "fleet_error_burn", totals_fn=fleet.http_totals,
            description="fleet-wide 5xx error-budget burn over the "
                        "federated scrape (fast+slow window pair)",
            severity=PAGE),
        ChangePointDetector(
            "fleet_p99_shift", fleet.worst_p99, direction="up",
            description="worst-worker front-door p99 step change across "
                        "the fleet",
            severity=WARN),
        ThresholdDetector(
            "fleet_workers_missing", fleet.missing_workers,
            firing_above=0.5,
            description="registered workers heartbeat-stale or "
                        "unreachable for scrape",
            severity=WARN),
    ]


class FleetWatch:
    """Leader-side fleet watchtower: a second :class:`Watchtower` whose
    detectors read the :class:`FleetHealth` federated snapshot instead
    of the local registry.  ``beat()`` rides the leader's alert-publish
    cadence; a firing fleet page closes the detect→capture loop exactly
    like a local one (the leader's bundle dump posts the incident the
    fan-out protocol spreads)."""

    def __init__(self, health: FleetHealth):
        self.health = health
        self.tower = Watchtower(detectors=fleet_default_detectors(self),
                                scrape=False)

    # ------------------------------------------------- detector inputs
    def http_totals(self):
        """Fleet-cumulative ``(5xx, total)`` of the front-door request
        counter summed over every scraped worker."""
        errors = total = 0.0
        for _wid, parsed in sorted(
                (self.health.snap.get("workers") or {}).items()):
            for labels, value in parsed.get("dl4j_http_requests_total",
                                            ()):
                total += value
                if str(labels.get("code", "")).startswith("5"):
                    errors += value
        return errors, total

    def worst_p99(self, now) -> Optional[float]:
        worst = None
        for _wid, parsed in sorted(
                (self.health.snap.get("workers") or {}).items()):
            le_cum: Dict[float, float] = {}
            for labels, value in parsed.get(
                    "dl4j_http_latency_seconds_bucket", ()):
                le = labels.get("le")
                if le is None:
                    continue
                try:
                    bound = float(le)
                except ValueError:
                    continue
                le_cum[bound] = le_cum.get(bound, 0.0) + value
            if le_cum.get(float("inf"), 0.0) < 8:
                continue
            q = _bucket_quantile(le_cum, 0.99)
            if q == q and (worst is None or q > worst):
                worst = q
        return worst

    def missing_workers(self, now) -> float:
        doc = self.health.snap.get("doc") or {}
        workers = {w: r for w, r in (doc.get("workers") or {}).items()
                   if isinstance(r, dict)}
        stale = {w for w, r in workers.items()
                 if now - float(r.get("heartbeat", 0) or 0)
                 > _WORKER_TTL_S}
        unreachable = (set(self.health.snap.get("errors") or ())
                       - {"__store__"})
        return float(len(stale | (unreachable & set(workers))))

    # ------------------------------------------------------------ beat
    def beat(self, now: Optional[float] = None):
        """Refresh the federated scrape and run one forced evaluation
        (the caller owns the cadence); returns the transitions."""
        self.health.refresh()
        return self.tower.beat(now, force=True)

    def snapshot(self) -> dict:
        return self.tower.snapshot()


#: published per-worker alert records older than this are pruned from
#: the store doc — a long-dead worker must not haunt /debug/alerts
_ALERTS_STALE_S = 600.0


def publish_alerts(store, worker_id: str, term, local: dict,
                   fleet: Optional[dict] = None,
                   is_leader: bool = False) -> None:
    """This worker's alert snapshot — and, on the LEADER, the
    fleet-level snapshot — into the shared store's ``alerts`` doc, the
    rollup every surface's ``/debug/alerts`` shows."""
    at = time.time()
    mine = {"at": at, "state": "ok" if not local.get("firing")
            else "firing",
            "firing": local.get("firing") or [],
            "pending": local.get("pending") or [],
            "resolved": local.get("resolved") or []}

    def mutate(doc):
        alerts = doc.get("alerts")
        if not isinstance(alerts, dict):
            alerts = {}
        workers = alerts.get("workers")
        if not isinstance(workers, dict):
            workers = {}
        workers[worker_id] = mine
        alerts["workers"] = {
            w: r for w, r in workers.items()
            if isinstance(r, dict)
            and at - float(r.get("at", 0) or 0) <= _ALERTS_STALE_S}
        if is_leader and fleet is not None:
            alerts["fleet"] = {"at": at, "by": worker_id, "term": term,
                               "firing": fleet.get("firing") or [],
                               "pending": fleet.get("pending") or [],
                               "resolved": fleet.get("resolved") or []}
        doc["alerts"] = alerts
    store.update(mutate)


def handle_alerts_route(path: str, query: Dict[str, list],
                        store=None, local_worker: str = "local",
                        fleet: bool = False) -> Tuple[int, object]:
    """Shared ``/debug/alerts`` (and legacy ``/alerts``) routing for all
    three HTTP surfaces: ``(status, json_payload)``.

    The payload keeps the legacy SLO-engine keys (``status`` /
    ``active`` / ``history`` — old consumers of ``GET /alerts`` still
    parse) and adds the watchtower's lifecycle view; fleet surfaces add
    the store rollup (leader's fleet alerts + per-worker snapshots),
    the incident ledger, and an honest ``partial`` list naming live-
    registered workers whose alerts are unknown — never a 500 because
    a worker died.  With ``DL4J_TPU_WATCHTOWER=0`` the legacy path
    answers the pre-watchtower payload byte-identically and the new
    path 404s."""
    p = path.rstrip("/")
    if not watchtower_enabled():
        if p == "/alerts":
            return 200, global_slo_engine().alerts()
        return 404, {"error": "NotFound", "path": path}
    wt = global_watchtower()
    wt.beat()           # throttled internally — the answer is current
    payload = global_slo_engine().alerts()
    payload["worker"] = local_worker
    payload["watchtower"] = wt.snapshot()
    if not (fleet and store is not None and fleet_obs_enabled()):
        return 200, payload
    try:
        doc = store.read()
    # graftlint: disable=typed-errors — a torn store read degrades to
    # the local view; the alerts surface never 500s
    except Exception as e:
        payload["store_error"] = repr(e)
        doc = {}
    fleet_alerts = doc.get("alerts")
    if not isinstance(fleet_alerts, dict):
        fleet_alerts = {}
    workers = fleet_alerts.get("workers")
    payload["workers"] = workers if isinstance(workers, dict) else {}
    payload["fleet"] = fleet_alerts.get("fleet")
    now = time.time()
    partial = []
    for wid, rec in sorted((doc.get("workers") or {}).items()):
        if not isinstance(rec, dict):
            continue
        if now - float(rec.get("heartbeat", 0) or 0) > _WORKER_TTL_S:
            partial.append(wid)          # dead: its alerts are unknown
        elif wid not in payload["workers"]:
            partial.append(wid)          # live but not yet published
    payload["partial"] = partial
    payload["incidents"] = [i for i in (doc.get("incidents") or [])
                            if isinstance(i, dict)]
    return 200, payload


# ------------------------------------------------------ incident capture

def post_incident(store, worker_id: str, reason: str,
                  bundle: Optional[str],
                  trace_id: Optional[str] = None,
                  trace_ids: Optional[List[str]] = None) -> str:
    """Record a tripped flight recorder in the shared store: the record
    carries the trace id of the request that was live when it tripped
    (plus any watchtower-pinned evidence ids), the originating worker's
    bundle name, and a fresh incident id the leader will fan out so
    every peer captures under the SAME id.

    Watchtower dedup: two ``alert:<rule>`` incidents posted inside the
    alert cooldown window coalesce onto ONE incident id — two detectors
    paging on the same outage must yield one fleet-wide capture, not
    two dump storms."""
    inc_id = os.urandom(6).hex()
    name = os.path.basename(bundle) if bundle else None
    evidence = [t for t in (trace_ids or ()) if t]
    rec = {"id": inc_id, "worker": worker_id, "reason": str(reason),
           "bundle": name, "trace_id": trace_id,
           "trace_ids": evidence, "at": time.time(),
           "fanned_out": False,
           "captured": ({worker_id: name} if name else {})}
    coalesce = str(reason).startswith("alert:")
    out = {"id": inc_id}

    def mutate(doc):
        incidents = [i for i in (doc.get("incidents") or [])
                     if isinstance(i, dict)]
        if coalesce:
            window = incident_cooldown_s()
            now = time.time()
            for i in reversed(incidents):
                if (str(i.get("reason", "")).startswith("alert:")
                        and now - float(i.get("at", 0) or 0) <= window):
                    # same outage: fold this page onto the open incident
                    if name:
                        captured = dict(i.get("captured") or {})
                        captured.setdefault(worker_id, name)
                        i["captured"] = captured
                    merged = list(i.get("trace_ids") or [])
                    merged.extend(t for t in evidence
                                  if t not in merged)
                    i["trace_ids"] = merged[:32]
                    also = list(i.get("coalesced") or [])
                    if str(reason) != i.get("reason") \
                            and str(reason) not in also:
                        also.append(str(reason))
                        i["coalesced"] = also
                    out["id"] = i["id"]
                    doc["incidents"] = incidents[-_INCIDENT_CAP:]
                    return
        incidents.append(rec)
        out["id"] = inc_id
        doc["incidents"] = incidents[-_INCIDENT_CAP:]
    store.update(mutate)
    return out["id"]


def incident_beat(store, worker_id: str, is_leader: bool,
                  recorder=None) -> List[str]:
    """One beat of the coordinated-capture protocol (called from every
    worker's sync loop): the leader marks fresh incidents fanned-out;
    every worker that sees a fanned incident it hasn't captured dumps
    its OWN bundle with ``reason="incident:<id>"`` (stamping
    ``incident.json``) and records the bundle name in the incident's
    ``captured`` map.  Returns the bundle paths dumped this beat."""
    if not fleet_obs_enabled():
        return []
    doc = store.read()
    incidents = [i for i in (doc.get("incidents") or [])
                 if isinstance(i, dict)]
    if not incidents:
        return []
    if is_leader and any(not i.get("fanned_out") for i in incidents):
        def fan(d):
            for i in (d.get("incidents") or []):
                if isinstance(i, dict) and not i.get("fanned_out"):
                    i["fanned_out"] = True
        doc = store.update(fan)
        incidents = [i for i in (doc.get("incidents") or [])
                     if isinstance(i, dict)]
    now = time.time()
    todo = [i for i in incidents
            if i.get("fanned_out") and i.get("id")
            and worker_id not in (i.get("captured") or {})
            and now - float(i.get("at", 0) or 0) <= _INCIDENT_FRESH_S]
    if not todo:
        return []
    if recorder is None:
        from deeplearning4j_tpu_torch.observability.flight_recorder import (
            global_flight_recorder)
        recorder = global_flight_recorder()
    dumped: List[str] = []
    for inc in todo:
        if trace_store_enabled():
            # the originating request's trace + everything completing
            # around the incident are evidence on THIS worker too
            st = global_trace_store()
            st.pin(parse_trace_id(inc.get("trace_id")))
            st.open_incident_window()
        # dump OUTSIDE any store transaction (bundles take real time);
        # the publisher hook skips incident-reason dumps, so the peer
        # capture can never re-post and ping-pong the fleet
        bundle = recorder.dump(f"incident:{inc['id']}")
        dumped.append(bundle)
        name = os.path.basename(bundle)

        def mark(d, _id=inc["id"], _name=name):
            for i in (d.get("incidents") or []):
                if isinstance(i, dict) and i.get("id") == _id:
                    captured = dict(i.get("captured") or {})
                    captured[worker_id] = _name
                    i["captured"] = captured
        store.update(mark)
    return dumped


def install_incident_publisher(store, worker_id: str) -> None:
    """Wire the flight recorder's dump hook to :func:`post_incident`:
    any non-incident-reason bundle on this worker becomes a shared
    incident record the leader fans out.  Live kill switch: with
    ``DL4J_TPU_FLEET_OBS=0`` the hook is inert."""
    from deeplearning4j_tpu_torch.observability import flight_recorder as _fr

    def _publish(reason: str, bundle: str) -> None:
        if not fleet_obs_enabled():
            return
        if str(reason).startswith("incident"):
            return                       # peer capture: never re-post
        ctx = current_context()
        trace_ids = None
        if ctx is not None and trace_store_enabled():
            # the live request's trace is evidence: eviction-exempt,
            # and everything completing around the trip is kept too
            st = global_trace_store()
            st.pin(parse_trace_id(ctx.trace_id))
            st.open_incident_window()
        if trace_store_enabled() and str(reason).startswith("alert:"):
            # a watchtower page has no live request context — its
            # evidence is the offending traces it pinned before dumping
            trace_ids = global_trace_store().pinned_ids()[-8:]
        try:
            post_incident(store, worker_id, reason, bundle,
                          trace_id=ctx.trace_id if ctx else None,
                          trace_ids=trace_ids)
        except Exception:
            pass        # the store being down must never mask the dump
    _fr.set_incident_publisher(_publish)

    def _assemble(tid: str) -> Optional[dict]:
        # fleet-wide assembly for the bundle's traces.json: with the
        # fleet plane off (or a single process) the recorder falls back
        # to the local store's payload
        if not (fleet_obs_enabled() and trace_store_enabled()):
            return None
        local = global_trace_store().get(tid)
        return assemble_trace(store, tid, local_payload=local,
                              local_worker=worker_id)
    _fr.set_trace_assembler(_assemble)


# ------------------------------------------------------ proxy admin port

class FleetAdminServer:
    """The proxy's observability surface (satellite: the proxy exposed
    no metrics at all): plain ``/metrics`` for its own registry,
    ``/metrics/fleet`` / ``/health/fleet`` / ``/alerts/fleet`` for the
    federated view, and ``/debug/proxy`` (failover/breaker snapshot +
    recent ``proxy_request`` spans).  Same dependency-free
    ``ThreadingHTTPServer`` pattern as the front door."""

    def __init__(self, store, host: Optional[str] = None, port: int = 0,
                 local_worker: str = "proxy",
                 debug_extra: Optional[Callable[[], dict]] = None):
        self.store = store
        self.local_worker = local_worker
        self._extra = debug_extra
        self.health = FleetHealth(store, worker_id=local_worker)
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, payload: dict):
                self._send(code,
                           json.dumps(payload, default=str).encode(),
                           "application/json")

            def do_GET(self):
                path = urlparse(self.path).path
                try:
                    if path == "/metrics":
                        self._send(
                            200,
                            global_registry().render_prometheus().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/metrics/fleet":
                        self._send(
                            200,
                            render_fleet(srv.store,
                                         srv.local_worker).encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/health/fleet":
                        report = srv.health.evaluate()
                        self._json(
                            503 if report["status"] == FAILING else 200,
                            report)
                    elif path == "/alerts/fleet":
                        self._json(200, srv.health.alerts())
                    elif (path == "/debug/alerts"
                            and watchtower_enabled()):
                        q = parse_qs(urlparse(self.path).query)
                        code, payload = handle_alerts_route(
                            path, q, srv.store, srv.local_worker,
                            fleet=True)
                        self._json(code, payload)
                    elif (path == "/debug/timeseries"
                            and watchtower_enabled()):
                        q = parse_qs(urlparse(self.path).query)
                        self._json(200, timeseries_payload(
                            q, local_worker=srv.local_worker))
                    elif path == "/debug/proxy":
                        self._json(200, srv.debug_snapshot())
                    elif (path.startswith("/debug/trace")
                            and trace_store_enabled()):
                        q = parse_qs(urlparse(self.path).query)
                        code, payload = handle_trace_route(
                            path, q, srv.store, srv.local_worker,
                            fleet=True)
                        self._json(code, payload)
                    else:
                        self._json(404, {"error": "NotFound",
                                         "path": path})
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:
                    # never a 500-with-traceback page: the admin port is
                    # scraped by machines
                    try:
                        self._json(500, {"error": repr(e)})
                    except OSError:
                        pass

        if host is None:
            from deeplearning4j_tpu_torch.serving.frontdoor import (
                default_bind_host)
            host = default_bind_host()
        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FleetAdminServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="dl4j-fleet-admin")
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def get_address(self) -> str:
        host = self.host or "127.0.0.1"
        if host == "0.0.0.0":
            host = "127.0.0.1"
        return f"http://{host}:{self.port}"

    def debug_snapshot(self) -> dict:
        extra: dict = {}
        if self._extra is not None:
            try:
                extra = dict(self._extra() or {})
            except Exception as e:
                extra = {"error": repr(e)}
        spans = [
            {"trace_id": r.trace_id, "span_id": r.span_id,
             "dur_us": r.dur_us, "error": r.error,
             "attrs": dict(r.attrs or {})}
            for r in global_trace_sink().spans()
            if r.name == "proxy_request"][-32:]
        return {"worker": self.local_worker, "proxy": extra,
                "recent_proxy_spans": spans}
