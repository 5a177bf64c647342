"""The port's timeseries, watchtower and federation modules against the
JAX package's, and the flight recorder's serving-plane sections.

Each package's registry is filled with the same contents, step by step
under one fake clock: the timeseries rings, their deltas and rates, the
watchtower's detector results and alert lifecycle (a 5xx burst pages the
burn-rate detector, a queue-depth threshold warns, both resolve), and the
federation helpers (Prometheus merge and parse, cardinality folding,
bucket quantiles) give the same values. A fleet of two in-process doors
on one shared store gives the same federated health rollup and the same
``/metrics/fleet`` series names in both packages. The bundle's
``deploy.json``, ``frontdoor.json``, ``fleet.json`` and ``timeseries.json``
have the reference's keys.
"""
import json
import os

import pytest

from _torch_serving import (BOTH, engine, get, http_call, reset_all,
                            teardown_all)

import deeplearning4j_tpu.observability.federation as j_fed
import deeplearning4j_tpu.observability.flight_recorder as j_fr
import deeplearning4j_tpu.observability.timeseries as j_tms
import deeplearning4j_tpu.observability.watchtower as j_wt
import deeplearning4j_tpu_torch.observability.federation as t_fed
import deeplearning4j_tpu_torch.observability.flight_recorder as t_fr
import deeplearning4j_tpu_torch.observability.timeseries as t_tms
import deeplearning4j_tpu_torch.observability.watchtower as t_wt

MODS = {"jax": (j_tms, j_wt, j_fed, j_fr), "torch": (t_tms, t_wt, t_fed,
                                                     t_fr)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TPU_POSTMORTEM_DIR", str(tmp_path / "pm"))
    reset_all()
    for pkg in BOTH:
        pkg.obs.reset_global_timeseries()
        pkg.obs.reset_global_watchtower()
    yield
    teardown_all()


def _fill(pkg, i):
    """Step ``i`` of the scripted registry contents."""
    reg = pkg.obs.global_registry()
    req = reg.counter("dl4j_http_requests_total", "requests",
                      ("route", "code"))
    lat = reg.histogram("dl4j_http_latency_seconds", "latency", ("route",))
    depth = reg.gauge("dl4j_decode_queue_depth", "queued")
    req.labels(route="generate", code="200").inc(20)
    if 10 <= i < 18:                       # a mid-run 5xx burst
        req.labels(route="generate", code="503").inc(30)
    lat.labels(route="generate").observe(0.01 * (1 + i % 5))
    depth.set(40.0 if 20 <= i < 24 else 2.0)


def _script(pkg, monkeypatch):
    tms, wt, _fed, _fr = MODS[pkg.name]
    monkeypatch.setenv("DL4J_TPU_WATCHTOWER_HOLD_S", "1.0")
    monkeypatch.setenv("DL4J_TPU_WATCHTOWER_CLEAR_S", "2.0")
    store = tms.TimeseriesStore(maxlen=32)
    tower = wt.Watchtower(detectors=[
        wt.BurnRateDetector("watch_http_error_burn", fast_s=5.0,
                            slow_s=20.0, min_requests=10.0),
        wt.ThresholdDetector(
            "watch_queue_depth_high",
            lambda now: store.latest("dl4j_decode_queue_depth"),
            firing_above=30.0, severity=wt.WARN),
    ], scrape=False)
    out = []
    for i in range(36):
        now = 1000.0 + i
        _fill(pkg, i)
        store.scrape(now=now)
        trans = tower.beat(now=now, force=True)
        out.append(([(t["rule"], t["to"]) for t in trans],
                    [a["rule"] for a in tower.alerts.firing()],
                    store.latest("dl4j_http_requests_total"),
                    store.delta("dl4j_http_requests_total", 5.0, now=now),
                    store.rate("dl4j_http_requests_total", 10.0, now=now),
                    store.latest("dl4j_http_latency_seconds:count")))
    # the script's own series: other threads of the process may publish
    # into the same registry while it runs
    snap = store.snapshot(names=["dl4j_http_", "dl4j_decode_queue_depth",
                                 "dl4j_alerts_total"])
    alerts = tower.alerts.snapshot()
    return out, snap, alerts, tower.last_incident_reason


def test_timeseries_and_alerts_match_the_reference(monkeypatch):
    runs = {pkg.name: _script(pkg, monkeypatch) for pkg in BOTH}
    assert runs["torch"] == runs["jax"]
    trail, snap, alerts, incident = runs["torch"]
    fired = [t for step in trail for t in step[0]]
    assert ("watch_http_error_burn", "firing") in fired
    assert ("watch_http_error_burn", "resolved") in fired
    assert ("watch_queue_depth_high", "firing") in fired
    assert incident == "alert:watch_http_error_burn"
    assert alerts["firing"] == []
    assert set(snap["series"]) >= {"dl4j_http_requests_total",
                                   "dl4j_decode_queue_depth"}


def test_federation_helpers_match_the_reference(monkeypatch):
    w0 = ("# HELP dl4j_http_requests_total req\n"
          "# TYPE dl4j_http_requests_total counter\n"
          'dl4j_http_requests_total{code="200",route="generate"} 5\n'
          'dl4j_fleet_scrape_errors_total{worker="w9"} 2\n')
    w1 = ("# HELP dl4j_http_requests_total other help\n"
          "# TYPE dl4j_http_requests_total counter\n"
          'dl4j_http_requests_total{code="200",route="generate"} 7\n')
    monkeypatch.setenv("DL4J_TPU_FLEET_WORKER_TOP_N", "1")
    got = {}
    for name, (_tms, _wt, fed, _fr) in MODS.items():
        merged = fed.merge_prometheus([("w0", w0), ("w1", w1)])
        fold = fed.fold_workers(["w1", "w0", "w2"])
        folded = fed.merge_prometheus([(fold[w], w0)
                                       for w in ("w0", "w1", "w2")])
        got[name] = (merged, fed.parse_prometheus(merged), fold, folded,
                     fed._bucket_quantile({0.1: 50.0, 1.0: 90.0,
                                           float("inf"): 100.0}, 0.5),
                     fed._bucket_quantile({0.1: 50.0, 1.0: 90.0,
                                           float("inf"): 100.0}, 0.99),
                     fed.parse_trace_id("ABCDEF0123456789"),
                     fed.parse_trace_id("not-hex"))
    assert got["torch"] == got["jax"]
    assert ('dl4j_http_requests_total{code="200",route="generate",'
            'worker="w1"} 7') in got["torch"][0]


def _fleet(pkg, root):
    """Two doors (w0, w1) of ``pkg`` on one store; returns (store,
    [(reg, fd)])."""
    store = pkg.shared.SharedStore(str(root / pkg.name))
    made = []
    for wid in ("w0", "w1"):
        reg = pkg.registry.ModelRegistry()
        made.append((reg, None))
        reg.deploy_generative("g1", engine(pkg), slots=2, max_new_tokens=4)
        shared = pkg.shared.SharedServingState(store, wid)
        shared.ensure_lane("generative", "g1")
        fd = pkg.frontdoor.FrontDoor(
            gen_router=pkg.router.ServingRouter(reg, "g1"), shared=shared,
            port=0).start()
        made[-1] = (reg, fd)
        shared.register(os.getpid(), fd.port)
        fd.sync_once()
    return store, made


def test_two_worker_federated_rollup_matches_the_reference(tmp_path):
    got = {}
    for pkg in BOTH:
        _tms, _wt, fed, _fr = MODS[pkg.name]
        store, made = _fleet(pkg, tmp_path)
        try:
            for _reg, fd in made:
                code, body, _h = http_call(fd.get_address(), "/v1/generate",
                                      {"prompt": [1, 2, 3],
                                       "max_new_tokens": 4})
                assert code == 200, body
            report = fed.FleetHealth(store, worker_id="probe").evaluate()
            text = fed.render_fleet(store, local_worker="probe")
            names = sorted({ln.split("{")[0] for ln in text.splitlines()
                            if ln.startswith("dl4j_http_requests_total")})
            workers = sorted({ln.split('worker="')[1].split('"')[0]
                              for ln in text.splitlines()
                              if ln.startswith("dl4j_http_requests_total")
                              and 'worker="' in ln})
            code, health = get(made[0][1].get_address(), "/health/fleet")
            got[pkg.name] = (report["status"], report["workers_scraped"],
                             sorted(r["rule"] for r in report["rules"]),
                             [r["status"] for r in report["rules"]],
                             names, workers, code, sorted(health))
        finally:
            for reg, fd in made:
                if fd is not None:
                    fd.stop()
                reg.shutdown()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "ok" and got["torch"][1] == ["w0", "w1"]
    assert got["torch"][5] == ["probe", "w0", "w1"]


def test_bundle_serving_sections_have_the_reference_keys(tmp_path):
    """deploy.json, frontdoor.json, fleet.json and timeseries.json of a
    bundle dumped while a shared door serves: the same files, and in each
    the same top-level keys, in both packages."""
    got = {}
    for pkg in BOTH:
        _tms, _wt, _fed, fr = MODS[pkg.name]
        store, made = _fleet(pkg, tmp_path)
        try:
            http_call(made[0][1].get_address(), "/v1/generate",
                 {"prompt": [4, 2], "max_new_tokens": 2})
            pkg.obs.global_timeseries().scrape()
            bundle = fr.FlightRecorder().dump("test")
            files = sorted(os.listdir(bundle))
            keys = {}
            for name in ("deploy.json", "frontdoor.json", "fleet.json",
                         "timeseries.json"):
                with open(os.path.join(bundle, name)) as f:
                    doc = json.load(f)
                keys[name] = sorted(doc)
            keys["deploy.json/registries"] = sorted(
                json.load(open(os.path.join(bundle, "deploy.json")))
                ["registries"][0])
            got[pkg.name] = (files, keys)
        finally:
            for reg, fd in made:
                if fd is not None:
                    fd.stop()
                reg.shutdown()
    jfiles, tfiles = got["jax"][0], got["torch"][0]
    # the port leaves out elastic.json (the elastic layer is not ported)
    assert set(jfiles) - set(tfiles) <= {"elastic.json"}
    assert set(tfiles) - set(jfiles) == set()
    assert {"deploy.json", "frontdoor.json", "fleet.json",
            "timeseries.json"} <= set(tfiles)
    assert got["torch"][1] == got["jax"][1]
