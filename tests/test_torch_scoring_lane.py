"""The port's scoring lane — ``ModelRegistry.deploy`` with its bucket
warm-up, ``ServingRouter.output`` with the hash split, shadow scoring and
the canary, ``FrontDoor``'s ``POST /v1/classify`` — against the JAX
package's.

Both packages deploy the same small nets (the port carrying the JAX
weights): the deploys warm the same buckets, note the same
``serving_warmup`` first runs and snapshot alike (times aside); each
bucket's analytic FLOPs sit within PERF.md's band of the reference's XLA
``cost_analysis``; the same request keys land on the same versions;
shadow comparisons match or diverge alike; real requests walk a canary
to full, and one under the ``serving.canary`` chaos point back, through
the same stages; the door answers the same statuses and bodies (200 with
probabilities within atol 1e-6, 400, 404, 409, 413, 429, 503, 504) and
replays an idempotent request without running it.
"""
import http.client
import urllib.error
import urllib.request

import numpy as np
import pytest

from chip_smoke import http_call
from _torch_scoring import (BOTH, JAX, TIMEOUT_S, TORCH, direct, inputs,
                            net_of, pair, reset_all, series, teardown_all)

#: classify probabilities over the wire, port against reference: JSON is
#: exact, so f32's own agreement of the two forwards
PROB_ATOL = 1e-6
#: a bucket's analytic FLOPs against XLA's cost_analysis (PERF.md)
FLOPS_BAND = (0.9, 1.15)


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    teardown_all()


_NETS = {}


def nets(kind, seed=None):
    key = (kind, seed)
    if key not in _NETS:
        _NETS[key] = pair(kind, seed=seed)
    return _NETS[key]


def _deploy(pkg, reg, version, kind="demo", seed=None, **kw):
    net = net_of(pkg, nets(kind, seed))
    kw = {"batch_limit": 4, "max_wait_ms": 1.0, **kw}
    return reg.deploy(version, net, sample_input=inputs(kind, 1), **kw)


def _versions(reg):
    return [{k: v for k, v in dv.items()
             if k not in ("deployed_at", "warmup_seconds")}
            for dv in reg.snapshot()["versions"]]


# ------------------------------------------------------------- registry
def test_deploy_warms_serves_and_retires_like_the_reference():
    seen = {}
    x = inputs("demo", 3, seed=1)
    for pkg in BOTH:
        reg = pkg.registry.ModelRegistry()
        try:
            dv = _deploy(pkg, reg, "v1")
            assert dv.kind == "scoring" and dv.state == "live"
            assert dv.warmup_seconds is not None and dv.pi is not None
            router = pkg.router.ServingRouter(reg, "v1")
            out = router.output(x)
            live = _versions(reg)
            buckets = series(pkg, "dl4j_inference_bucket_total")
            drained = reg.retire("v1")
            seen[pkg.name] = (out, live, list(dv.warmed_buckets), buckets,
                              drained, dv.state, dv.pi, reg.versions())
        finally:
            reg.shutdown()
    t, j = seen["torch"], seen["jax"]
    np.testing.assert_allclose(t[0], j[0], atol=PROB_ATOL)
    assert t[1:] == j[1:]
    assert t[2] == [1, 2, 4]
    # the first real batch hits a warmed bucket
    assert t[3] == {("hit",): 1.0, ("miss",): 0.0}


def test_warmup_is_noted_in_compile_watch_as_serving_warmup():
    seen = {}
    for pkg in BOTH:
        j, t = pair("lenet", seed=21)       # a net no other test served
        watch = pkg.obs.global_compile_watch()
        watch.clear()
        reg = pkg.registry.ModelRegistry()
        try:
            reg.deploy("w1", net_of(pkg, (j, t)),
                       sample_input=inputs("lenet", 1), batch_limit=8)
            reg.get("w1").pi.output(inputs("lenet", 3))
        finally:
            reg.shutdown()
        seen[pkg.name] = [(e["fn"], e["cause"]) for e in watch.events()
                          if e["fn"].endswith("_output_jit")]
    assert seen["torch"] == seen["jax"]
    assert [c["cause"] for _fn, c in seen["torch"]] == ["serving_warmup"] * 4


@pytest.mark.parametrize("kind", ["lenet", "residual"])
def test_bucket_flops_hold_the_reference_cost_analysis(kind):
    flops = {}
    for pkg in BOTH:
        net = net_of(pkg, nets(kind))
        reg = pkg.registry.ModelRegistry()
        try:
            reg.deploy("f1", net, sample_input=inputs(kind, 1),
                       batch_limit=8)
        finally:
            reg.shutdown()
        cm = pkg.cost.global_cost_model()
        flops[pkg.name] = [cm.flops_for(pkg.cost.bucket_fn(net, b))
                           for b in (1, 2, 4, 8)]
    assert TORCH.cost.bucket_fn(nets(kind)[1], 8) == \
        JAX.cost.bucket_fn(nets(kind)[0], 8)
    for t, j in zip(flops["torch"], flops["jax"]):
        assert j > 0 and FLOPS_BAND[0] <= t / j <= FLOPS_BAND[1], (t, j)


# --------------------------------------------------------------- router
def _policy(pkg, **kw):
    base = dict(start_stage="canary", canary_fraction=0.5,
                ramp_fractions=(0.75,), window_requests=10 ** 6,
                healthy_windows=1, min_requests=3, min_shadow=1,
                latency_ratio_degraded=None, latency_ratio_failing=None,
                drain_timeout_s=TIMEOUT_S)
    base.update(kw)
    return pkg.rollout.RolloutPolicy(**base)


def test_the_hash_split_routes_each_key_as_the_reference():
    """v1 and v2 hold different weights, so each answer names the version
    that served it: the same keys land on the same versions."""
    x = inputs("demo", 1, seed=2)
    seen = {}
    for pkg in BOTH:
        reg = pkg.registry.ModelRegistry()
        try:
            _deploy(pkg, reg, "v1", seed=1)
            _deploy(pkg, reg, "v2", seed=2)
            router = pkg.router.ServingRouter(reg, "v1")
            router.begin_rollout("v2", _policy(pkg))
            want = {v: direct(pkg, reg.get(v).net, x) for v in ("v1", "v2")}
            served = []
            for key in range(24):
                out = router.output(x, request_key=key)
                served.append(min(want, key=lambda v: float(
                    np.abs(want[v] - out).max())))
            seen[pkg.name] = served
        finally:
            reg.shutdown()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == [
        "v2" if TORCH.router.request_fraction(x, k) < 0.5 else "v1"
        for k in range(24)]


@pytest.mark.parametrize("seed, outcome", [(1, "match"), (2, "diverged")])
def test_shadow_scores_as_the_reference(seed, outcome):
    x = inputs("demo", 2, seed=3)
    seen = {}
    for pkg in BOTH:
        reg = pkg.registry.ModelRegistry()
        try:
            _deploy(pkg, reg, "v1", seed=1)
            _deploy(pkg, reg, f"s{seed}", seed=seed)
            router = pkg.router.ServingRouter(reg, "v1")
            router.begin_rollout(f"s{seed}", _policy(
                pkg, start_stage="shadow", shadow_fraction=1.0))
            for k in range(5):
                router.output(x, request_key=k)
            seen[pkg.name] = series(pkg, "dl4j_serving_shadow_total")
        finally:
            reg.shutdown()
    assert seen["torch"] == seen["jax"] == {(f"s{seed}", outcome): 5.0}


def _walk(pkg, candidate_seed, chaos):
    x = inputs("demo", 1, seed=4)
    reg = pkg.registry.ModelRegistry()
    try:
        _deploy(pkg, reg, "v1", seed=1)
        _deploy(pkg, reg, "v2", seed=candidate_seed)
        router = pkg.router.ServingRouter(reg, "v1")
        ro = router.begin_rollout("v2", _policy(
            pkg, start_stage="shadow", shadow_fraction=1.0,
            window_requests=3, min_requests=3, min_shadow=2))
        outcomes = []
        plan = pkg.faults.FaultPlan(
            [pkg.faults.FaultSpec("serving.canary", "error", rate=1.0)])
        if chaos:
            pkg.faults.install(plan)
        try:
            for key in range(40):
                if not ro.active:
                    break
                try:
                    router.output(x, request_key=key)
                    outcomes.append("ok")
                except Exception as e:
                    outcomes.append(type(e).__name__)
        finally:
            pkg.faults.clear()
        snap = router.snapshot()
        return ([(h["from"], h["to"], h["share"])
                 for h in snap["rollout"]["history"]],
                snap["primary"], outcomes,
                "v1" in reg.live_versions())
    finally:
        reg.shutdown()


@pytest.mark.parametrize("chaos", [False, True], ids=["healthy", "chaos"])
def test_canary_walks_like_the_reference(chaos):
    runs = {pkg.name: _walk(pkg, 1, chaos) for pkg in BOTH}
    assert runs["torch"] == runs["jax"]
    history, primary, outcomes, v1_live = runs["torch"]
    assert set(outcomes) == {"ok"}          # no user request failed
    if chaos:
        assert history[-1][1] == "rolled_back" and primary == "v1"
    else:
        assert history[-1][1] == "full" and primary == "v2"


# ------------------------------------------------------------ the door
def _statuses(pkg, x):
    reg = pkg.registry.ModelRegistry()
    fds = []
    try:
        _deploy(pkg, reg, "v1", seed=1)
        router = pkg.router.ServingRouter(reg, "v1")
        fd = pkg.frontdoor.FrontDoor(router, port=0).start()
        fds.append(fd)
        addr = fd.get_address()
        out, bodies = [], {}

        def note(label, code, body, headers):
            assert headers.get("X-Dl4j-Trace-Id"), (pkg.name, label)
            out.append((label, code, body.get("error")))
            bodies[label] = body

        note("ok", *http_call(addr, "/v1/classify",
                              {"inputs": x.tolist(), "request_key": 7}))
        try:
            urllib.request.urlopen(urllib.request.Request(
                addr + "/v1/classify", data=b"not json"), timeout=TIMEOUT_S)
        except urllib.error.HTTPError as e:
            out.append(("malformed", e.code, None))
        note("missing", *http_call(addr, "/v1/classify", {"nope": 1}))
        note("route", *http_call(addr, "/v1/nope", {}))
        note("no_generative", *http_call(addr, "/v1/generate",
                                         {"prompt": [1, 2]}))
        _deploy(pkg, reg, "v2", seed=1)
        note("rollout", *http_call(addr, "/admin/rollout",
                                   {"lane": "scoring", "candidate": "v2",
                                    "policy": {"start_stage": "shadow"}}))
        note("second_rollout", *http_call(addr, "/admin/rollout",
                                          {"lane": "scoring",
                                           "candidate": "v2"}))
        note("rollback", *http_call(addr, "/admin/rollback",
                                    {"lane": "scoring", "reason": "test"}))
        conn = http.client.HTTPConnection("127.0.0.1", fd.port,
                                          timeout=TIMEOUT_S)
        try:
            conn.putrequest("POST", "/v1/classify")
            conn.putheader("Content-Length", str(10 ** 10))
            conn.endheaders()
            out.append(("too_large", conn.getresponse().status, None))
        finally:
            conn.close()
        note("deadline", *http_call(addr, "/v1/classify",
                                    {"inputs": x.tolist(),
                                     "deadline_ms": 1e-6}))
        busy = pkg.frontdoor.FrontDoor(router, port=0,
                                       max_inflight=0).start()
        fds.append(busy)
        note("inflight_full", *http_call(busy.get_address(), "/v1/classify",
                                         {"inputs": x.tolist()}))
        # an idempotent retry replays the original's body and runs nothing
        hdr = {pkg.idem.IDEMPOTENCY_HEADER: "key-1"}
        note("idem_first", *http_call(addr, "/v1/classify",
                                      {"inputs": x.tolist()}, headers=hdr))
        before = series(pkg, "dl4j_inference_requests_total")
        note("idem_replay", *http_call(addr, "/v1/classify",
                                       {"inputs": x.tolist()}, headers=hdr))
        ran = series(pkg, "dl4j_inference_requests_total") != before
        reg.retire("v1")
        note("retired", *http_call(addr, "/v1/classify",
                                   {"inputs": x.tolist()}))
        return out, bodies, ran
    finally:
        for fd in fds:
            fd.stop()
        reg.shutdown()


def test_classify_statuses_bodies_and_replays_equal_the_reference():
    x = inputs("demo", 3, seed=5)
    got = {pkg.name: _statuses(pkg, x) for pkg in BOTH}
    (t_out, t_bodies, t_ran), (j_out, j_bodies, j_ran) = (got["torch"],
                                                          got["jax"])
    assert t_out == j_out
    assert [c for _l, c, _e in t_out] == [
        200, 400, 400, 404, 404, 200, 409, 200, 413, 504, 429, 200, 200,
        503]
    np.testing.assert_allclose(np.asarray(t_bodies["ok"]["outputs"]),
                               np.asarray(j_bodies["ok"]["outputs"]),
                               atol=PROB_ATOL)
    assert t_bodies["idem_replay"] == t_bodies["idem_first"]
    assert not t_ran and not j_ran
    for label in ("missing", "deadline", "inflight_full", "retired"):
        assert set(t_bodies[label]) == set(j_bodies[label]), label


def test_demo_fleet_deploys_score_on_the_cpu():
    """``tools.serve``'s demo deploys: the scoring ``v1``/``v2`` (equal
    nets) and the generative ``g1``, each warmed; both scoring versions
    answer the demo net's probabilities."""
    from deeplearning4j_tpu_torch.tools import serve
    reg, router, gen_router = serve._build_demo(2, device="cpu")
    try:
        assert reg.live_versions() == ["g1", "v1", "v2"]
        x = inputs("demo", 3, seed=6)
        want = serve.demo_scoring_net("cpu").output(x).numpy()
        np.testing.assert_array_equal(router.output(x), want)
        np.testing.assert_array_equal(router.output_on("v2", x), want)
        assert gen_router.snapshot()["primary"] == "g1"
    finally:
        reg.shutdown()
