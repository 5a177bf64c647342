"""The port's registry, canary rollout and router against the JAX package's.

Both packages deploy the same tiny f32 ``TransformerLM`` (weights from
``from_jax_params``) through ``ModelRegistry.deploy_generative``: the
lifecycles (deploy, warm-up, duplicate refusal, drain on retire, redeploy
after a failed warm-up) and the snapshots agree, apart from times and the
port's ``compile_cache_dir`` (always ``None``: it has no compile cache).
The canary state machine is driven by the same per-version SLO windows
under a fake clock in both packages and must take the same transitions
and give the same ``snapshot()``; a rollout routed through real
generations walks to ``full`` the same way; the router's hash split
(``request_fraction``) is identical. Greedy tokens are held exact.
"""
import threading

import numpy as np
import pytest

from _torch_serving import (BOTH, JAX, TIMEOUT_S, TORCH, engine, greedy,
                            prompt, reset_all, teardown_all)


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    teardown_all()


def _snap_versions(reg):
    """Registry snapshot without the wall-clock fields."""
    snap = reg.snapshot()
    vs = [{k: v for k, v in dv.items()
           if k not in ("deployed_at", "warmup_seconds")}
          for dv in snap["versions"]]
    return vs, snap["compile_cache_dir"]


# ------------------------------------------------------------- registry
def test_deploy_generative_warms_serves_and_retires_like_the_reference():
    seen = {}
    for pkg in BOTH:
        reg = pkg.registry.ModelRegistry()
        try:
            dv = reg.deploy_generative("g1", engine(pkg), slots=2,
                                       max_new_tokens=8)
            assert dv.state == "live" and dv.admitting
            assert dv.kind == "generative"
            assert dv.warmup_seconds is not None and dv.warmup_seconds > 0
            router = pkg.router.ServingRouter(reg, "g1")
            out = router.generate(prompt(7, seed=1), max_new_tokens=6)
            live = _snap_versions(reg)
            assert reg.retire("g1") is True
            with pytest.raises(KeyError):
                reg.get("g1")
            assert dv.state == "retired" and dv.gp is None
            seen[pkg.name] = (np.asarray(out).tolist(), live,
                              list(dv.warmed_buckets), reg.versions())
        finally:
            reg.shutdown()
    j, t = seen["jax"], seen["torch"]
    assert t[0] == j[0] == greedy(prompt(7, seed=1), 6)
    assert t[1][0] == j[1][0]          # versions, apart from the times
    assert t[1][1] is None              # no compile cache in the port
    assert t[2] == j[2] == list(engine(TORCH).prefill_buckets)
    assert t[3] == j[3] == []


def test_warmup_is_noted_in_compile_watch_as_serving_warmup(monkeypatch):
    """The port's warm-up claims its first runs for ``serving_warmup``,
    with the reference's attributes (a bucket a prefill, then the decode
    slots)."""
    cw = TORCH.registry._cw
    noted = []
    real = cw.note_cause

    def spy(cause, **attrs):
        noted.append((cause, attrs))
        real(cause, **attrs)

    monkeypatch.setattr(cw, "note_cause", spy)
    reg = TORCH.registry.ModelRegistry()
    try:
        reg.deploy_generative("gw", engine(TORCH, prefill_buckets=(8, 16)),
                              slots=2)
    finally:
        reg.shutdown()
    assert noted == ([("serving_warmup", {"bucket": b}) for b in (8, 16)]
                     + [("serving_warmup", {"decode_slots": 2})])


def test_duplicate_deploy_refused_and_failed_warmup_allows_redeploy():
    msgs = {}
    for pkg in BOTH:
        reg = pkg.registry.ModelRegistry()
        eng = engine(pkg)
        try:
            reg.deploy_generative("g1", eng, slots=2)
            with pytest.raises(ValueError) as dup:
                reg.deploy_generative("g1", eng, slots=2)
            reg.retire("g1")

            def boom(*a, **k):
                raise RuntimeError("warm-up failed")

            eng.warm = boom
            try:
                with pytest.raises(RuntimeError, match="warm-up failed"):
                    reg.deploy_generative("g2", eng, slots=2)
            finally:
                del eng.warm          # back to the class's method
            # the failed version does not linger and its name is free
            assert reg.versions() == []
            dv = reg.deploy_generative("g2", eng, slots=2,
                                       max_new_tokens=5)
            out = pkg.router.ServingRouter(reg, "g2").generate(
                prompt(5, seed=2))
            msgs[pkg.name] = (str(dup.value), np.asarray(out).tolist(),
                              dv.state)
        finally:
            reg.shutdown()
    assert msgs["torch"] == msgs["jax"]
    assert msgs["torch"][1] == greedy(prompt(5, seed=2), 5)


def test_retire_drains_inflight_generation_with_no_request_dropped():
    """A retire while a generation is in flight waits for it: the request
    completes with its full greedy tokens and the drain reports clean."""
    for pkg in BOTH:
        reg = pkg.registry.ModelRegistry()
        try:
            reg.deploy_generative("g1", engine(pkg), slots=2,
                                  max_new_tokens=30)
            router = pkg.router.ServingRouter(reg, "g1")
            started = threading.Event()
            got = {}

            def on_token(tok, idx):
                started.set()

            def run():
                try:
                    got["out"] = router.generate(prompt(9, seed=3),
                                                 on_token=on_token)
                except Exception as e:      # noqa: BLE001 — asserted below
                    got["err"] = e

            th = threading.Thread(target=run, daemon=True)
            th.start()
            assert started.wait(TIMEOUT_S)
            drained = reg.retire("g1", drain_timeout_s=TIMEOUT_S)
            th.join(TIMEOUT_S)
            assert not th.is_alive()
            assert "err" not in got, got.get("err")
            assert drained is True
            assert np.asarray(got["out"]).tolist() == greedy(
                prompt(9, seed=3), 30)
        finally:
            reg.shutdown()


# ----------------------------------------------------------- rollout FSM
class _FakeTime:
    """One clock for ``time.time``/``monotonic``/``perf_counter``."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    monotonic = perf_counter = time

    def time_ns(self):
        return int(self.now * 1e9)


class _Version:
    def __init__(self, name):
        self.version = name
        self.drains = []

    def drain(self, timeout_s=5.0):
        self.drains.append(timeout_s)
        return True


class _Router:
    def __init__(self):
        self.promoted = []

    def _promote(self, rollout):
        self.promoted.append(rollout.candidate.version)


# version names no other test uses: the per-version series live in the
# process-wide registry, which other tests' threads may still write
_INC, _CAND = "fsm-incumbent", "fsm-candidate"
_G1, _G2 = "walk-g1", "walk-g2"
# per event: (latency seconds of the candidate, of the incumbent, error?,
# shadow outcome or None, fake seconds to advance)
_HEALTHY = [(0.010, 0.010, False, "match", 0.5)] * 40
_ERRORS = ([(0.010, 0.010, False, "match", 0.5)] * 8
           + [(0.010, 0.010, True, None, 0.5)] * 12)
_SLOW = [(0.080, 0.010, False, None, 0.5)] * 24
_DIVERGED = [(0.010, 0.010, False, "diverged", 0.5)] * 12
_SCRIPTS = {
    "healthy_shadow_start": (dict(start_stage="shadow"), _HEALTHY),
    "healthy_timed": (dict(window_seconds=2.0, window_min_requests=2,
                           window_requests=10 ** 6), _HEALTHY),
    "error_rollback": ({}, _ERRORS),
    "latency_rollback": ({}, _SLOW),
    "shadow_divergence": (dict(start_stage="shadow"), _DIVERGED),
}


def _drive(pkg, policy_kw, script, clock, monkeypatch):
    monkeypatch.setattr(pkg.rollout, "time", clock)
    monkeypatch.setattr(pkg.obs.slo, "time", clock)
    pkg.obs.reset_global_registry()
    metrics = pkg.serving.metrics.serving_metrics()
    inc, cand, router = _Version(_INC), _Version(_CAND), _Router()
    policy = pkg.rollout.RolloutPolicy(**dict(dict(
        canary_fraction=0.25, ramp_fractions=(0.5, 0.75),
        window_requests=4, healthy_windows=2, min_latency_count=4,
        min_requests=4, min_shadow=2, error_rate_degraded=0.2,
        error_rate_failing=0.5, drain_timeout_s=1.5), **policy_kw))
    ro = pkg.rollout.CanaryRollout(router, None, inc, cand, policy)
    trail = []
    for lat_c, lat_i, err, shadow, dt in script:
        if not ro.active:
            break
        clock.now += dt
        metrics.latency(_INC).observe(lat_i)
        metrics.requests(_INC).inc()
        metrics.latency(_CAND).observe(lat_c)
        metrics.requests(_CAND).inc()
        if err:
            metrics.errors(_CAND).inc()
        if shadow is not None and ro.stage == "shadow":
            metrics.shadow(_CAND, shadow).inc()
        ro.maybe_timed_evaluate()
        ro.record_candidate_event()
        trail.append((ro.stage, ro.share, ro.active))
    return trail, ro.snapshot(), router.promoted, cand.drains, inc.drains


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_canary_state_machine_matches_the_reference_under_a_fake_clock(
        script, monkeypatch):
    policy_kw, events = _SCRIPTS[script]
    runs = {pkg.name: _drive(pkg, policy_kw, events, _FakeTime(),
                             monkeypatch) for pkg in BOTH}
    assert runs["torch"] == runs["jax"]
    trail, snap = runs["torch"][0], runs["torch"][1]
    want = {"healthy_shadow_start": "full", "healthy_timed": "full",
            "error_rollback": "rolled_back",
            "latency_rollback": "rolled_back",
            "shadow_divergence": "rolled_back"}[script]
    assert snap["stage"] == want and trail[-1][0] == want
    stages = [h["to"] for h in snap["history"]]
    if want == "full":
        assert stages[-3:] == ["ramp", "ramp", "full"]
        assert runs["torch"][2] == [_CAND]      # promoted once
    else:
        assert runs["torch"][3] == [1.5]        # candidate drained once


def test_rollout_through_generations_walks_to_full_like_the_reference():
    """Real generations through the router in both packages: the same
    stage walk (latency grading off: CPU timings differ), the same share
    at each stage, the old primary drained, and every response the
    greedy tokens."""
    walks = {}
    for pkg in BOTH:
        reg = pkg.registry.ModelRegistry()
        try:
            for v in (_G1, _G2):
                reg.deploy_generative(v, engine(pkg), slots=2,
                                      max_new_tokens=4)
            router = pkg.router.ServingRouter(reg, _G1)
            ro = router.begin_rollout(_G2, pkg.rollout.RolloutPolicy(
                start_stage="shadow", shadow_fraction=1.0,
                canary_fraction=0.5, ramp_fractions=(0.75,),
                window_requests=3, healthy_windows=1, min_requests=3,
                min_shadow=1, latency_ratio_degraded=None,
                latency_ratio_failing=None, drain_timeout_s=TIMEOUT_S))
            outs = []
            for i in range(60):
                if not ro.active:
                    break
                p = prompt(5, seed=100 + i)
                outs.append((np.asarray(router.generate(
                    p, request_key=i)).tolist(), greedy(p, 4)))
                if ro.stage == "shadow":
                    # the shadow generation runs off the request path
                    deadline = 200
                    while ro.stage == "shadow" and deadline:
                        ro.maybe_timed_evaluate()
                        deadline -= 1
                        threading.Event().wait(0.01)
            assert all(a == b for a, b in outs)
            snap = router.snapshot()
            walks[pkg.name] = (
                [(h["from"], h["to"], h["share"])
                 for h in snap["rollout"]["history"]],
                snap["primary"], snap["rollout"]["stage"],
                reg.get(_G1).state if _G1 in reg.versions()
                else "retired")
        finally:
            reg.shutdown()
    assert walks["torch"] == walks["jax"]
    assert walks["torch"][1:] == (_G2, "full", "retired")


# ------------------------------------------------------------ hash split
@pytest.mark.parametrize("case", range(6))
def test_request_fraction_is_the_reference_split(case):
    rng = np.random.default_rng(case)
    payloads = [
        rng.integers(0, 61, (int(rng.integers(1, 40)),)).astype(np.int32),
        rng.integers(0, 61, (int(rng.integers(1, 40)),)).tolist(),
        rng.random((2, 4)).astype("f4"),
    ]
    keys = [None, case, f"k-{case}", ("t", case)]
    for x in payloads:
        for key in keys:
            assert (TORCH.router.request_fraction(x, key)
                    == JAX.router.request_fraction(x, key))


def test_serving_snapshot_has_the_reference_shape():
    shapes = {}
    for pkg in BOTH:
        reg = pkg.registry.ModelRegistry()
        try:
            reg.deploy_generative("g1", engine(pkg), slots=2,
                                  warmup=False)
            router = pkg.router.ServingRouter(reg, "g1")
            snap = pkg.serving.snapshot()
            mine = [r for r in snap["registries"]
                    if [v["version"] for v in r["versions"]] == ["g1"]]
            assert len(mine) == 1
            shapes[pkg.name] = (sorted(snap), sorted(mine[0]),
                                sorted(mine[0]["versions"][0]),
                                sorted(router.snapshot()))
            assert router.snapshot() in snap["routers"]
        finally:
            reg.shutdown()
    assert shapes["torch"] == shapes["jax"]
