"""The port's fleet plane (shared store, idempotency) against the JAX
package's.

The same sequence of store operations — two workers registering, the
leader lease, a generative rollout fed by recorded samples, the lease
moving when the leader's heartbeat goes stale, a fenced write by the
stale leader that loses, the real leader advancing under its term, and a
corrupted document quarantined and rebuilt — runs through each package's
``SharedServingState`` under one fake clock, and every JSON document the
store holds after each step is the same. An idempotent replay of a
generation executes once and streams the same tokens in both packages;
``fleet_snapshot`` has the reference's keys.
"""
import os

import pytest

from _torch_serving import (BOTH, engine, get, greedy, http_call, reset_all,
                            sse, teardown_all)


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    teardown_all()


class _FakeTime:
    def __init__(self):
        self.now = 1_700_000_000.0

    def time(self):
        return self.now

    monotonic = perf_counter = time

    def time_ns(self):
        return int(self.now * 1e9)

    def sleep(self, s):
        self.now += s


def _store_drill(pkg, root, monkeypatch):
    """One scripted fleet history; returns the store document after each
    step, the workers' snapshots and the quarantined file count."""
    clock = _FakeTime()
    ss = pkg.shared
    monkeypatch.setattr(ss, "time", clock)
    pkg.obs.reset_global_registry()
    d = str(root / pkg.name)
    store = ss.SharedStore(d)
    w0 = ss.SharedServingState(store, "w0")
    w1 = ss.SharedServingState(store, "w1")
    docs = []

    def step():
        docs.append(store.read())

    w0.register(111, 8001)
    w1.register(222, 8002)
    w0.sync()
    w1.sync()
    step()                                   # w0 leads under term 1
    w0.ensure_lane("generative", "g1")
    w0.begin_rollout("generative", "g2", {
        "window_seconds": 1.0, "window_min_requests": 4,
        "healthy_windows": 1, "canary_fraction": 0.5,
        "ramp_fractions": [0.75], "min_latency_n": 99})
    step()
    clock.now += 2.0
    for _ in range(6):
        w0.record("g2", ok=True, latency_s=0.002)
        w0.record("g1", ok=True, latency_s=0.002)
    w0.sync()
    w1.sync()
    step()                                   # the leader closed a window
    clock.now += 10.0                        # w0 pauses past its lease
    w1.sync()
    step()                                   # w1 leads under term 2
    clock.now += 2.0
    for _ in range(6):
        w0.record("g2", ok=True, latency_s=0.002)
        w0.record("g1", ok=True, latency_s=0.002)
    w0.sync()                                # the stale leader's write
    step()
    clock.now += 2.0
    w1.sync()
    step()                                   # w1 advances under term 2
    with open(os.path.join(d, "state.json"), "w") as f:
        f.write('{"rev": "garbage", "lanes": [')
    w1.sync()
    step()                                   # quarantined and rebuilt
    aside = [fn for fn in os.listdir(d)
             if fn.startswith("state.json.corrupt.")]
    snaps = [{k: v for k, v in w.snapshot().items() if k != "path"}
             for w in (w0, w1)]
    return docs, snaps, len(aside)


def test_store_documents_equal_the_reference_under_a_fake_clock(
        tmp_path, monkeypatch):
    runs = {pkg.name: _store_drill(pkg, tmp_path, monkeypatch)
            for pkg in BOTH}
    assert runs["torch"] == runs["jax"]
    docs, (w0, _w1), aside = runs["torch"]
    assert docs[0]["leader"]["worker"] == "w0"
    assert docs[0]["leader"]["term"] == 1
    assert docs[3]["leader"] == {"worker": "w1", "term": 2,
                                 "since": docs[3]["leader"]["since"]}
    assert w0["fence"]["demotions"] == 1
    # every history event's term is monotonic, and no event after the
    # lease moved carries the stale term 1
    terms = [e["term"] for e in docs[-2]["history"]
             if e.get("term") is not None]
    assert terms == sorted(terms) and 2 in terms
    assert aside == 1 and docs[-1]["rebuilt"]["by"] == "w1"
    assert (docs[-1]["lanes"]["generative"]["primary"]
            == docs[-2]["lanes"]["generative"]["primary"])


def test_digest_and_schema_faults_quarantine_the_same(tmp_path):
    import json
    out = {}
    for pkg in BOTH:
        d = str(tmp_path / pkg.name)
        store = pkg.shared.SharedStore(d)
        good = store.update(lambda doc: doc.setdefault("lanes", {}))
        path = os.path.join(d, "state.json")
        raw = json.loads(open(path).read())
        raw["stamp"] = 12345.0                  # a silent partial edit
        with open(path, "w") as f:
            json.dump(raw, f)
        digest_rev = store.read()["rev"]
        with open(path, "w") as f:
            json.dump({"rev": 1, "workers": ["not", "a", "dict"]}, f)
        schema_rev = store.read()["rev"]
        out[pkg.name] = (good["rev"], good["digest"] != "", digest_rev,
                         schema_rev,
                         len([fn for fn in os.listdir(d)
                              if fn.startswith("state.json.corrupt.")]))
    assert out["torch"] == out["jax"] == (1, True, 0, 0, 2)


def _door(pkg, tmp=None):
    reg = pkg.registry.ModelRegistry()
    reg.deploy_generative("g1", engine(pkg), slots=2, max_new_tokens=16)
    router = pkg.router.ServingRouter(reg, "g1")
    shared = None
    if tmp is not None:
        shared = pkg.shared.SharedServingState(
            pkg.shared.SharedStore(str(tmp / pkg.name)), "w0")
        shared.ensure_lane("generative", "g1")
    fd = pkg.frontdoor.FrontDoor(gen_router=router, shared=shared,
                                 port=0).start()
    if shared is not None:
        shared.register(os.getpid(), fd.port)
        fd.sync_once()
    return reg, fd


def _decode_requests(pkg):
    inst = pkg.obs.global_registry().get("dl4j_decode_requests_total")
    return sum(c.value for _lv, c in inst.series())


def test_idempotent_replay_executes_once_and_streams_the_same_tokens():
    seen = {}
    for pkg in BOTH:
        reg, fd = _door(pkg)
        try:
            addr = fd.get_address()
            key = {pkg.idem.IDEMPOTENCY_HEADER: "S1"}
            doc = {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 8}
            _i, toks, done, _e, _ev, h = sse(addr, doc, headers=key)
            assert pkg.idem.REPLAY_HEADER not in h
            admitted = _decode_requests(pkg)
            _i2, toks2, done2, _e2, _ev2, h2 = sse(addr, doc, headers=key)
            assert h2.get(pkg.idem.REPLAY_HEADER) == "1"
            c3, p3, h3 = http_call(addr, "/v1/generate", doc, headers=key)
            assert h3.get(pkg.idem.REPLAY_HEADER) == "1"
            after = _decode_requests(pkg)
            snap = pkg.idem.snapshot()
            seen[pkg.name] = (toks, toks2, done2["tokens"], c3,
                              p3["tokens"],
                              snap["entries"]["S1"]["executions"],
                              snap["duplicate_executions"],
                              after - admitted)
        finally:
            fd.stop()
            reg.shutdown()
    assert seen["torch"] == seen["jax"]
    toks = seen["torch"][0]
    assert toks == greedy([3, 1, 4, 1, 5], 8)
    # the replays ran no generation: the pipeline admitted nothing new
    assert seen["torch"][1:] == (toks, toks, 200, toks, 1, 0, 0)


def test_fleet_snapshot_has_the_reference_keys(tmp_path):
    seen = {}
    for pkg in BOTH:
        reg, fd = _door(pkg, tmp_path)
        try:
            addr = fd.get_address()
            http_call(addr, "/v1/generate",
                 {"prompt": [2, 7], "max_new_tokens": 3},
                 headers={pkg.idem.IDEMPOTENCY_HEADER: "D1"})
            code, fleet = get(addr, "/debug/fleet")
            assert code == 200
            mine = [f for f in fleet["frontdoors"]
                    if f["address"] == addr]
            assert len(mine) == 1 and mine[0]["shared"] is not None
            direct = pkg.frontdoor.fleet_snapshot()
            seen[pkg.name] = (
                sorted(fleet), sorted(direct), sorted(mine[0]),
                sorted(mine[0]["shared"]),
                sorted(mine[0]["shared"]["fence"]),
                fleet["idempotency"]["entries"]["D1"]["executions"],
                mine[0]["shared"]["fence"]["leader"]["term"])
        finally:
            fd.stop()
            reg.shutdown()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][-2:] == (1, 1)
