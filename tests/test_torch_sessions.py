"""The port's durable generation sessions over HTTP against the JAX
package's.

Orphan adoption across two in-process doors on one shared store: a
stream journaled by one door and cut short (its record left ``live`` with
a truncated token log, as a SIGKILLed owner leaves it) is adopted by the
other door, which bumps the fence, names ``adopted_from``, regenerates
the missing suffix and delivers only the ids after ``Last-Event-ID`` —
with the same ids, tokens and record in both packages, and the tokens
the JAX engine's greedy tokens. A ``Last-Event-ID`` resume of a finished
session replays only the unseen ids. Then the reference's
session-failover drill against the port's server on the CPU: ``python -m
deeplearning4j_tpu_torch.tools.serve --device cpu --workers 2`` under the
drill's fault spec, one worker SIGKILLed with every stream mid-flight,
and every stream completes gapless with the undisturbed run's tokens.
Every door and the fleet are stopped in a ``finally``; every wait is
bounded.
"""
import os
import time

import pytest

from _torch_serving import (BOTH, engine, greedy, http_call, reset_all, sse,
                            teardown_all)


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    teardown_all()


def _shared_door(pkg, store, worker_id):
    reg = pkg.registry.ModelRegistry()
    reg.deploy_generative("g1", engine(pkg), slots=2, max_new_tokens=16)
    shared = pkg.shared.SharedServingState(store, worker_id)
    shared.ensure_lane("generative", "g1")
    fd = pkg.frontdoor.FrontDoor(gen_router=pkg.router.ServingRouter(
        reg, "g1"), shared=shared, port=0).start()
    shared.register(os.getpid(), fd.port)
    fd.sync_once()
    return reg, fd


def test_orphan_adoption_across_two_doors_matches_the_reference(tmp_path):
    seen = {}
    doc = {"prompt": [5, 2, 9, 7, 4], "max_new_tokens": 12}
    for pkg in BOTH:
        store = pkg.shared.SharedStore(str(tmp_path / pkg.name))
        made = []
        try:
            made.append(_shared_door(pkg, store, "w0"))
            made.append(_shared_door(pkg, store, "w1"))
            (_ra, fa), (_rb, fb) = made
            code, plain, _h = http_call(fa.get_address(), "/v1/generate", doc)
            assert code == 200
            sid, full = plain["session"], plain["tokens"]
            pkg.sess.global_journal().flush()

            def orphan(d):
                rec = d["sessions"][sid]
                rec.update(status="live", tokens=full[:5], seq=5,
                           owner="w0", fence=3)

            store.update(orphan)
            before = pkg.sess.store_record(store, sid)
            ids, toks, done, error, _ev, _hd = sse(
                fb.get_address(), doc,
                headers={"Last-Event-ID": "2",
                         "X-Dl4j-Session-Id": sid})
            after = pkg.sess.store_record(store, sid)
            seen[pkg.name] = (full, ids, toks, error, done["tokens"],
                              before["fence"], after["fence"],
                              after["owner"], after["adopted_from"])
        finally:
            for reg, fd in made:
                fd.stop()
                reg.shutdown()
    assert seen["torch"] == seen["jax"]
    full, ids, toks, error, done, f0, f1, owner, prev = seen["torch"]
    assert full == greedy(doc["prompt"], 12)
    assert error is None and done == full
    assert ids == list(range(3, 12)) and toks == full[3:]
    assert f1 >= f0 + 1 and owner == "w1" and prev == "w0"


def test_last_event_id_resume_replays_only_unseen_ids(tmp_path):
    seen = {}
    doc = {"prompt": [2, 7, 1, 8, 2, 8], "max_new_tokens": 10}
    for pkg in BOTH:
        store = pkg.shared.SharedStore(str(tmp_path / pkg.name))
        reg, fd = _shared_door(pkg, store, "w0")
        try:
            addr = fd.get_address()
            code, plain, _h = http_call(addr, "/v1/generate", doc)
            assert code == 200
            pkg.sess.global_journal().flush()
            ids, toks, done, error, _ev, _hd = sse(
                addr, doc, headers={"Last-Event-ID": "3",
                                    "X-Dl4j-Session-Id": plain["session"]})
            seen[pkg.name] = (plain["tokens"], ids, toks, error,
                              done["tokens"])
        finally:
            fd.stop()
            reg.shutdown()
    assert seen["torch"] == seen["jax"]
    full, ids, toks, error, done = seen["torch"]
    assert full == greedy(doc["prompt"], 10)
    assert ids == list(range(4, 10)) and toks == full[4:]
    assert error is None and done == full


def test_two_worker_fleet_survives_a_sigkill_mid_stream(tmp_path):
    """The reference drill (``benchmarks/http_load.py``
    ``run_session_failover``) on the port's server at the CPU: each of
    the 8 streams completes, its ids are gapless and its tokens are the
    undisturbed run's (the demo model in this process); every stream was
    in flight at the kill and the survivor adopted every live session of
    the killed worker; the survivor wrote its launch counters."""
    import chip_smoke
    baseline, _engine = chip_smoke.demo_baselines("cpu")
    t0 = time.monotonic()
    rec = chip_smoke.session_failover_drill(
        "cpu", tmp_path / "fleet", baseline, spinup_s=90.0, stream_s=60.0)
    assert rec["failures"] == [], rec
    assert (rec["sess_completion"], rec["sess_seq_exact"],
            rec["sess_greedy_match"]) == (1.0, 1.0, 1.0)
    assert rec["resumed_streams"] >= 1        # some stream failed over
    assert rec["killed_worker"] == "w1"
    chip_smoke.check_drill(rec)     # in flight at the kill, orphans adopted
    chip_smoke.check_classify(rec)  # each worker's v1 answers /v1/classify
    # the survivor's own counters, written at its stop: on the CPU every
    # wrapper takes its plain version, so none counts a launch
    assert rec["survivor_worker"] == "w0"
    assert list(rec["survivor_launches"]) == list(chip_smoke.ALL_KERNELS)
    assert set(rec["survivor_launches"].values()) == {0}
    assert time.monotonic() - t0 < 120
