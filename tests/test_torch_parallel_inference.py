"""The port's ``ParallelInference`` against the JAX package's.

The same requests go through both packages' ``ParallelInference`` over the
same small nets (a narrow LeNet and a narrow residual graph, the port
carrying the JAX net's weights): every request's output agrees within
f32's row (atol 1e-5) in INSTANT and BATCHED mode, with the async
pipeline on and off, and equals the port net's ``output`` of the
request's rows alone (padding never leaks into a request). The bucket
sets, the async knobs, a scripted sequence of deadlines, full-queue sheds
under both policies, a breaker opening and closing through a half-open
probe under a fake clock, and injected dispatch faults give the same
typed outcomes and the same counter values in both packages, as do the
QoS tenants' request and token accounting, the serving probe's
compile-watch events and the metric series. ``workers`` > 1 raises,
naming ROADMAP queue 1 item 7.
"""
import threading
import time
import types

import numpy as np
import pytest

from _torch_scoring import (BOTH, JAX, OUT_ATOL, TIMEOUT_S, TORCH, direct,
                            inputs, net_of, pair, reset_all, series,
                            teardown_all)


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    teardown_all()


_NETS = {}


def nets(kind):
    if kind not in _NETS:
        _NETS[kind] = pair(kind)
    return _NETS[kind]


def _concurrent(pi, reqs):
    """Each request in its own thread, released together; results by
    index."""
    out = {}
    gate = threading.Barrier(len(reqs))

    def call(i):
        gate.wait()
        out[i] = pi.output(reqs[i])

    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a request hung"
    return out


# ------------------------------------------------------------- outputs
@pytest.mark.parametrize("async_on", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("mode", ["INSTANT", "BATCHED"])
@pytest.mark.parametrize("kind", ["lenet", "residual"])
def test_outputs_equal_the_reference(monkeypatch, kind, mode, async_on):
    monkeypatch.setenv("DL4J_TPU_ASYNC", "1" if async_on else "0")
    x = inputs(kind, 24, seed=1)
    sizes = [1, 3, 2, 1, 3, 1, 2, 1, 3, 2, 1, 3, 1]
    reqs, off = [], 0
    for n in sizes:
        reqs.append(x[off:off + n])
        off += n
    got = {}
    for pkg in BOTH:
        net = net_of(pkg, nets(kind))
        pi = pkg.pi.ParallelInference(net, inference_mode=mode,
                                      batch_limit=8, max_wait_ms=20.0)
        try:
            got[pkg.name] = _concurrent(pi, reqs)
        finally:
            pi.shutdown()
    tnet = nets(kind)[1]
    for i, r in enumerate(reqs):
        t = got["torch"][i]
        assert isinstance(t, np.ndarray) and t.dtype == np.float32
        assert t.shape == (len(r),) + got["jax"][i].shape[1:]
        np.testing.assert_allclose(t, got["jax"][i], atol=OUT_ATOL)
        # the request's own rows, whatever shared its padded batch
        np.testing.assert_allclose(t, direct(TORCH, tnet, r),
                                   atol=OUT_ATOL)


def test_batch_partners_do_not_change_a_request():
    """A request alone and the same request beside others in one padded
    bucket give the same rows (inference BatchNormalization reads its
    running statistics; rows are independent)."""
    _j, t = nets("residual")
    x = inputs("residual", 8, seed=2)
    pi = TORCH.pi.ParallelInference(t, batch_limit=8, max_wait_ms=50.0)
    try:
        alone = pi.output(x[:2])
        together = _concurrent(pi, [x[:2], x[2:5], x[5:8]])[0]
    finally:
        pi.shutdown()
    np.testing.assert_allclose(together, alone, atol=1e-6)


# ------------------------------------------------------------ buckets
class _Echo:
    def output(self, x):
        return x


@pytest.mark.parametrize("limit, sizes", [
    (1, None), (3, None), (8, None), (12, None), (32, None),
    (8, (2, 5, 99)), (8, (4,)), (6, (6, 1, 1))])
def test_bucket_sizes_equal_the_reference(limit, sizes):
    got = [pkg.pi.ParallelInference(
        _Echo(), inference_mode="INSTANT", batch_limit=limit,
        bucket_sizes=sizes).bucket_sizes for pkg in BOTH]
    assert got[1] == got[0]


def test_bucket_sizes_outside_the_limit_are_refused_by_both():
    for pkg in BOTH:
        with pytest.raises(ValueError, match="no entry in"):
            pkg.pi.ParallelInference(_Echo(), inference_mode="INSTANT",
                                     batch_limit=4, bucket_sizes=(8, 9))


@pytest.mark.parametrize("env", [None, "1", "3", "0", "junk"])
def test_async_knobs_equal_the_reference(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("DL4J_TPU_INFLIGHT", raising=False)
    else:
        monkeypatch.setenv("DL4J_TPU_INFLIGHT", env)
    assert TORCH.asyncr.inflight_limit() == JAX.asyncr.inflight_limit()
    for limit in (1, 2, 3, 7, 8, 33, 64):
        assert (TORCH.asyncr.default_buckets(limit)
                == JAX.asyncr.default_buckets(limit))
    assert TORCH.asyncr.snapshot()["inflight_limit"] == \
        JAX.asyncr.inflight_limit()


def test_workers_above_one_raise_naming_roadmap_item_7():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        TORCH.pi.ParallelInference(_Echo(), workers=2)
    pi = TORCH.pi.ParallelInference(_Echo(), inference_mode="INSTANT",
                                    workers=1)
    assert pi.output(np.ones((2, 3), np.float32)).shape == (2, 3)


# ------------------------------------------------- scripted resilience
class _Wrapped:
    """A caller's model: ``behave`` decides each forward (sleep, block,
    raise), then the package's net answers."""

    def __init__(self, pkg, net, behave):
        self.pkg, self.net, self.behave = pkg, net, behave

    def output(self, x):
        self.behave()
        return self.net.output(x)


def _outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:
        return type(e).__name__


def _fake_clock(monkeypatch, pkg, now):
    """The package's policy module reads ``now[0]`` as its monotonic
    clock."""
    clock = types.SimpleNamespace(monotonic=lambda: now[0],
                                  perf_counter=time.perf_counter,
                                  time=time.time, sleep=time.sleep)
    monkeypatch.setattr(pkg.policy, "time", clock)


def _script(monkeypatch, pkg, x):
    """The scripted sequence in one package; returns (outcomes, counters)."""
    net = net_of(pkg, nets("demo"))
    P = pkg.pi.ParallelInference
    out = {}
    # deadlines: BATCHED and INSTANT, a slow forward
    slow = _Wrapped(pkg, net, lambda: time.sleep(0.15))
    for mode in ("BATCHED", "INSTANT"):
        pi = P(slow, inference_mode=mode, batch_limit=4, deadline_ms=10)
        out[f"deadline_{mode}"] = [
            _outcome(lambda: pi.output(x[:1])),
            _outcome(lambda: pi.output(x[:1], deadline_ms=30_000))]
        pi.shutdown()
    # full-queue sheds, the sync loop: the first request holds the loop in
    # its forward, the second fills the one-deep queue, the third sheds
    monkeypatch.setenv("DL4J_TPU_ASYNC", "0")
    for policy in ("reject_newest", "reject_oldest"):
        release = threading.Event()
        gated = _Wrapped(pkg, net, lambda: release.wait(TIMEOUT_S))
        pi = P(gated, batch_limit=1, max_queue_depth=1, shed_policy=policy)
        res = [None] * 3

        def call(i, pi=pi, res=res):
            res[i] = _outcome(lambda: pi.output(x[i:i + 1]))

        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.15)
        release.set()
        for t in threads:
            t.join(TIMEOUT_S)
        pi.shutdown()
        out[f"queue_{policy}"] = res
    monkeypatch.delenv("DL4J_TPU_ASYNC")
    # breaker: two failures open it, callers fail fast, the reset timeout
    # (fake clock) admits a half-open probe whose success closes it
    now = [1000.0]
    _fake_clock(monkeypatch, pkg, now)
    failing = [True]

    def boom():
        if failing[0]:
            raise RuntimeError("device on fire")

    pi = P(_Wrapped(pkg, net, boom), batch_limit=4,
           breaker=pkg.policy.CircuitBreaker(
               "inference.device_execute", failure_threshold=2,
               reset_timeout_seconds=60.0))
    seq = [_outcome(lambda: pi.output(x[:1])) for _ in range(4)]
    failing[0] = False
    now[0] += 61.0
    seq += [_outcome(lambda: pi.output(x[:1])) for _ in range(2)]
    out["breaker"] = seq + [pi._breaker.state()]
    pi.shutdown()
    monkeypatch.undo()
    # injected dispatch faults: two transient ones retried under the
    # budget, one device-execution fault surfaced
    pi = P(net, batch_limit=4)
    plan = pkg.faults.FaultPlan([
        pkg.faults.FaultSpec("inference.dispatch", "error", rate=1.0,
                             count=2),
        pkg.faults.FaultSpec("inference.device_execute", "error", rate=1.0,
                             count=1)], seed=3)
    with pkg.faults.active(plan):
        out["faults"] = [_outcome(lambda: pi.output(x[:1])),
                         _outcome(lambda: pi.output(x[:1]))]
    pi.shutdown()
    counters = {n: series(pkg, n) for n in (
        "dl4j_inference_requests_total", "dl4j_inference_errors_total",
        "dl4j_inference_shed_total", "dl4j_faults_injected_total")}
    return out, counters


def test_scripted_resilience_outcomes_equal_the_reference(monkeypatch):
    x = inputs("demo", 4, seed=3)
    seen = {pkg.name: _script(monkeypatch, pkg, x) for pkg in BOTH}
    assert seen["torch"] == seen["jax"]
    outcomes, counters = seen["torch"]
    assert outcomes["deadline_BATCHED"] == ["DeadlineExceeded", "ok"]
    assert outcomes["queue_reject_newest"] == ["ok", "ok", "ShedError"]
    assert outcomes["queue_reject_oldest"] == ["ok", "ShedError", "ok"]
    assert outcomes["breaker"] == ["RuntimeError", "RuntimeError",
                                   "CircuitOpenError", "CircuitOpenError",
                                   "ok", "ok", 0]     # 0: closed
    assert outcomes["faults"] == ["InjectedFault", "ok"]


def test_shutdown_is_typed_and_stops_the_threads():
    for pkg in BOTH:
        net = net_of(pkg, nets("demo"))
        pi = pkg.pi.ParallelInference(net, batch_limit=4)
        threads = list(pi._threads)
        pi.shutdown()
        assert not any(t.is_alive() for t in threads)
        with pytest.raises(pkg.policy.ShutdownError):
            pi.output(inputs("demo", 1))


# --------------------------------------------------------------- QoS
def test_qos_tenant_accounting_equals_the_reference():
    x = inputs("lenet", 12, seed=4)
    seen = {}
    for pkg in BOTH:
        pkg.qos.reset_global_tenants()
        net = net_of(pkg, nets("lenet"))
        with pkg.pi.ParallelInference(net, batch_limit=8,
                                      max_wait_ms=1.0) as pi:
            for i, (tenant, n) in enumerate([("a", 1), ("b", 3), ("a", 2),
                                             (None, 1), ("b", 1)]):
                pi.output(x[i:i + n], tenant=tenant)
        snap = pkg.qos.global_tenants().snapshot()["tenants"]
        seen[pkg.name] = {k: (v["requests"], v["tokens"], v["shed"],
                              v["cost_flops"]) for k, v in snap.items()}
    assert sorted(seen["torch"]) == sorted(seen["jax"])
    for k, (req, tok, shed, cost) in seen["torch"].items():
        jreq, jtok, jshed, jcost = seen["jax"][k]
        assert (req, tok, shed) == (jreq, jtok, jshed), k
        # the bucket's FLOPs share: analytic against XLA's cost_analysis,
        # PERF.md's band
        assert (cost == jcost == 0) or 0.9 <= cost / jcost <= 1.15, k


# ------------------------------------------- probes and metric series
def _traffic(pkg, net):
    with pkg.pi.ParallelInference(net, batch_limit=8,
                                  max_wait_ms=1.0) as pi:
        for n in (1, 3, 1, 8, 2):
            pi.output(inputs("lenet", n, seed=n))


def test_serving_probe_notes_each_bucket_once_as_the_reference():
    """The port's ``output`` notes its first run at each new input
    signature under ``MultiLayerNetwork._output_jit``, as the reference's
    jit trace does, and each bucket's first use claims the
    ``bucket_miss`` cause: the same events in both packages."""
    seen = {}
    for pkg in BOTH:
        j, t = pair("lenet", seed=9)      # a net no other test served
        watch = pkg.obs.global_compile_watch()
        watch.clear()
        _traffic(pkg, net_of(pkg, (j, t)))
        seen[pkg.name] = [(e["fn"], e["cause"]) for e in watch.events()
                          if e["fn"].endswith("_output_jit")]
    assert seen["torch"] == seen["jax"]
    assert [c["bucket"] for _fn, c in seen["torch"]] == [1, 4, 8, 2]


def test_metric_series_equal_the_reference():
    seen = {}
    for pkg in BOTH:
        _traffic(pkg, net_of(pkg, nets("lenet")))
        reg = pkg.obs.global_registry()
        names = sorted(n for n in reg.names() if n.startswith(
            "dl4j_inference"))
        seen[pkg.name] = (names, {n: series(pkg, n) for n in (
            "dl4j_inference_requests_total", "dl4j_inference_batches_total",
            "dl4j_inference_bucket_total")},
            reg.get("dl4j_inference_batch_occupancy").count,
            reg.get("dl4j_inference_bucket_fill").sum)
    assert seen["torch"] == seen["jax"]


# ----------------------------------------------- the scoring phase's check
def test_the_scoring_check_catches_a_planted_row_shift():
    """``chip_smoke.py``'s scoring check on the CPU: three clients'
    requests of 1 and 3 images through BATCHED ``ParallelInference``
    read their own images' outputs; the references tell every image from
    every other; a row shift planted in ``_distribute`` is caught."""
    import chip_smoke
    _j, t = nets("residual")
    x = inputs("residual", 18, seed=5)
    reqs = chip_smoke.scoring_requests(x, clients=3, requests=4)
    pi = TORCH.pi.ParallelInference(t, batch_limit=8, max_wait_ms=50.0)
    try:
        results, _lat, _wall = chip_smoke.scoring_traffic(pi.output, reqs)
        wants = chip_smoke.scoring_references(t, reqs)
        clean = chip_smoke.scoring_errors(wants, results)
        planted = chip_smoke.planted_row_shift(pi, reqs, wants)
        again, _lat, _wall = chip_smoke.scoring_traffic(pi.output, reqs)
    finally:
        pi.shutdown()
    sep = chip_smoke.separation(wants)
    assert len(clean) == len(planted) == 12
    assert max(clean.values()) <= 1e-6 < sep
    assert max(planted.values()) > sep / 2
    # the fault is gone once the drill ends
    assert max(chip_smoke.scoring_errors(wants, again).values()) <= 1e-6


def test_calibrated_bn_statistics_are_the_training_forwards():
    """``chip_smoke.calibrate_bn`` sets each BatchNormalization layer's
    running statistics to its batch's in a training-mode forward: the
    inference output of that batch then equals the training-mode one,
    the params and the layers' decay are left as they were."""
    import torch

    import chip_smoke
    _j, t = pair("residual")
    x = inputs("residual", 16, seed=6)
    params = {k: {p: v.clone() for p, v in layer.items()}
              for k, layer in t.param_tree().items()}
    train = t.feedForward(x, train=True)["out"].numpy()
    before = t.output(x).numpy()
    assert chip_smoke.calibrate_bn(torch, t, x) == 1
    after = t.output(x).numpy()
    assert np.abs(before - train).max() > 1e-3
    np.testing.assert_allclose(after, train, atol=1e-6)
    assert all(torch.equal(t.param_tree()[k][p], v)
               for k, layer in params.items() for p, v in layer.items())
    assert t.conf.nodes["bn"].layer.decay == 0.9
