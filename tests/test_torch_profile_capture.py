"""The port's ``observability/profile_capture.py`` and ``profiler/``
(``DeviceProfiler`` over ``torch.profiler``, ``PerformanceTracker``)
against the JAX package's.

The reference's capture drives ``jax.profiler`` and parses XPlane protos
through TensorFlow, so here the two are compared by their metadata and
semantics: the same record keys (the reference's parse given an empty
trace), work units counted alike (fit iterations and served device
batches), the same retention under ``DL4J_TPU_POSTMORTEM_KEEP``, the
``DL4J_TPU_PROFILE=0`` switch and ``CaptureBusy``. The port's own capture
on the CPU (``device="cpu"``) holds a real ``torch.profiler`` trace:
``top_ops`` falls back to the host's ``aten`` ops and ``modules`` names
the nets' ``_train_step`` and ``_output_jit`` ranges, recorded from the
threads that ran them. ``PerformanceTracker`` publishes the same series.
"""
import os
import threading

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.observability.profile_capture as j_pc
import deeplearning4j_tpu.profiler.performance as j_perf
import deeplearning4j_tpu.profiler.xprof as j_xprof
import deeplearning4j_tpu_torch.observability.profile_capture as t_pc
import deeplearning4j_tpu_torch.profiler.performance as t_perf
import deeplearning4j_tpu_torch.profiler.xprof as t_xprof

from _torch_scoring import (BOTH, JAX, TORCH, inputs, net_of, pair,
                            reset_all, series, teardown_all)

for _pkg, _pc, _perf, _xp in ((JAX, j_pc, j_perf, j_xprof),
                              (TORCH, t_pc, t_perf, t_xprof)):
    _pkg.pc, _pkg.perf, _pkg.xprof = _pc, _perf, _xp


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    teardown_all()


class _FakeProfiler:
    """The reference's capture lifecycle without ``jax.profiler``: the
    trace dir is made, nothing is traced."""

    def __init__(self, logdir, device=None):
        self.logdir = logdir

    def start(self):
        os.makedirs(self.logdir, exist_ok=True)

    def stop(self):
        return self.logdir


def _fake_reference(monkeypatch):
    monkeypatch.setattr(j_xprof, "DeviceProfiler", _FakeProfiler)
    monkeypatch.setattr(j_pc, "_load_xplanes", lambda logdir: [])


def _capture(pkg, out_dir, work, steps=3):
    """One capture while ``work()`` runs in a thread until it ends."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            work()

    kw = {"device": "cpu"} if pkg is TORCH else {}
    cap = pkg.pc.ProfileCapture(out_dir=str(out_dir), **kw)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        rec = cap.capture(steps=steps, timeout_s=30.0)
    finally:
        stop.set()
        th.join(30.0)
    return cap, rec


@pytest.mark.parametrize("work", ["fit", "serve"])
def test_capture_records_and_work_units_equal_the_reference(
        tmp_path, monkeypatch, work):
    _fake_reference(monkeypatch)
    nets = pair("lenet")
    x = inputs("lenet", 8, seed=1)
    y = np.eye(10, dtype=np.float32)[np.arange(8) % 10]
    recs = {}
    for pkg in BOTH:
        net = net_of(pkg, nets)
        if work == "fit":
            def unit(net=net):
                net.fit(x, y)
        else:
            pi = pkg.pi.ParallelInference(net, batch_limit=4,
                                          max_wait_ms=1.0)

            def unit(pi=pi):
                pi.output(x[:2])
        _cap, rec = _capture(pkg, tmp_path / pkg.name, unit)
        recs[pkg.name] = rec
    t, j = recs["torch"], recs["jax"]
    assert sorted(t) == sorted(j)
    assert t["steps_requested"] == j["steps_requested"] == 3
    assert t["steps_seen"] >= 3 and j["steps_seen"] >= 3
    assert t["trace_dir"].startswith(str(tmp_path / "torch"))
    assert os.path.exists(os.path.join(t["trace_dir"], "trace.json"))
    assert t["source"] == "host" and t["top_ops"]
    assert any(r["op"].startswith("aten::") for r in t["top_ops"])
    assert all(set(r) == {"op", "total_seconds", "count"}
               for r in t["top_ops"])
    module = ("MultiLayerNetwork._train_step" if work == "fit"
              else "MultiLayerNetwork._output_jit")
    assert module in [m["module"] for m in t["modules"]]


def test_retention_busy_and_kill_switch_equal_the_reference(
        tmp_path, monkeypatch):
    _fake_reference(monkeypatch)
    monkeypatch.setattr(t_xprof, "DeviceProfiler", _FakeProfiler)
    monkeypatch.setenv("DL4J_TPU_POSTMORTEM_KEEP", "2")
    seen = {}
    for pkg in BOTH:
        out = tmp_path / pkg.name
        cap = pkg.pc.ProfileCapture(out_dir=str(out))
        for _ in range(4):
            cap.capture(steps=1, timeout_s=0.1)
        dirs = sorted(e for e in os.listdir(out)
                      if e.startswith("profile-"))
        snap = cap.snapshot()
        assert cap._busy.acquire(blocking=False)
        try:
            with pytest.raises(pkg.pc.CaptureBusy):
                cap.capture(steps=1, timeout_s=0.1)
        finally:
            cap._busy.release()
        monkeypatch.setenv("DL4J_TPU_PROFILE", "0")
        with pytest.raises(pkg.pc.ProfileDisabled):
            cap.capture(steps=1, timeout_s=0.1)
        off = cap.snapshot()["enabled"]
        monkeypatch.delenv("DL4J_TPU_PROFILE")
        seen[pkg.name] = (len(dirs), len(snap["captures"]),
                          snap["captures"][-1]["trace_dir"].endswith(
                              dirs[-1]), off,
                          [r["steps_requested"] for r in snap["captures"]])
    assert seen["torch"] == seen["jax"] == (2, 4, True, False, [1] * 4)


def test_the_global_capture_resets_as_the_reference(tmp_path):
    for pkg in BOTH:
        kw = {"device": "cpu"} if pkg is TORCH else {}
        a = pkg.pc.reset_global_profile_capture(out_dir=str(tmp_path), **kw)
        assert pkg.pc.global_profile_capture() is a
        assert pkg.obs.global_profile_capture() is a
        assert a.snapshot() == {"enabled": True, "captures": []}


def test_device_profiler_traces_the_cpu_and_wants_the_card_by_default(
        tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_xprof.DeviceProfiler(str(tmp_path / "card"))
    prof = t_xprof.DeviceProfiler(str(tmp_path / "cpu"), device="cpu")
    with prof.trace("matmul"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    parsed = t_pc.parse_top_ops(str(tmp_path / "cpu"))
    assert parsed["source"] == "host"
    assert "aten::mm" in [r["op"] for r in parsed["top_ops"]]
    assert [m["module"] for m in parsed["modules"]] == ["matmul"]
    out, trace_dir, wall = t_xprof.profile_step(
        lambda a: a @ a, torch.ones(4, 4), log_dir=str(tmp_path / "step"),
        iters=2, device="cpu")
    assert out.shape == (4, 4) and wall > 0
    assert os.path.exists(os.path.join(trace_dir, t_xprof.TRACE_FILE))


def test_performance_tracker_publishes_as_the_reference():
    seen = {}
    for pkg in BOTH:
        tr = pkg.perf.PerformanceTracker()
        tr.record_iteration(32)
        tr.record_iteration(16)
        tr.add_transfer_bytes(host_to_device=1024, device_to_host=256)
        tr.addMemoryTransaction(host_to_device=8)
        seen[pkg.name] = (tr.examples, tr.iterations, tr.h2d_bytes,
                          tr.d2h_bytes, tr.examples_per_second() > 0,
                          {n: series(pkg, n) for n in (
                              "dl4j_perf_examples_total",
                              "dl4j_perf_iterations_total",
                              "dl4j_transfer_bytes_total")})
        assert pkg.perf.PerformanceTracker.getInstance() is \
            pkg.perf.PerformanceTracker.get_instance()
        assert "examples in" in tr.summary()
    assert seen["torch"] == seen["jax"]
