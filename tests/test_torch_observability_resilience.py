"""The port's copied host modules against their JAX-package originals.

Each pair is driven with the same calls and held to the same result:
Prometheus exposition text byte for byte, recorded spans (names,
attributes and parent links, times left out), the firing sequence of a
seeded fault plan, QoS queueing and shedding decisions, and circuit-breaker
and retry transitions under a fake clock. The ported device seams are held
to their own contracts: ``compile_watch`` counts one first run per new
step signature (in the reference's signature notation), and the cost
model's decode and prefill counts equal a hand formula exactly and XLA's
``cost_analysis`` of the JAX engine's same steps within a stated band. A
parametrised test holds each copied module's public names to the JAX
module's, less a listed set, each with its reason.
"""
import ast
import queue
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import generation as jgen
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.observability import compile_watch as j_cw
from deeplearning4j_tpu.observability import cost_model as j_cost
from deeplearning4j_tpu.observability import registry as j_reg
from deeplearning4j_tpu.observability import tracing as j_tr
from deeplearning4j_tpu.resilience import faults as j_faults
from deeplearning4j_tpu.resilience import policy as j_policy
from deeplearning4j_tpu.resilience import qos as j_qos

from deeplearning4j_tpu_torch.models import generation as tgen
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import from_jax_params
from deeplearning4j_tpu_torch.observability import compile_watch as t_cw
from deeplearning4j_tpu_torch.observability import cost_model as t_cost
from deeplearning4j_tpu_torch.observability import device_memory as t_mem
from deeplearning4j_tpu_torch.observability import registry as t_reg
from deeplearning4j_tpu_torch.observability import tracing as t_tr
from deeplearning4j_tpu_torch.observability import reset_global_registry
from deeplearning4j_tpu_torch.parallel.generation import GenerationPipeline
from deeplearning4j_tpu_torch.resilience import faults as t_faults
from deeplearning4j_tpu_torch.resilience import policy as t_policy
from deeplearning4j_tpu_torch.resilience import qos as t_qos

ROOT = Path(__file__).resolve().parent.parent
KW = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=64, max_len=64)
MAXLEN = 48
PAGE = 16
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _module_hygiene():
    """The suite's conftest stops only the JAX package's pipelines."""
    yield
    GenerationPipeline.shutdown_all()
    t_faults.reset()
    j_faults.reset()
    reset_global_registry()


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    reset_global_registry()
    yield
    reset_global_registry()


# ------------------------------------------------------------- registry
def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("dl4j_x_total", "things done", label_names=("op",))
    c.labels(op="add").inc()
    c.labels(op="add").inc(2.5)
    c.labels(op="mul").inc()
    g = reg.gauge("dl4j_depth", "queue depth")
    g.set(7)
    g.dec(2)
    h = reg.histogram("dl4j_lat_seconds", "latency", label_names=("route",),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.05):
        h.labels(route="/gen").observe(v)
    reg.counter("dl4j_plain_total", "no labels").inc(3)
    return reg.render_prometheus()


def test_registry_exposition_is_byte_identical():
    assert _drive_registry(t_reg) == _drive_registry(j_reg)


# -------------------------------------------------------------- tracing
def _drive_spans(mod):
    sink = mod.TraceSink()
    with mod.span("request", sink=sink, route="/gen", n=3):
        with mod.span("prefill", sink=sink, slot=1):
            pass
        ctx = mod.current_context()
        with mod.span("decode_step", sink=sink, active=2) as sp:
            sp.set_attr("spec", False)
    mod.record_span("slot_wait", mod.now_us(), ctx=ctx, sink=sink, slot=0)
    mod.record_span("orphan", mod.now_us(), sink=sink)
    recs = sink.spans()
    index = {r.span_id: i for i, r in enumerate(recs)}
    return [(r.name, r.attrs, index.get(r.parent_id), r.depth, r.error)
            for r in recs]


def test_spans_record_the_same_names_attributes_and_parents():
    got = _drive_spans(t_tr)
    assert got == _drive_spans(j_tr)
    assert [g[0] for g in got] == ["prefill", "decode_step", "request",
                                   "slot_wait", "orphan"]


# --------------------------------------------------------------- faults
def _fault_sequence(mod, plan_spec, seed, calls=40):
    mod.reset()
    plan = mod.FaultPlan.parse(plan_spec, seed=seed)
    seq = []
    with mod.active(plan):
        for i in range(calls):
            point = ("generation.step", "train.step")[i % 2]
            before = dict(mod.snapshot()["injected"])
            try:
                mod.check(point)
                raised = None
            except mod.InjectedFault as e:
                raised = (e.kind, e.transient)
            after = mod.snapshot()["injected"]
            seq.append((point, raised, {k: after[k] - before.get(k, 0)
                                        for k in after
                                        if after[k] != before.get(k, 0)}))
    mod.reset()
    return seq


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_fires_the_same_sequence(seed):
    spec = ("generation.step:error:0.3:5,generation.step:crash:0.2:2,"
            "train.step:latency:0.5:3,generation.step:latency:0.25")
    got = _fault_sequence(t_faults, spec, seed)
    assert got == _fault_sequence(j_faults, spec, seed)
    assert any(r is not None for _p, r, _d in got)


# ------------------------------------------------------------------ QoS
class _Req:
    def __init__(self, i, tenant):
        self.i, self.tenant = i, tenant


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _qos_decisions(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    reg = mod.TenantRegistry(load_env=False)
    reg.configure({"a": mod.TenantPolicy("a", weight=2.0),
                   "b": mod.TenantPolicy("b", weight=1.0, priority=1),
                   "c": mod.TenantPolicy("c", weight=1.0,
                                         request_rate=2.0)})
    fq = mod.FairQueue(5, reg)
    log = []
    arrivals = ["a", "c", "c", "c", "a", "b", "a", "a", "b", "a", "a"]
    for i, t in enumerate(arrivals):
        req = _Req(i, t)
        try:
            log.append(("admit", t, reg.admit(t)))
        except mod.QuotaExceeded as e:
            log.append(("quota", t, e.quota))
            continue
        try:
            fq.put_nowait(req)
            log.append(("put", i))
        except queue.Full:
            victim = fq.pick_victim(req)
            log.append(("victim", i, None if victim is None else victim.i))
            if victim is not None:
                fq.put_nowait(req)
        log.append(("peek", fq.peek_priority(), fq.tenant_sizes()))
        clock.sleep(0.1)
    while fq.qsize():
        log.append(("pop", fq.get_nowait().i))
    return log


def test_qos_queue_makes_the_same_decisions(monkeypatch):
    got = _qos_decisions(t_qos, monkeypatch)
    assert got == _qos_decisions(j_qos, monkeypatch)
    assert any(d[0] == "quota" for d in got)
    assert any(d[0] == "victim" for d in got)


# ----------------------------------------------- breaker and retry policy
def _breaker_transitions(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    br = mod.CircuitBreaker("test.op", failure_threshold=2,
                            reset_timeout_seconds=5.0)
    log = []

    def note(what, value=None):
        log.append((what, value, br._state))

    try:
        for step in ("allow", "fail", "allow", "fail", "allow", "wait4",
                     "allow", "wait1", "allow", "allow", "fail", "wait5",
                     "allow", "ok", "allow", "fail", "ok"):
            if step == "allow":
                note(step, br.allow())
            elif step == "fail":
                br.record_failure()
                note(step)
            elif step == "ok":
                br.record_success()
                note(step)
            else:
                clock.sleep(float(step[4:]))
                note(step)
    finally:
        br.retire()
    return log


def _retry_transitions(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    pol = mod.RetryPolicy(max_retries=3, base_delay_seconds=0.01, seed=3)
    log = []
    fails = {"n": 0}

    def flaky():
        fails["n"] += 1
        log.append(("call", fails["n"], round(clock.t - 1000.0, 9)))
        if fails["n"] < 3:
            raise mod.TransientError("blip")
        return "done"

    log.append(("result", pol.call(flaky, op="test.op")))

    def fatal():
        log.append(("fatal", round(clock.t - 1000.0, 9)))
        raise RuntimeError("not transient")

    with pytest.raises(RuntimeError):
        pol.call(fatal, op="test.op")
    fails["n"] = -10
    with pytest.raises(mod.TransientError):
        pol.call(flaky, op="test.op")
    return log


def test_breaker_and_retry_make_the_same_transitions(monkeypatch):
    got = _breaker_transitions(t_policy, monkeypatch)
    assert got == _breaker_transitions(j_policy, monkeypatch)
    states = [s for _w, _v, s in got]
    assert {t_policy.CLOSED, t_policy.OPEN, t_policy.HALF_OPEN} <= set(
        states)
    got = _retry_transitions(t_policy, monkeypatch)
    assert got == _retry_transitions(j_policy, monkeypatch)


def test_typed_outcomes_keep_their_identity():
    """``models/generation.py`` raises these: the extended module keeps
    the classes and adds the rest of the reference's taxonomy."""
    from deeplearning4j_tpu_torch.resilience import policy
    assert tgen.CachePagesExhausted is policy.CachePagesExhausted
    assert issubclass(policy.CachePagesExhausted, policy.ShedError)
    assert issubclass(policy.ShedError, policy.ResilienceError)
    assert policy.TYPED_OUTCOMES == (policy.ShedError,
                                     policy.DeadlineExceeded,
                                     policy.ShutdownError,
                                     policy.CircuitOpenError)


# -------------------------------------------------------- compile watch
@pytest.mark.parametrize("case", ["bf16", "ints", "tree", "none"])
def test_signature_notation_matches_the_reference(case):
    shapes = {"bf16": [((1, 1024), "bfloat16")],
              "ints": [((4,), "int32"), ((4, 5), "int64")],
              "tree": [((2, 3), "float32"), ((7,), "uint8"), ((), "bool")],
              "none": []}[case]
    tens = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in shapes]
    jaxs = [np.zeros(s, dtype=jnp.dtype(d)) for s, d in shapes]
    if case == "tree":
        t_args = ({"w": tens[0], "b": [tens[1], tens[2]]}, None, {})
        j_args = ({"w": jaxs[0], "b": [jaxs[1], jaxs[2]]}, None, {})
    else:
        t_args, j_args = tuple(tens) or (None,), tuple(jaxs) or (None,)
    assert t_cw._signature(t_args) == j_cw._signature(j_args)


def _models():
    if "m" not in _CACHE:
        jm = jtr.TransformerLM(jtr.TransformerConfig(**KW))
        jp = jm.init_params(jax.random.key(0))
        cfg = ttr.TransformerConfig(**KW)
        tm = ttr.TransformerLM(cfg, device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                             device="cpu")
        _CACHE["m"] = (jm, jp, tm, tp)
    return _CACHE["m"]


def _port_engine(page_tokens=PAGE):
    _jm, _jp, tm, tp = _models()
    return tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=page_tokens,
                             device="cpu")


@pytest.mark.parametrize("page_tokens", [0, PAGE])
def test_compile_watch_counts_one_first_run_per_signature(page_tokens):
    eng = _port_engine(page_tokens)
    watch = t_cw.global_compile_watch()
    fn = tgen.DECODE_FN
    counts = []
    for slots in (2, 2, 3, 2, 3):
        st = eng.new_state(slots)
        z = np.zeros((slots,), np.int32)
        for s in range(slots):
            eng.ensure_slot_pages(st, s, 0)
        eng.decode(st, z, z, 0)
        counts.append(eng.decode_compile_count())
    assert counts == [1, 1, 2, 2, 2]
    for n in (5, 9, 20, 16, 33):                 # buckets 16, 16, 32, 16, 48
        eng.prefill(np.zeros((1, n), np.int32))
    assert watch.count_for(tgen.PREFILL_FN) == 3
    events = [e for e in watch.events() if e["fn"] == fn]
    assert [e["signature"] for e in events] == ["i64[2], i64[2]",
                                                "i64[3], i64[3]"]
    mode = "paged" if page_tokens else "dense"
    assert [e["attrs"]["mode"] for e in events] == [mode, mode]
    assert events[0]["first_compile_of_fn"] and \
        not events[1]["first_compile_of_fn"]
    # a second engine has its own signatures, as a second JAX engine has
    # its own jit caches
    eng2 = _port_engine(page_tokens)
    st = eng2.new_state(2)
    for s in range(2):
        eng2.ensure_slot_pages(st, s, 0)
    eng2.decode(st, np.zeros(2, np.int32), np.zeros(2, np.int32), 0)
    assert eng2.decode_compile_count() == 3


def test_concurrent_first_runs_note_one_signature():
    """The engine's signature set is shared by the decode thread and
    callers: 16 threads racing the first run of each of 300 signatures
    (switch interval shortened) note each exactly once."""
    import sys
    import threading
    eng = _port_engine()
    watch = t_cw.global_compile_watch()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        go = threading.Barrier(16)

        def run():
            go.wait(timeout=30)
            for j in range(300):
                eng._note_signature("race.fn", "paged", j, 1, torch.float32)

        threads = [threading.Thread(target=run, daemon=True)
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert watch.count_for("race.fn") == 300


# ----------------------------------------------------------- cost model
def _hand_flops(batch, window, positions, c=KW):
    """2·tokens·(L·(4d² + 2·d·d_ff) + d·V) + 4·d·L per (query, key)."""
    d, L, V = c["d_model"], c["n_layers"], c["vocab_size"]
    dff = 4 * d
    keys = sum(window * p + window * (window + 1) // 2 for p in positions)
    return (2 * batch * window * (L * (4 * d * d + 2 * d * dff) + d * V)
            + 4 * d * L * keys)


def _hand_bytes(batch, window, positions, kv_item, scaled, c=KW):
    """f32 weights once (every leaf of the reference's param tree but
    the position table), a position row a token, k and v rows of the
    context read and of the window written, f32 logits written."""
    d, L, V = c["d_model"], c["n_layers"], c["vocab_size"]
    _jm, jp, _tm, _tp = _models()
    weights = 4 * (sum(x.size for x in jax.tree.leaves(jp))
                   - jp["pos_emb"].size)
    row = 2 * (d * kv_item + (4 if scaled else 0))
    tokens = batch * window
    return (weights + tokens * d * 4 + L * row * (sum(positions) + tokens)
            + tokens * V * 4)


@pytest.mark.parametrize("slots,pos", [(1, 0), (4, 20), (4, 40)])
def test_decode_cost_matches_the_hand_formula(slots, pos):
    eng = _port_engine()
    st = eng.new_state(slots)
    positions = [pos + s for s in range(slots)]
    flops, nbytes = eng.step_cost(slots, 1, positions, torch.float32)
    assert flops == _hand_flops(slots, 1, positions)
    assert nbytes == _hand_bytes(slots, 1, positions, 4, False)
    q_flops, q_bytes = eng.step_cost(slots, 1, positions, torch.int8, True)
    assert q_flops == flops
    assert q_bytes == _hand_bytes(slots, 1, positions, 1, True)
    # accounted through the engine and the cost model, once per signature
    for s in range(slots):
        eng.ensure_slot_pages(st, s, positions[s])
    z = np.zeros((slots,), np.int32)
    pos_a = np.asarray(positions, np.int32)
    eng.decode(st, z, pos_a, 0)
    eng.account_decode(st, z, pos_a, 0)
    entry = t_cost.global_cost_model().entry(tgen.DECODE_FN)
    assert entry["flops"] == flops and entry["bytes_accessed"] == nbytes
    assert entry["source"] == "analytic" and entry["analyze_calls"] == 1
    eng.account_decode(st, z, pos_a + 1, 0)      # same signature: no-op
    assert t_cost.global_cost_model().entry(
        tgen.DECODE_FN)["analyze_calls"] == 1


@pytest.mark.parametrize("bucket", [16, 32, 48])
def test_prefill_cost_matches_the_hand_formula(bucket):
    eng = _port_engine()
    flops, nbytes = eng.prefill_cost(1, bucket)
    assert flops == _hand_flops(1, bucket, [0])
    assert nbytes == _hand_bytes(1, bucket, [0], 4, False)
    eng.prefill(np.zeros((1, bucket), np.int32))
    eng.account_prefill(1, bucket)
    assert t_cost.global_cost_model().flops_for(tgen.PREFILL_FN) == flops


def test_spec_cost_books_propose_and_verify_apart():
    eng = _port_engine()
    _jm, _jp, tm, tp = _models()
    draft = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=0,
                              device="cpu")
    spec = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=PAGE,
                             draft=draft, spec_k=3, device="cpu")
    st = spec.new_state(2)
    for s in range(2):
        spec.ensure_slot_pages(st, s, 3)
    z = np.zeros((2,), np.int32)
    spec.spec_step(st, z, z, 0, [0, 1])
    spec.account_spec(st, z, z, 0)
    cm = t_cost.global_cost_model()
    assert cm.flops_for(tgen.VERIFY_FN) == _hand_flops(2, 4, [0, 0])
    assert cm.flops_for(tgen.PROPOSE_FN) == sum(
        _hand_flops(2, 1, [j, j]) for j in range(3))
    assert eng.step_cost(2, 4, [0, 0], torch.float32)[0] == \
        cm.flops_for(tgen.VERIFY_FN)


def _xla_flops(kind, slots_or_batch, pos_or_bucket):
    """FLOPs of the JAX engine's paged decode step or prefill, from XLA's
    ``cost_analysis`` of its lowering (the reference's accounting)."""
    jm, jp, _tm, _tp = _models()
    if "jeng" not in _CACHE:
        _CACHE["jeng"] = jgen.DecodeEngine(jm, jp, max_len=MAXLEN,
                                           page_tokens=PAGE)
    je = _CACHE["jeng"]
    step = jnp.asarray(0, jnp.int32)
    if kind == "decode":
        st = je.new_state(slots_or_batch)
        z = jnp.zeros((slots_or_batch,), jnp.int32)
        pos = jnp.full((slots_or_batch,), pos_or_bucket, jnp.int32)
        low = je._decode_paged_jit.lower(je.params, st.arrays,
                                         je._tables(st), z, pos, step)
    else:
        toks = jnp.zeros((slots_or_batch, pos_or_bucket), jnp.int32)
        low = je._prefill_jit.lower(je.params, toks,
                                    jnp.asarray(pos_or_bucket - 1,
                                                jnp.int32), step)
    return j_cost.parse_cost_analysis(low.cost_analysis())[0]


#: XLA's count over the analytic one. XLA counts every FLOP the analytic
#: count holds (the same projections, MLP, head and attention products)
#: plus elementwise work (LayerNorm, GELU, softmax, the residual adds and
#: the sampler), and a decode step attends over the whole cache rather
#: than the live context, so the ratio is at least 1; at d_model 64 the
#: elementwise share is larger than at full width, and 1.25 bounds it
#: (this test's cases read 1.05-1.16). Bytes are not compared: the
#: reference's "bytes accessed" is counted on unoptimized HLO, every
#: intermediate tensor included.
XLA_FLOPS_BAND = (1.0, 1.25)


@pytest.mark.parametrize("kind,a,b", [("decode", 1, 0), ("decode", 4, 40),
                                      ("prefill", 1, 16),
                                      ("prefill", 1, 48)])
def test_cost_is_within_the_band_of_xla_cost_analysis(kind, a, b):
    eng = _port_engine()
    ours = (eng.step_cost(a, 1, [b] * a, torch.float32)[0]
            if kind == "decode" else eng.prefill_cost(a, b)[0])
    ratio = _xla_flops(kind, a, b) / ours
    assert XLA_FLOPS_BAND[0] <= ratio <= XLA_FLOPS_BAND[1], ratio


def test_cost_model_live_mfu_and_gpu_peak(monkeypatch):
    """MFU = FLOPs / (mean seconds × peak); the platform comes from the
    accounted step's device, and the ``gpu`` row is the H100's."""
    monkeypatch.delenv("DL4J_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("DL4J_TPU_HBM_GBPS", raising=False)
    assert t_cost._PEAK_DEFAULTS["gpu"] == (989e12, 3.35e12)
    try:
        t_cost.note_device(torch.device("cuda", 0))
        assert t_cost.peak_flops() == 989e12
        t_cost.note_device(torch.device("cpu"))
        monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "1e9")
        cm = t_cost.CostModel()
        cm.account("f", lambda: (2e6, 1e6))
        cm.observe_time("f", 0.001)
        cm.observe_time("f", 0.003)
        snap = cm.snapshot()
        assert snap["platform"] == "cpu"
        assert snap["fns"]["f"]["mfu"] == pytest.approx(2e6 / (0.002 * 1e9))
        assert snap["fns"]["f"]["roofline_verdict"] in ("compute_bound",
                                                        "memory_bound")
    finally:
        t_cost.note_device(torch.device("cpu"))


def test_device_memory_reports_nothing_without_cuda():
    t_mem.reset_for_tests()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU contract does not apply")
    assert t_mem.snapshot() == {"devices": []}
    assert not t_mem.sample(min_interval_s=0.0)
    t_mem.reset_for_tests()


def test_postmortem_bundle_writes_every_section(tmp_path):
    """Each section of a bundle is written, none as an ``.error`` file (no
    lazy import fails into its ``except``), and ``config.json`` and
    ``numerics.json`` carry the reference's keys: the async-runtime knobs
    the fit loops read, and the numerics switches."""
    import json
    from deeplearning4j_tpu_torch.observability.flight_recorder import (
        FlightRecorder)
    from deeplearning4j_tpu_torch.observability import numerics as t_num
    t_num.tracker().record_nonfinite("transformer", "loss", 3)
    bundle = Path(FlightRecorder(hang_seconds=60,
                                 out_dir=str(tmp_path)).dump("test"))
    names = sorted(p.name for p in bundle.iterdir())
    assert not [n for n in names if n.endswith(".error")], names
    assert {"config.json", "numerics.json", "compiles.json",
            "resilience.json", "trace.json"} <= set(names)
    cfg = json.loads((bundle / "config.json").read_text())
    assert cfg["reason"] == "test"
    assert {"async_enabled", "prefetch_depth", "score_sync_every",
            "numerics_enabled"} <= set(cfg["async_runtime"])
    num = json.loads((bundle / "numerics.json").read_text())
    assert set(num) == {"enabled", "skip_on_nonfinite", "nonfinite_events",
                        "last_published"}
    assert num["nonfinite_events"][0]["kind"] == "loss"


def test_divergence_rule_grades_as_the_reference():
    """The same non-finite event in each package's tracker: each
    DivergenceRule grades FAILING with the same value and detail, and OK
    once the trackers are cleared."""
    from deeplearning4j_tpu.observability import numerics as j_num
    from deeplearning4j_tpu_torch.observability import numerics as t_num
    got = []
    for mod, reg in ((j_num, j_reg.MetricsRegistry()),
                     (t_num, t_reg.MetricsRegistry())):
        mod.tracker().clear()
        mod.tracker().record_nonfinite("transformer", "grad", 0)
        bad = mod.DivergenceRule()._evaluate(reg)
        mod.tracker().clear()
        got.append((bad, mod.DivergenceRule()._evaluate(reg)))
    assert got[0] == got[1]
    assert got[1][0]["status"] == "failing" and got[1][1]["status"] == "ok"


# --------------------------------------------------------- public names
def _public(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if t.id == "__all__":
                        return set(ast.literal_eval(node.value))
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


_NET = "waits with the rest of the DL4J network stack: ROADMAP queue 1 item 8"
_NO_LOWERING = ("no AOT re-lowering in the port: the cost thunk counts "
                "analytically and runs nothing")
#: module → (reference-only names, port-only names), each with a reason
COPIED = {
    "observability/registry": ({}, {}),
    "observability/trace_store": ({}, {}),
    "observability/tracing": ({}, {}),
    "observability/slo": ({}, {}),
    "observability/straggler": ({}, {}),
    "observability/flight_recorder": ({}, {}),
    "observability/train_metrics": ({}, {}),
    "observability/device_memory": ({}, {}),
    "observability/numerics": ({}, {}),
    "observability/compile_watch": (
        {"suppress_probes": _NO_LOWERING,
         "probes_suppressed": _NO_LOWERING}, {}),
    "observability/cost_model": (
        {"parse_cost_analysis": "no XLA cost_analysis to parse"},
        {"note_device": "the port reads the platform from the accounted "
                        "step's device, not jax.devices()"}),
    "observability/__init__": ({}, {}),
    "observability/profile_capture": ({}, {}),
    "profiler/xprof": (
        {}, {"TRACE_FILE": "the Chrome-trace file stop() writes: "
                           "torch.profiler exports one JSON where "
                           "jax.profiler writes an XPlane directory"}),
    "profiler/performance": ({}, {}),
    "profiler/__init__": ({}, {}),
    "profiler/op_profiler": ({}, {}),
    "autodiff/__init__": ({}, {}),
    "autodiff/samediff": ({}, {}),
    "autodiff/passes": ({}, {}),
    "autodiff/validation": ({}, {}),
    "autodiff/flatgraph": ({}, {}),
    "modelimport/tfimport": ({}, {}),
    "modelimport/tf_v1_control_flow": ({}, {}),
    "modelimport/common": ({}, {}),
    "ops/registry": (
        {}, {"UnknownOpError": "the KeyError get() raises, naming the "
                               "op"}),
    "ops/extended": (
        {}, {"ctc_loss_lattice": "optax's CTC lattice, which the reference "
                                 "imports",
             "sample_gamma": "a gamma sampler drawing from a generator "
                             "(torch's takes none)"}),
    "ops/longtail": ({}, {}),
    "ops/tranche4": (
        {}, {"generator_for": "the drawing ops' generator (the reference "
                              "reads its global random state)",
             "vjp": "autograd standing for jax.vjp in the _bp ops",
             "resize_weights": "jax.image.resize's weight matrices, which "
                               "the reference calls"}),
    "ops/tranche5": ({}, {}),
    "ops/tranche6": (
        {"jax_vmap_scatter": "a jax.vmap helper: the port scatters with "
                             "one torch.scatter"}, {}),
    "modelimport/onnx_proto": ({}, {}),
    "modelimport/onnximport": ({}, {}),
    "observability/timeseries": ({}, {}),
    "observability/watchtower": ({}, {}),
    "observability/federation": ({}, {}),
    "resilience/faults": ({}, {}),
    "resilience/policy": ({}, {}),
    "resilience/qos": ({}, {}),
    "resilience/__init__": (
        {n: "resilience.elastic: ROADMAP queue 1 item 7" for n in (
            "ElasticCheckpointer", "HostLostError", "elastic_enabled")},
        {}),
    "resilience/recovery": ({}, {}),
    "utils/preemption": ({}, {}),
    "serving/session": ({}, {}),
    "serving/__init__": ({}, {}),
    "serving/errors": ({}, {}),
    "serving/metrics": ({}, {}),
    "serving/rollout": ({}, {}),
    "serving/router": ({}, {}),
    "serving/registry": ({}, {}),
    "serving/idempotency": ({}, {}),
    "serving/shared_state": ({}, {}),
    "serving/frontdoor": (
        {}, {"default_bind_host": "the UI server's one-line knob reader, "
                                  "copied beside its user: the UI server "
                                  "is not ported"}),
    "parallel/inference": ({}, {}),
    "parallel/generation": ({}, {}),
    "async_runtime": (
        {"compile_cache_dir": "no XLA compile cache",
         "configure_compile_cache": "no XLA compile cache"}, {}),
    "optim/listeners": ({}, {}),
    "optim/earlystopping": ({}, {}),
    "optim/solvers": ({}, {}),
    "eval/classification": ({}, {}),
    "eval/regression": ({}, {}),
    "eval/__init__": ({}, {}),
    "data/iterators": ({}, {}),
    "data/normalizers": (
        {}, {"NORMALIZERS": "normalizer.json's type -> class, which the "
                            "reference's restore_normalizer keeps inline"}),
    "data/mnist": ({}, {}),
    "data/vision": ({}, {}),
    "utils/serialization": ({}, {}),
    "modelimport/dl4j_zip": ({}, {}),
    "nn/transferlearning": ({}, {}),
    "data/dataset": ({}, {}),
    "nn/conf/inputs": ({}, {}),
    "nn/conf/preprocessors": ({}, {}),
    "nn/conf/dropout": ({}, {}),
    "nn/conf/configuration": ({}, {}),
    "nn/conf/layers": ({}, {}),
    "nn/conf/layers2": ({}, {}),
    "nn/conf/objdetect": (
        {n: "a jnp helper: the port calls torch.sigmoid and compares "
            "torch.arange" for n in ("jax_sigmoid", "jax_one_hot")}, {}),
    "nn/conf/variational": ({}, {}),
    "nn/graph_conf": ({}, {}),
    "nn/weightnoise": ({}, {}),
    "nn/params": (
        {"param_layout": "the port's flat order is leaf_keys'"},
        {n: "tree <-> tensor helpers the JAX package has from jax.tree "
            "and jnp.asarray" for n in ("leaf_keys", "to_tensor",
                                        "tree_to_device", "tree_to_numpy")}),
    "nn/activations": ({}, {}),
    "nn/losses": ({}, {}),
    "nn/weights": ({}, {}),
    "nn/_precision": ({}, {}),
    "nn/_step_tail": ({}, {}),
    "nn/multilayer": ({"log": "the port's fit loop logs nothing"}, {}),
    "nn/graph": ({}, {}),
    "optim/schedules": ({}, {}),
    "optim/updaters": ({}, {}),
    "models/zoo/base": ({}, {}),
    "models/zoo/resnet": ({}, {}),
    "models/zoo/cnn_small": ({}, {}),
    "models/zoo/vgg": ({}, {}),
    "models/zoo/darknet": ({}, {}),
    "models/zoo/squeezenet": ({}, {}),
    "models/zoo/unet": ({}, {}),
    "models/zoo/xception": ({}, {}),
    "models/zoo/inception": ({}, {}),
    "models/zoo/facenet": ({}, {}),
    "models/zoo/__init__": ({}, {}),
    "ndarray/ndarray": ({}, {
        **{n: "jnp's reduction with 64-bit types off, over torch" for n in (
            "r_sum", "r_mean", "r_prod", "r_max", "r_min", "r_var", "r_std",
            "r_argmax", "r_argmin", "r_cumsum", "r_cumprod", "r_quantile",
            "r_sort")},
        "as_tensor": "jnp.asarray with 64-bit types off, on a device",
        "np_to_tensor": "jnp.asarray of host data with 64-bit types off",
        "getitem": "numpy's basic indexing (negative steps) over torch",
        "setitem": "numpy's indexed assignment (negative steps) over torch",
        "matmul": "jnp.matmul with the reference's preferred_element_type",
        "rev_dims": "jnp's .T at any rank",
        "cast": "XLA's float-to-int conversion (saturating) over torch",
        **{n: "the device arrays are made on: JAX_PLATFORMS' counterpart"
           for n in ("set_default_device", "default_device", "device_of")}}),
    "ndarray/factory": ({}, {
        n: "the device arrays are made on: JAX_PLATFORMS' counterpart"
        for n in ("setDefaultDevice", "getDefaultDevice")}),
    "ndarray/random": ({}, {"seeded": "a generator at an explicit seed, "
                                      "jax.random.key's counterpart"}),
    "ndarray/dtypes": ({}, {
        "canonical": "the 64-bit narrowing jnp applies",
        "to_torch": "the torch type that stores a dtype",
        "from_torch": "the NDArray-facing dtype of a torch type",
        "storage": "the narrowed storage type and jnp's UserWarning"}),
    **{m: ({}, {}) for m in (
        "ndarray/indexing", "ndarray/executioner", "ndarray/parity",
        "ndarray/surface", "ndarray/surface4", "ndarray/surface5",
        "ndarray/__init__", "ops/transforms", "interop/runners",
        "interop/__init__")},
}


@pytest.mark.parametrize("module", sorted(COPIED))
def test_public_names_equal_the_reference(module):
    ref_only, port_only = COPIED[module]
    ref = _public(ROOT / "deeplearning4j_tpu" / f"{module}.py")
    port = _public(ROOT / "deeplearning4j_tpu_torch" / f"{module}.py")
    assert all(ref_only.values()) and all(port_only.values())
    assert set(ref_only) <= ref and set(port_only) <= port
    assert port - set(port_only) == ref - set(ref_only)
