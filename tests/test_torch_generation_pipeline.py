"""The port's GenerationPipeline against the JAX package's, at a tiny size.

Greedy tokens through the port's continuous-batching pipeline (several
concurrent requests, dense and paged caches, speculative decoding off and
on) are held to exact equality with the JAX engine's greedy tokens for
each prompt alone, the same weights crossing by ``from_jax_params``. Then
port twins of the JAX package's pipeline tests (``tests/test_generation.py``,
``tests/test_paged_decode.py``, ``tests/test_sessions.py``) assert what
their originals assert, on the port; the fault drill's streams are held
exact under greedy and seeded top-k sampling; and the decode thread is
shown to record no autograd graph.

Every pipeline is shut down by a ``with`` block, a ``finally`` or the
module fixture, and every join is bounded.
"""
import threading
import time

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.models import generation as jgen
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.serving.shared_state import SharedStore
import torch

from deeplearning4j_tpu_torch.models import generation as tgen
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import from_jax_params
from deeplearning4j_tpu_torch.observability import (compile_watch,
                                                    global_registry,
                                                    reset_global_registry)
from deeplearning4j_tpu_torch.parallel.generation import (
    GenerationPipeline, _GenRequest)
from deeplearning4j_tpu_torch.resilience import faults, qos
from deeplearning4j_tpu_torch.resilience.faults import (FaultPlan,
                                                        FaultSpec,
                                                        InjectedFault)
from deeplearning4j_tpu_torch.resilience.policy import (CachePagesExhausted,
                                                        CircuitOpenError,
                                                        DeadlineExceeded,
                                                        ShedError,
                                                        ShutdownError)
from deeplearning4j_tpu_torch.serving import session as _sess
from deeplearning4j_tpu_torch.tree import tree_map

VOCAB = 256
KW = dict(vocab_size=VOCAB, n_layers=2, n_heads=4, d_model=64, max_len=64)
MAXLEN = 48
PAGE = 16
JOIN_S = 60.0
_CACHE = {}


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


def _draft():
    """A 1-layer truncation of the target sharing its embeddings, dense
    cache (as the draft ``chip_smoke.py`` builds at full width)."""
    if "draft" not in _CACHE:
        _jm, _jp, tm, tp = _models()
        cfg = ttr.TransformerConfig(**dict(KW, n_layers=1))
        dp = {"tok_emb": tp["tok_emb"], "pos_emb": tp["pos_emb"],
              "ln_f": tp["ln_f"], "blocks": tp["blocks"][:1]}
        _CACHE["draft"] = tgen.DecodeEngine(
            ttr.TransformerLM(cfg, device="cpu"), dp, max_len=MAXLEN,
            page_tokens=0, device="cpu")
    return _CACHE["draft"]


def _engine(kind="paged"):
    """Module-level port engines (``dense``, ``paged``, ``spec``: paged
    with an identity draft, accept ratio 1.0, as the JAX suite's;
    ``spec1`` and ``spec1_dense``: a 1-layer truncated draft over paged
    and dense target caches)."""
    if kind not in _CACHE:
        _jm, _jp, tm, tp = _models()
        kw = {"dense": dict(page_tokens=0), "paged": dict(page_tokens=PAGE)}
        if kind == "spec":
            ident = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=0,
                                      device="cpu")
            kw[kind] = dict(page_tokens=PAGE, draft=ident, spec_k=3)
        if kind == "spec1":
            kw[kind] = dict(page_tokens=PAGE, draft=_draft(), spec_k=3)
        if kind == "spec1_dense":
            kw[kind] = dict(page_tokens=0, draft=_draft(), spec_k=3)
        _CACHE[kind] = tgen.DecodeEngine(tm, tp, max_len=MAXLEN,
                                         device="cpu", **kw[kind])
    return _CACHE[kind]


def _jax_tokens(prompt, n):
    """The JAX engine's greedy tokens for ``prompt`` alone."""
    if "jax" not in _CACHE:
        jm, jp, _tm, _tp = _models()
        _CACHE["jax"] = jgen.DecodeEngine(jm, jp, max_len=MAXLEN)
    return np.asarray(_CACHE["jax"].generate(prompt[None], n))[0]


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (n,)).astype(np.int32)


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    reset_global_registry()
    _sess.reset_for_tests()
    yield
    faults.clear()
    GenerationPipeline.shutdown_all()
    _sess.reset_for_tests()


@pytest.fixture(autouse=True, scope="module")
def _module_hygiene():
    """The suite's conftest stops only the JAX package's pipelines: a
    leaked port decode thread would hold an xdist worker."""
    yield
    GenerationPipeline.shutdown_all()
    reset_global_registry()


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a request hung"


def _concurrent(gp, prompts, n_new, stagger_s=0.0, **kw):
    """One client thread a prompt; returns each request's tokens or
    exception, in prompt order."""
    out = [None] * len(prompts)

    def run(i):
        try:
            out[i] = gp.generate(prompts[i], max_new_tokens=n_new, **kw)
        except BaseException as e:       # the caller asserts on it
            out[i] = e

    threads = [threading.Thread(daemon=True, target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
        time.sleep(stagger_s)
    _join(threads)
    return out


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("kind", ["dense", "paged", "spec1", "spec1_dense"])
def test_pipeline_greedy_tokens_equal_jax_engine_alone(kind):
    """Six concurrent requests over 3 slots (joins mid-decode, prompts in
    three buckets): each request's tokens equal the JAX engine's greedy
    tokens for its prompt alone."""
    eng = _engine(kind)
    assert eng.spec == kind.startswith("spec")
    prompts = [_prompt(n, seed=n) for n in (5, 9, 20, 3, 33, 14)]
    with GenerationPipeline(eng, slots=3, max_new_tokens=10) as gp:
        got = _concurrent(gp, prompts, 10, stagger_s=0.003)
        assert gp._cache.alloc is None or gp._cache.alloc.in_use == 0
    for p, g in zip(prompts, got):
        assert isinstance(g, np.ndarray), g
        np.testing.assert_array_equal(g, _jax_tokens(p, 10))


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("sampler", ["greedy", "topk"])
def test_fault_mid_run_resumes_the_fault_free_stream(sampler, spec):
    """A crash at ``generation.step`` after the 5th token of one of two
    concurrent requests: the cache is rebuilt, both journaled sessions
    are restored in their slots (prompt + the emitted tokens but the
    last re-prefilled, the draft's too in spec mode, the last carried)
    and the failed step runs again with the same step number, so
    both streams equal the fault-free run's, under greedy and under
    seeded top-k sampling."""
    _jm, _jp, tm, tp = _models()
    s = (tgen.SamplerConfig() if sampler == "greedy" else
         tgen.SamplerConfig("topk", top_k=5, temperature=0.8))
    kw = dict(draft=_draft(), spec_k=3) if spec else {}
    eng = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=PAGE,
                            sampler=s, seed=3, device="cpu", **kw)
    prompts = [_prompt(7, seed=1), _prompt(12, seed=2)]

    def run(with_fault):
        plan = FaultPlan([FaultSpec("generation.step", "crash", rate=1.0,
                                    count=1)])
        fired = []

        def on_token(tok, i):
            if with_fault and i == 4 and not fired:
                fired.append(i)
                faults.install(plan)

        # both requests join at step 0, whatever the threads' timing: the
        # first prefill waits until the second request is queued
        entered, gate = threading.Event(), threading.Event()

        def prefill(x, step=0):
            entered.set()
            gate.wait(JOIN_S)
            return tgen.DecodeEngine.prefill(eng, x, step=step)

        eng.prefill = prefill
        with GenerationPipeline(eng, slots=2, max_new_tokens=14) as gp:
            outs = [None, None]

            def one(i):
                kw = {"on_token": on_token} if i == 0 else {}
                outs[i] = gp.generate(prompts[i], **kw).tolist()

            ts = [threading.Thread(daemon=True, target=one, args=(i,)) for i in (0, 1)]
            ts[0].start()
            assert entered.wait(JOIN_S)
            ts[1].start()
            deadline = time.monotonic() + JOIN_S
            while gp._queue.qsize() < 1 and time.monotonic() < deadline:
                time.sleep(0.001)
            gate.set()
            _join(ts)
            assert gp._cache.alloc.in_use == 0
        del eng.prefill
        faults.clear()
        return outs, bool(fired)

    base, _ = run(False)
    got, fired = run(True)
    assert fired
    assert faults.snapshot()["injected"].get("generation.step:crash") == 1
    assert got == base


def test_decode_thread_records_no_autograd_graph():
    """The decode loop runs under ``torch.inference_mode`` (thread-local
    state a new thread does not inherit): with weights that require
    grad, its tensors (cache, logits, tokens) have no ``grad_fn``."""
    _jm, _jp, tm, tp = _models()
    eng = tgen.DecodeEngine(tm, tree_map(torch.clone, tp), max_len=MAXLEN,
                            page_tokens=PAGE, device="cpu")
    for t in (eng.params["tok_emb"], eng.params["blocks"][0]["attn"]["wo"]):
        t.requires_grad_(True)
    seen = []
    real = eng.decode

    def decode(cache, tokens, positions, step):
        out = real(cache, tokens, positions, step)
        seen.append((torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
                     out[0], out[1], cache.arrays["k"]))
        return out

    eng.decode = decode
    with GenerationPipeline(eng, slots=2, max_new_tokens=5) as gp:
        gp.generate(_prompt(6))
    assert seen
    for grad_on, inference, *tensors in seen:
        assert not grad_on and inference
        for t in tensors:
            assert not t.requires_grad and t.grad_fn is None
    # the same step on the caller's thread does record one
    st = eng.new_state(1)
    _f, _l, kv, t = eng.prefill(_prompt(6)[None])
    eng.insert_slot(st, kv, 0)
    _tok, logits, _st = real(st, np.zeros(1, np.int32),
                             np.full(1, t, np.int32), 0)
    assert logits.grad_fn is not None


# ----------------------------------------- twins of tests/test_generation.py
def test_eos_stops_early_and_budget_caps_to_cache():
    eng = _engine("paged")
    prompt = _prompt(7, seed=2)
    ref = eng.generate(prompt[None], 10)[0]
    eos = int(ref[0])
    out = eng.generate(prompt[None], 10, eos_id=eos)[0]
    assert eos in out and len(out) < 10
    assert np.array_equal(out, ref[:len(out)])
    never = next(t for t in range(VOCAB) if t not in set(ref.tolist()))
    assert np.array_equal(eng.generate(prompt[None], 10, eos_id=never)[0],
                          ref)
    # a 40-token prompt in a 48-token cache can only decode 8 tokens
    with GenerationPipeline(eng, slots=2, max_new_tokens=32) as gp:
        out = gp.generate(_prompt(40, seed=4), max_new_tokens=32)
        assert len(out) == MAXLEN - 40


def test_zero_steady_state_decode_recompiles():
    """After one request has run a prefill bucket and the decode step,
    further traffic (mixed sizes inside the same buckets) runs at no new
    step signature."""
    eng = _engine("paged")
    watch = compile_watch.global_compile_watch()
    with GenerationPipeline(eng, slots=3, max_new_tokens=6) as gp:
        gp.generate(_prompt(5), max_new_tokens=6)      # bucket 16
        gp.generate(_prompt(17), max_new_tokens=6)     # bucket 32
        before = {fn: watch.count_for(fn)
                  for fn in ("TransformerLM.prefill",
                             "TransformerLM.decode_step")}
        threads = [threading.Thread(
            daemon=True, target=gp.generate, args=(_prompt(3 + i),),
            kwargs={"max_new_tokens": 5}) for i in range(6)]
        for t in threads:
            t.start()
        _join(threads)
        after = {fn: watch.count_for(fn) for fn in before}
    assert before == after, f"steady-state retraced: {before} -> {after}"


def test_queue_full_sheds_and_deadline_walk_away():
    eng = _engine("paged")
    gp = GenerationPipeline(eng, slots=1, max_new_tokens=24,
                            max_queue_depth=1, shed_policy="reject_newest")
    try:
        results = []

        def long_one():
            try:
                results.append(("ok", gp.generate(_prompt(5),
                                                  max_new_tokens=24)))
            except Exception as e:
                results.append(("err", e))

        threads = [threading.Thread(daemon=True, target=long_one) for _ in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.01)
        with pytest.raises((DeadlineExceeded, ShedError)):
            gp.generate(_prompt(4), max_new_tokens=24, deadline_ms=1.0)
        _join(threads)
        assert len(results) == 6
        kinds = [k for k, _ in results]
        assert kinds.count("ok") >= 1
        for k, v in results:
            if k == "err":
                assert isinstance(v, (ShedError, DeadlineExceeded))
    finally:
        gp.shutdown()
    with pytest.raises(ShutdownError):
        gp.generate(_prompt(3))
    with GenerationPipeline(eng, slots=1, max_new_tokens=43) as gp2:
        t = threading.Thread(daemon=True, target=lambda: gp2.generate(
            _prompt(5), max_new_tokens=43))
        t.start()
        time.sleep(0.01)                 # the long request owns the slot
        with pytest.raises(DeadlineExceeded):
            gp2.generate(_prompt(4), max_new_tokens=16, deadline_ms=4.0)
        _join([t])


def test_prompt_too_long_is_a_value_error():
    eng = _engine("paged")
    with GenerationPipeline(eng, slots=1) as gp:
        with pytest.raises(ValueError):
            gp.generate(_prompt(60))        # > largest prefill bucket (48)


def _chaos(gp):
    outcomes = []
    lock = threading.Lock()

    def one(i):
        try:
            out = gp.generate(_prompt(3 + (i * 5) % 28, seed=i),
                              max_new_tokens=4 + i % 9,
                              deadline_ms=20000.0 if i % 4 else 3000.0)
            with lock:
                outcomes.append(("ok", len(out)))
        except (ShedError, DeadlineExceeded, CircuitOpenError,
                ShutdownError) as e:
            with lock:
                outcomes.append(("typed", type(e).__name__))
        except InjectedFault as e:
            with lock:
                outcomes.append(("injected", e.kind))
        except Exception as e:     # pragma: no cover - must not happen
            with lock:
                outcomes.append(("UNEXPECTED", repr(e)))

    threads = [threading.Thread(daemon=True, target=one, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    _join(threads)
    assert len(outcomes) == 12              # exactly once each
    assert not [o for o in outcomes if o[0] == "UNEXPECTED"], outcomes
    assert any(k == "ok" for k, _ in outcomes)


def _chaos_plan():
    return FaultPlan([
        FaultSpec("generation.step", "error", rate=0.3, count=4),
        FaultSpec("generation.step", "crash", rate=0.15, count=2),
        FaultSpec("generation.step", "latency", rate=0.2, count=3,
                  latency_seconds=0.02),
    ], seed=11)


def test_continuous_batching_chaos_drill():
    """Faults at ``generation.step`` with per-request deadlines and mixed
    lengths: every concurrent request resolves EXACTLY once — a token
    array, a typed outcome, or the injected fault — and none hang."""
    eng = _engine("paged")
    with faults.active(_chaos_plan()):
        gp = GenerationPipeline(eng, slots=3, max_new_tokens=10,
                                max_queue_depth=8,
                                shed_policy="reject_newest")
        try:
            _chaos(gp)
        finally:
            gp.shutdown()
    injected = faults.snapshot()["injected"]
    assert any(k.startswith("generation.step") for k in injected), injected


def test_generation_kill_switch_runs_without_policies(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_RESILIENCE", "0")
    eng = _engine("paged")
    ref = eng.generate(_prompt(5)[None], 6)[0]
    with GenerationPipeline(eng, slots=2, max_new_tokens=6,
                            max_queue_depth=1,
                            shed_policy="reject_newest") as gp:
        assert gp._breaker is None and gp._shed_policy is None
        out = gp.generate(_prompt(5), max_new_tokens=6,
                          deadline_ms=0.0001)   # deadline ignored
        assert np.array_equal(out, ref)


def test_generation_snapshot_surfaces():
    import json as _json
    eng = _engine("paged")
    with GenerationPipeline(eng, slots=2, max_new_tokens=4) as gp:
        gp.generate(_prompt(5), max_new_tokens=4)
        snap = gp.snapshot()
        _json.dumps(snap)
        assert snap["slots"] == 2
        assert snap["cache_bytes"] == 0
        assert snap["pool_bytes"] > 0
        assert snap["pages"]["total"] > 0
        assert snap["pages"]["in_use"] == 0
        assert snap["pages"]["page_tokens"] == eng.page_tokens
        assert len(snap["slot_table"]) == 2
        assert snap["sampler"]["kind"] == "greedy"
        assert GenerationPipeline.live_snapshots()


# --------------------------------------- twins of tests/test_paged_decode.py
def test_admission_by_pages_waiting_joiner_completes():
    """Three full-length streams into a pool that backs exactly two: the
    third WAITS for pages and completes once a stream drains."""
    eng = _engine("paged")
    gp = GenerationPipeline(eng, slots=3, max_new_tokens=8,
                            cache_pages=2 * eng.pages_per_slot)
    try:
        got = _concurrent(gp, [_prompt(40, seed=i) for i in range(3)], 8,
                          stagger_s=0.05)
        assert [len(g) for g in got] == [8, 8, 8]
        assert gp._cache.alloc.in_use == 0
        shed = global_registry().get("dl4j_decode_shed_total")
        series = {lv: c.value for lv, c in shed.series()}
        assert series.get(("pages_exhausted",), 0) == 0
    finally:
        gp.shutdown()


def test_page_exhaustion_sheds_typed_then_admission_resumes():
    eng = _engine("paged")
    gp = GenerationPipeline(eng, slots=4, max_new_tokens=36,
                            cache_pages=6, queue_limit=16)
    try:
        got = _concurrent(gp, [_prompt(20, seed=i) for i in range(8)], 25)
        kinds = ["ok" if isinstance(g, np.ndarray) else
                 "pages" if isinstance(g, CachePagesExhausted) else
                 "shed" if isinstance(g, ShedError) else repr(g)
                 for g in got]
        assert set(kinds) <= {"ok", "pages", "shed"}, kinds
        assert kinds.count("ok") >= 3
        assert "pages" in kinds
        assert gp._cache.alloc.in_use == 0
        assert len(gp.generate(_prompt(10), max_new_tokens=10)) == 10
        shed = global_registry().get("dl4j_decode_shed_total")
        assert shed.labels(reason="pages_exhausted").value > 0
    finally:
        gp.shutdown()


def test_reclamation_victim_is_the_youngest_request():
    eng = _engine("paged")
    gp = GenerationPipeline(eng, slots=2, max_new_tokens=40,
                            cache_pages=4)
    try:
        results = {}

        def run(name, prompt, budget):
            try:
                results[name] = gp.generate(prompt, max_new_tokens=budget)
            except BaseException as e:
                results[name] = e

        elder = threading.Thread(
            daemon=True, target=run, args=("elder", _prompt(9, seed=1), 30))
        elder.start()
        deadline = time.monotonic() + 20
        while gp._n_active() == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        younger = threading.Thread(
            daemon=True, target=run, args=("younger", _prompt(20, seed=2), 25))
        younger.start()
        _join([elder, younger])
        assert isinstance(results["younger"], CachePagesExhausted), results
        assert isinstance(results["elder"], np.ndarray) \
            and len(results["elder"]) == 30
        assert gp._cache.alloc.in_use == 0
    finally:
        gp.shutdown()


def test_priority_preempts_for_pages():
    eng = _engine("paged")
    qos.global_tenants().configure(
        {"low": qos.TenantPolicy("low", priority=0),
         "hi": qos.TenantPolicy("hi", priority=2)})
    try:
        gp = GenerationPipeline(eng, slots=4, max_new_tokens=40,
                                cache_pages=eng.pages_per_slot)
        results = {}

        def low():
            try:
                results["low"] = gp.generate(_prompt(9, seed=1),
                                             max_new_tokens=30,
                                             tenant="low")
            except BaseException as e:
                results["low"] = e

        t = threading.Thread(target=low, daemon=True)
        t.start()
        deadline = time.monotonic() + 20
        while gp._n_active() == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert gp._n_active() == 1
        out = gp.generate(_prompt(40, seed=2), max_new_tokens=4,
                          tenant="hi")
        assert len(out) == 4
        _join([t])
        assert isinstance(results["low"], qos.PreemptedError), results
        assert gp._cache.alloc.in_use == 0
        gp.shutdown()
    finally:
        qos.global_tenants().configure({})


def test_prompt_that_can_never_fit_is_a_value_error():
    eng = _engine("paged")
    with GenerationPipeline(eng, slots=2, cache_pages=eng.pages_per_slot,
                            max_new_tokens=4) as gp:
        assert eng.pages_per_slot == 3    # MAXLEN / PAGE
        out = gp.generate(_prompt(9), max_new_tokens=4)
        assert len(out) == 4
    with pytest.raises(ValueError):
        GenerationPipeline(eng, slots=1, cache_pages=1)


def test_pages_and_spec_metrics_and_snapshot():
    eng = _engine("spec")
    with GenerationPipeline(eng, slots=2, max_new_tokens=8) as gp:
        ref = _engine("dense").generate(_prompt(6)[None], 8)[0]
        out = gp.generate(_prompt(6), max_new_tokens=8)
        assert np.array_equal(out, ref)    # spec pipeline byte-identical
        snap = gp.snapshot()
        assert snap["pages"]["total"] == 2 * eng.pages_per_slot
        assert snap["pages"]["in_use"] == 0
        assert snap["pages"]["page_tokens"] == PAGE
        assert snap["spec"]["enabled"] and snap["spec"]["spec_k"] == 3
        assert snap["spec"]["accept_ratio"] == 1.0   # identity draft
        assert snap["cache_bytes"] == 0 and snap["pool_bytes"] > 0
        reg = global_registry()
        assert reg.get("dl4j_decode_pages_capacity").value >= \
            2 * eng.pages_per_slot
        assert reg.get("dl4j_spec_accept_ratio").value == 1.0
        deadline = time.monotonic() + 5.0
        while (reg.get("dl4j_decode_pages_in_use").value != 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert reg.get("dl4j_decode_pages_in_use").value == 0
        assert reg.get("dl4j_decode_cache_bytes").value == 0


def test_zero_steady_state_retraces_paged_and_spec():
    eng = _engine("spec")
    watch = compile_watch.global_compile_watch()
    with GenerationPipeline(eng, slots=3, max_new_tokens=6) as gp:
        gp.generate(_prompt(5), max_new_tokens=6)      # bucket 16
        gp.generate(_prompt(17), max_new_tokens=6)     # bucket 32
        fns = ("TransformerLM.prefill", "TransformerLM.decode_step",
               "TransformerLM.spec_verify", "DraftLM.spec_propose")
        before = {fn: watch.count_for(fn) for fn in fns}
        threads = [threading.Thread(
            daemon=True, target=gp.generate, args=(_prompt(3 + i),),
            kwargs={"max_new_tokens": 5}) for i in range(6)]
        for t in threads:
            t.start()
        _join(threads)
        after = {fn: watch.count_for(fn) for fn in fns}
    assert before == after, f"steady-state retraced: {before} -> {after}"
    assert after["TransformerLM.spec_verify"] >= 1
    assert after["DraftLM.spec_propose"] >= 1


def test_paged_spec_chaos_drill_exactly_once_pages_reclaimed():
    _jm, _jp, tm, tp = _models()
    draft = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=0,
                              device="cpu")
    eng = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=PAGE,
                            draft=draft, spec_k=3, device="cpu")
    with faults.active(_chaos_plan()):
        gp = GenerationPipeline(eng, slots=3, max_new_tokens=10,
                                cache_pages=7, max_queue_depth=8,
                                shed_policy="reject_newest")
        try:
            _chaos(gp)
            assert gp._cache.alloc.in_use == 0
            assert (gp._cache.tables == gp._cache.alloc.total).all()
        finally:
            gp.shutdown()
    injected = faults.snapshot()["injected"]
    assert any(k.startswith("generation.step") for k in injected), injected


# ------------------------------------------- twins of tests/test_sessions.py
def test_journal_record_and_deterministic_resume(tmp_path):
    """The store record truncated to k tokens resumes to the SAME stream
    (the store is the JAX package's ``SharedStore``: the port's journal
    writes through the same ``update``/``read`` interface)."""
    eng = _engine("paged")
    store = SharedStore(str(tmp_path / "st"))
    _sess.global_journal().attach(store, "w0")
    with GenerationPipeline(eng, slots=2, max_new_tokens=12) as gp:
        p = _prompt(6, seed=7)
        full = gp.generate(p, session_id="s-full").tolist()
        assert _sess.global_journal().flush() >= 1
        rec = _sess.store_record(store, "s-full")
        assert rec is not None
        assert rec["status"] == "done"
        assert rec["tokens"] == full and rec["seq"] == len(full)
        assert rec["owner"] == "w0"
        part = dict(rec, tokens=rec["tokens"][:4], seq=4, status="live")
        seen = []
        out = gp.resume(part,
                        on_token=lambda t, i: bool(seen.append((i, t)))
                        or True)
        assert out.tolist() == full
        assert [i for i, _ in seen] == list(range(len(full)))
        assert [t for _, t in seen] == full


def test_step_crash_resumes_journaled_sessions_in_place():
    eng = _engine("paged")
    p = _prompt(6, seed=9)
    with GenerationPipeline(eng, slots=2, max_new_tokens=10) as gp:
        base = gp.generate(p).tolist()
    plan = FaultPlan([FaultSpec("generation.step", "crash",
                                rate=1.0, count=3)])
    with faults.active(plan):
        with GenerationPipeline(eng, slots=2, max_new_tokens=10) as gp:
            out = gp.generate(p).tolist()
    assert out == base


def test_step_crash_with_sessions_off_fails_the_request(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_SESSIONS", "0")
    eng = _engine("paged")
    plan = FaultPlan([FaultSpec("generation.step", "crash",
                                rate=1.0, count=3)])
    with faults.active(plan):
        with GenerationPipeline(eng, slots=2, max_new_tokens=10) as gp:
            with pytest.raises(InjectedFault):
                gp.generate(_prompt(6, seed=9))


def test_poisoned_joiner_fails_only_its_session(monkeypatch):
    eng = _engine("paged")
    pa = _prompt(6, seed=21)
    with GenerationPipeline(eng, slots=2, max_new_tokens=16) as gp:
        base = gp.generate(pa).tolist()

    poison_len = 13
    orig = eng.prefill

    def prefill(x, step=0):
        if x.shape[1] == poison_len:
            raise RuntimeError("poisoned insert")
        return orig(x, step=step)

    monkeypatch.setattr(eng, "prefill", prefill)
    with GenerationPipeline(eng, slots=2, max_new_tokens=16) as gp:
        got = []
        started = threading.Event()

        def on_token(tok, i):
            got.append(int(tok))
            if len(got) >= 2:
                started.set()
            time.sleep(0.01)       # hold the stream open for the joiner
            return True

        res = {}

        def run_a():
            res["a"] = gp.generate(pa, session_id="s-healthy",
                                   on_token=on_token).tolist()

        ta = threading.Thread(target=run_a, daemon=True)
        ta.start()
        assert started.wait(30.0)
        with pytest.raises(RuntimeError, match="poisoned insert"):
            gp.generate(_prompt(poison_len, seed=22),
                        session_id="s-poisoned")
        _join([ta])
        assert res.get("a") == base
    healthy = _sess.global_sessions().get("s-healthy")
    poisoned = _sess.global_sessions().get("s-poisoned")
    assert healthy is not None and healthy.status == "done"
    assert poisoned is not None and poisoned.status == "failed"


def test_reclaim_victim_prefers_unjournaled_sessions():
    eng = _engine("paged")
    table = _sess.global_sessions()
    with GenerationPipeline(eng, slots=2, max_new_tokens=4) as gp:
        sa = table.begin([1, 2, 3], {}, None, 4, None, sid="s-new")
        sb = table.begin([4, 5, 6], {}, None, 4, None, sid="s-durable")
        sb.tokens.extend([7, 8, 9])
        sb.journaled = 3
        ra = _GenRequest(np.asarray([1, 2, 3], np.int32), 4, None,
                         session=sa)
        rb = _GenRequest(np.asarray([4, 5, 6], np.int32), 4, None,
                         session=sb)
        ra.t_slot_us, rb.t_slot_us = 100, 200     # rb is younger
        gp._slot_req[0], gp._slot_req[1] = ra, rb
        try:
            assert (gp._reclaim_victim_key(0)
                    > gp._reclaim_victim_key(1))
        finally:
            gp._slot_req[0] = gp._slot_req[1] = None
