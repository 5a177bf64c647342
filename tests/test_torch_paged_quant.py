"""The port's int8 KV pages against the JAX package's, at a tiny size.

The same weights (the JAX ``init_params`` tree through ``from_jax_params``)
and the same inputs go through both, in f32 on the CPU, where the port's
K4a and K4w wrappers take their plain versions. Tolerances: quantization,
pools and scales exact (the same f32 arithmetic: amax, ``amax / 127``, an
IEEE division and round-half-to-even); decode logits atol 2e-4 (the decode
rows' tolerance: f32 sums in another order); greedy tokens exact.
"""
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import generation as jgen
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.models import generation as tgen
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import from_jax_params

KW = dict(vocab_size=61, n_layers=2, n_heads=2, d_model=32, max_len=64)
MAXLEN = 48
PAGE = 16
_CACHE = {}


def _models():
    if "m" not in _CACHE:
        jm = jtr.TransformerLM(jtr.TransformerConfig(**KW))
        jp = jm.init_params(jax.random.key(0))
        tcfg = ttr.TransformerConfig(**KW)
        tm = ttr.TransformerLM(tcfg, device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
        _CACHE["m"] = (jm, jp, tm, tp)
    return _CACHE["m"]


def _engine(side, **kw):
    key = (side, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jm, jp, tm, tp = _models()
        kw = dict(dict(max_len=MAXLEN, page_tokens=PAGE), **kw)
        _CACHE[key] = (jgen.DecodeEngine(jm, jp, **kw) if side == "jax"
                       else tgen.DecodeEngine(tm, tp, device="cpu", **kw))
    return _CACHE[key]


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, n)).astype(np.int32)


def _rows(shape, seed, zero_rows=()):
    a = np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32) * np.float32(0.7)
    for i in zero_rows:
        a[i] = 0.0
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_matches_jax_exactly(dtype):
    """Rows of (H, hd) = (4, 16), a few all-zero (scale 1), in f32 and in
    bf16 (both sides quantize the same bf16 values through f32), against
    the function as the JAX engine runs it, compiled: XLA computes its
    ``amax / 127.0`` as ``amax * f32(1/127)``, which the port matches (one
    f32 ulp off the division in a few rows)."""
    rows = _rows((64, 5, 4, 16), seed=1, zero_rows=[(3, 2), (10,)])
    j8, js = jax.jit(jtr.quantize_kv_rows)(
        jnp.asarray(rows, getattr(jnp, dtype)))
    t8, ts = ttr.quantize_kv_rows(
        torch.from_numpy(rows).to(getattr(torch, dtype)))
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32
    assert t8.shape == (64, 5, 4, 16) and ts.shape == (64, 5)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[3, 2] == 1.0 and (ts[10] == 1.0).all()
    assert (t8[3, 2] == 0).all()


def test_init_paged_cache_quant_shapes_and_dtypes():
    _jm, _jp, tm, _tp = _models()
    pool = tm.init_paged_cache(5, PAGE, quant=True)
    assert set(pool) == {"k", "v", "k_scale", "v_scale"}
    for n in ("k", "v"):
        assert pool[n].shape == (2, 5, PAGE, 2, 16)
        assert pool[n].dtype == torch.int8
        assert pool[f"{n}_scale"].shape == (2, 5, PAGE)
        assert pool[f"{n}_scale"].dtype == torch.float32
    plain = tm.init_paged_cache(5, PAGE, dtype=torch.bfloat16)
    assert set(plain) == {"k", "v"} and plain["k"].dtype == torch.bfloat16


def _int8_pool(n_pages, seed):
    """A filled int8 pool with its scales, made by quantizing random rows
    with the JAX function (so both sides start from the same pool)."""
    out = {}
    for i, n in enumerate(("k", "v")):
        q8, sc = jtr.quantize_kv_rows(jnp.asarray(
            _rows((2, n_pages, PAGE, 2, 16), seed + i)))
        out[n], out[f"{n}_scale"] = np.asarray(q8), np.asarray(sc)
    return out


def _held_to_jax_pool(got, want, before):
    """Rows neither side wrote are equal to the bit; the rows written (the
    same set on both sides) come from each side's own f32 projections,
    which agree to ~1e-7 relative, so their scales agree to an ulp or two
    and an int8 value on a rounding boundary may land one step over."""
    for n in ("k", "v"):
        g8, w8 = got[n].numpy(), np.asarray(want[n])
        gs, ws = got[f"{n}_scale"].numpy(), np.asarray(want[f"{n}_scale"])
        wrote = ~np.all(w8 == before[n], axis=(-2, -1)) | (
            ws != before[f"{n}_scale"])
        np.testing.assert_array_equal(
            wrote, ~np.all(g8 == before[n], axis=(-2, -1)) | (
                gs != before[f"{n}_scale"]))
        assert wrote.any()
        np.testing.assert_array_equal(g8[~wrote], w8[~wrote])
        np.testing.assert_array_equal(gs[~wrote], ws[~wrote])
        np.testing.assert_allclose(gs[wrote], ws[wrote], rtol=1e-6)
        assert np.abs(g8[wrote].astype(int) - w8[wrote]).max() <= 1
    return wrote


@pytest.mark.parametrize("W", [1, 3])
def test_decode_window_paged_int8_matches_jax(W):
    """Three slots over a 7-page pool (6 + trash): slot 0 mid-page, slot 1
    at the end of its span (with W = 3 its tail rows run past S and go to
    the trash page), slot 2 free (its table row all trash). Logits within
    2e-4; the pools as :func:`_held_to_jax_pool` holds them, the rows
    written landing where the JAX ones land, the trash page's included."""
    jm, jp, tm, tp = _models()
    pool = _int8_pool(7, seed=30)
    tables = np.array([[4, 0, 2], [1, 5, 3], [6, 6, 6]], np.int32)
    toks = np.random.default_rng(3).integers(
        0, KW["vocab_size"], (3, W)).astype(np.int32)
    pos = np.array([20, 47, 5], np.int32)
    jl, jpool = jax.jit(jm.decode_window_paged, static_argnums=5)(
        jp, {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(tables), jnp.asarray(toks), jnp.asarray(pos), PAGE)
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tl, out = tm.decode_window_paged(tp, tpool, torch.from_numpy(tables),
                                     torch.from_numpy(toks),
                                     torch.from_numpy(pos), PAGE)
    assert out is tpool and tl.shape == (3, W, KW["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)
    for n in ("k", "v", "k_scale", "v_scale"):
        assert tpool[n].dtype == (torch.int8 if len(n) == 1
                                  else torch.float32)
    wrote = _held_to_jax_pool(tpool, jpool, pool)
    assert wrote.sum() == 2 * 3 * W       # layers × slots × window rows
    assert wrote[:, 0, 4].all()           # slot 0's position 20
    assert wrote[:, 6, 5].all()           # the free slot's, on the trash
    if W == 3:                            # slot 1's 48 and 49, on the trash
        assert wrote[:, 6, :2].all()


def test_int8_scatter_matches_jax_on_the_same_rows():
    """Given the same rows, K4w's plain version writes exactly what the
    JAX engine's compiled scatter writes: a decode window's rows through
    (page, row) coordinates (trash rows included), and a prefill's rows
    into whole zero-padded pages across every layer."""
    rows = {n: _rows((3, 2, 2, 16), seed=40 + i, zero_rows=[(1, 1)])
            for i, n in enumerate(("k", "v"))}
    phys = np.array([[2, 2], [0, 6], [6, 6]], np.int32)
    off = np.array([[3, 4], [15, 0], [7, 8]], np.int32)
    base = _int8_pool(7, seed=50)

    def jax_scatter(pool, rows, phys, off):
        out = dict(pool)
        for n in ("k", "v"):
            q8, sc = jtr.quantize_kv_rows(rows[n])
            out[n] = pool[n][0].at[phys, off].set(q8)
            out[f"{n}_scale"] = pool[f"{n}_scale"][0].at[phys, off].set(sc)
        return out

    want = jax.jit(jax_scatter)({n: jnp.asarray(a) for n, a in base.items()},
                                {n: jnp.asarray(a) for n, a in rows.items()},
                                jnp.asarray(phys), jnp.asarray(off))
    got = {n: torch.from_numpy(a[0].copy()) for n, a in base.items()}
    pa.kv_quant_write(torch.from_numpy(rows["k"]),
                      torch.from_numpy(rows["v"]), torch.from_numpy(phys),
                      torch.from_numpy(off), got["k"], got["v"],
                      got["k_scale"], got["v_scale"])
    for n in got:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    assert got["k_scale"][6, 0] == 1.0                 # the zero row
    # a prefill of 20 rows into pages 5 and 1 of every layer
    kv = {n: _rows((2, 1, 20, 2, 16), seed=60 + i)
          for i, n in enumerate(("k", "v"))}

    def jax_insert(pool, k, v, ids):
        out = dict(pool)
        for n, a in (("k", k), ("v", v)):
            q8, sc = jtr.quantize_kv_rows(jgen.pack_kv_pages(a, PAGE))
            out[n] = pool[n].at[:, ids].set(q8)
            out[f"{n}_scale"] = pool[f"{n}_scale"].at[:, ids].set(sc)
        return out

    want = jax.jit(jax_insert)({n: jnp.asarray(a) for n, a in base.items()},
                               jnp.asarray(kv["k"]), jnp.asarray(kv["v"]),
                               jnp.asarray([5, 1]))
    got = {n: torch.from_numpy(a.copy()) for n, a in base.items()}
    t = torch.arange(2 * PAGE)
    ids = torch.tensor([5, 1])
    pa.kv_quant_write(torch.from_numpy(kv["k"]), torch.from_numpy(kv["v"]),
                      ids[t // PAGE][None], (t % PAGE)[None], got["k"],
                      got["v"], got["k_scale"], got["v_scale"])
    for n in got:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    assert (got["k_scale"][:, 1, 4:] == 1.0).all()     # the padding rows


def test_paged_attention_plain_version_is_the_reference_attention():
    """The CPU wrapper of K4a is the gather + reference attention: an int8
    pool gives the attention over its dequantized view, a dense cache the
    attention over the cache itself through ``dense_tables``."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 3, 2, 16), generator=g)
    cache = torch.randn((2, 2, 40, 2, 16), generator=g)
    pos = torch.tensor([[5, 6, 7], [37, 38, 39]])
    got = pa.paged_attention(q, cache[0], cache[1], pa.dense_tables(2, "cpu"),
                             pos)
    mask = torch.arange(40)[None, None, :] <= pos[:, :, None]
    want = pa.window_attend_reference(q, cache[0], cache[1], mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    k8, ks = pa.quantize_kv_rows_reference(cache[0].reshape(8, 10, 2, 16))
    v8, vs = pa.quantize_kv_rows_reference(cache[1].reshape(8, 10, 2, 16))
    tables = torch.tensor([[3, 0, 6, 1], [2, 7, 5, 4]], dtype=torch.int32)
    got = pa.paged_attention(q, k8, v8, tables, pos, ks, vs)
    view = lambda p8, sc: (p8[tables.long()].reshape(2, 40, 2, 16).float()
                           * sc[tables.long()].reshape(2, 40)[..., None,
                                                              None])
    want = pa.window_attend_reference(q, view(k8, ks), view(v8, vs), mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_key_splits_cover_the_keys_in_whole_tiles():
    """Every key lies in exactly one split (splits × keys a split covers
    the keys, and the last split is not empty), with or without a forced
    count; the pinned values are the rule's at the serving shapes."""
    for slots, heads, keys in [(1, 16, 1024), (8, 16, 1024), (1, 2, 48),
                               (3, 1, 1), (64, 16, 4096), (1, 16, 37),
                               (1, 1, 4096), (1, 16, 65536)]:
        for forced in (None, 1, 3, 7, 9, 64, 1000):
            splits, per = pa.key_splits(slots, heads, keys, forced)
            assert 1 <= splits <= pa.MAX_SPLITS and per >= 1
            assert splits * per >= keys > (splits - 1) * per
            starts = [s * per for s in range(splits)]
            covered = sorted(j for a in starts
                             for j in range(a, min(a + per, keys)))
            assert covered == list(range(keys))
    assert pa.key_splits(1, 16, 1024) == (16, 64)      # 256 blocks
    assert pa.key_splits(8, 16, 1024) == (2, 512)      # 2 blocks an SM
    # one wave at the kernel's occupancy: 3 and 4 resident blocks an SM
    assert pa.key_splits(8, 16, 1024, blocks_per_sm=3) == (3, 342)
    assert pa.key_splits(8, 16, 1024, blocks_per_sm=4) == (4, 256)
    assert pa.key_splits(64, 16, 1024) == (1, 1024)
    assert pa.key_splits(1, 1, 4096) == (64, 64)       # the many-split case
    assert pa.key_splits(1, 16, 1024, 9) == (9, 114)
    assert pa.key_splits(1, 16, 1024, 64, window_floats=16 * 128) == (8, 128)


@pytest.mark.parametrize("slots,heads,keys", [(1, 16, 1024), (16, 1, 1024),
                                              (2, 8, 1024), (1, 16, 960)])
def test_key_splits_fill_the_card_with_real_work(slots, heads, keys):
    """At 16 (slot, head) pairs the grid holds at least one block per SM of
    the H100, no split is empty, and each of a block's warps streams more
    than one group of rows (4 keys a load for bf16 rows of 64)."""
    splits, per = pa.key_splits(slots, heads, keys)
    assert splits * slots * heads >= 132
    assert keys - (splits - 1) * per > 0
    keys_a_load = 32 // (64 * 2 // 16)
    assert per / pa.WARPS > keys_a_load


def test_ticket_counters_grow_only_for_a_larger_batch():
    """The counter buffer is sized to a power of two (at least 256), reused
    while it holds slots × heads, replaced by a zeroed larger one when it
    does not, and the old one kept alive for graphs that captured it."""
    assert pa.counter_slots(0, 16) == 256
    assert pa.counter_slots(256, 16) == 256
    assert pa.counter_slots(256, 257) == 512
    assert pa.counter_slots(512, 300) == 512
    assert pa.counter_slots(0, 1024) == 1024
    dev = torch.device("cpu")
    saved = dict(pa._counters), list(pa._retired)
    try:
        pa._counters.pop(dev, None)
        first = pa._ticket_counters(dev, 16)
        assert first.dtype == torch.int32 and first.numel() == 256
        assert not first.any()
        assert pa._ticket_counters(dev, 128) is first
        grown = pa._ticket_counters(dev, 8 * 64)
        assert grown is not first and grown.numel() == 512
        assert not grown.any() and pa._retired[-1] is first
        assert pa._ticket_counters(dev, 300) is grown
    finally:
        pa._counters.clear()
        pa._counters.update(saved[0])
        pa._retired[:] = saved[1]


def test_engine_int8_gate_passes_and_tokens_match_jax():
    """The gate passes on both sides and the state is int8; greedy tokens
    equal the JAX int8 engine's exactly over three prompt buckets."""
    jeng = _engine("jax", kv_quant=True)
    teng = _engine("torch", kv_quant=True)
    st = teng.new_state(2)
    gate = teng.quant_gate
    jeng.new_state(1)
    assert gate["checked"] and gate["passed"] and teng.kv_quant
    assert gate["argmax_agree"] == jeng.quant_gate["argmax_agree"]
    assert gate["max_abs_logit_diff"] <= gate["tol"] == 0.05
    assert st.arrays["k"].dtype == torch.int8 and "v_scale" in st.arrays
    for n in (5, 20, 37):
        prompt = _prompt(n, seed=n)
        np.testing.assert_array_equal(teng.generate(prompt, 9),
                                      np.asarray(jeng.generate(prompt, 9)))


def test_int8_insert_slot_writes_the_jax_pages():
    """A prefill's rows written into an int8 pool (K4w's plain version)
    land in the JAX insert's pages, as
    :func:`_held_to_jax_pool` holds them (each side quantizes its own
    prefill's rows)."""
    jeng = _engine("jax", kv_quant=True)
    teng = _engine("torch", kv_quant=True)
    prompt = _prompt(20, seed=8)                       # bucket 32: 2 pages
    _f, _l, jkv, _t = jeng.prefill(prompt)
    jst = jeng.insert_slot(jeng.new_state(1), jkv, 0)
    _f, _l, tkv, _t = teng.prefill(prompt)
    tst = teng.insert_slot(teng.new_state(1), tkv, 0)
    assert tst.slot_pages[0] == list(jst.slot_pages[0])
    before = {n: np.asarray(a) for n, a in
              teng.model.init_paged_cache(tst.alloc.total + 1, PAGE,
                                          quant=True).items()}
    wrote = _held_to_jax_pool(tst.arrays, jst.arrays, before)
    pages = tst.slot_pages[0]
    assert wrote[:, pages].all() and wrote.sum() == 2 * 2 * PAGE


def test_gate_trips_on_bad_scale_and_falls_back(monkeypatch):
    """A corrupted scale (7× off) trips the gate loudly; the engine falls
    back to f32 pages and emits the plain paged engine's tokens."""
    real = ttr.quantize_kv_rows

    def corrupt(rows):
        q8, scale = real(rows)
        return q8, scale * 7.0

    monkeypatch.setattr(ttr, "quantize_kv_rows", corrupt)
    _jm, _jp, tm, tp = _models()
    eng = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=PAGE,
                            kv_quant=True, device="cpu")
    st = eng.new_state(1)
    gate = eng.quant_gate
    assert gate["checked"] and not gate["passed"]
    assert gate["max_abs_logit_diff"] > gate["tol"]
    assert not eng.kv_quant and not eng._quant_active()
    assert st.arrays["k"].dtype == torch.float32 and "k_scale" not in st.arrays
    prompt = _prompt(9, seed=9)
    np.testing.assert_array_equal(eng.generate(prompt, 10),
                                  _engine("torch").generate(prompt, 10))


def test_kv_quant_with_the_dense_cache_keeps_it(caplog):
    _jm, _jp, tm, tp = _models()
    with caplog.at_level(logging.WARNING):
        eng = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=0,
                                kv_quant=True, device="cpu")
    assert not eng.kv_quant and eng.quant_gate is None
    assert "dense cache" in caplog.text
    st = eng.new_state(1)
    assert st.mode == "dense" and st.arrays["k"].dtype == torch.float32


def test_page_and_resident_bytes_equal_the_reference():
    jq, tq = _engine("jax", kv_quant=True), _engine("torch", kv_quant=True)
    jf, tf = _engine("jax"), _engine("torch")
    assert tq.page_bytes() == jq.page_bytes() == 2 * PAGE * (2 * 32 + 8)
    assert tf.page_bytes() == jf.page_bytes()
    assert tq.page_bytes() < tf.page_bytes() / 3
    prompt = _prompt(20, seed=11)
    for j, t in ((jq, tq), (jf, tf)):
        jst = j.insert_slot(j.new_state(2), j.prefill(prompt)[2], 1)
        tst = t.insert_slot(t.new_state(2), t.prefill(prompt)[2], 1)
        assert t.resident_cache_bytes(tst) == j.resident_cache_bytes(jst)
        assert t.cache_bytes(tst) == j.cache_bytes(jst)
    jd, td = _engine("jax", page_tokens=0), _engine("torch", page_tokens=0)
    assert (td.resident_cache_bytes(td.new_state(2))
            == jd.resident_cache_bytes(jd.new_state(2)))


def test_kv_quant_env_is_on_only_for_1(monkeypatch):
    _jm, _jp, tm, tp = _models()
    for raw, want in (("1", True), ("0", False), ("true", False),
                      ("on", False), ("", False), ("yes", False)):
        monkeypatch.setenv("DL4J_TPU_KV_QUANT", raw)
        assert tgen.kv_quant_env() is want is jgen.kv_quant_env()
        assert tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=PAGE,
                                 device="cpu").kv_quant is want
    monkeypatch.delenv("DL4J_TPU_KV_QUANT")
    assert not tgen.kv_quant_env()
    assert tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=PAGE,
                             kv_quant=True, device="cpu").kv_quant


def test_card_wrappers_refuse_what_the_kernels_do_not_take():
    """The argument checks of the card path (run here on CPU tensors, as
    they read only shapes, dtypes and strides): K4a takes windows of 1 to
    16 queries, head dims that are multiples of 8 up to 256, pools of q's
    dtype or int8 with their scales; K4w takes int8 pools and coordinates
    that cover the rows, with zero-row padding only for a single slot."""
    q = torch.zeros((2, 3, 2, 16))
    k8 = torch.zeros((5, 4, 2, 16), dtype=torch.int8)
    sc = torch.ones((5, 4))
    tables = torch.zeros((2, 2), dtype=torch.int32)
    assert pa._check_attend(q, k8, k8, tables, sc, sc)
    assert not pa._check_attend(q, k8.float(), k8.float(), tables, None,
                                None)
    for bad, what in (
            ((torch.zeros((2, 17, 2, 16)), k8, k8, tables, sc, sc),
             "window"),
            ((torch.zeros((2, 3, 2, 12)), k8[..., :12].contiguous(),
              k8[..., :12].contiguous(), tables, sc, sc), "head dim"),
            ((torch.zeros((2, 3, 2, 264)), k8, k8, tables, sc, sc),
             "head dim"),
            ((q, k8.bfloat16(), k8.bfloat16(), tables, None, None), "pool"),
            ((q, k8, k8, tables, None, sc), "k_scale"),
            ((q, k8, k8, tables[:1], sc, sc), "tables")):
        with pytest.raises(ValueError, match=what):
            pa._check_attend(*bad)
    with pytest.raises(TypeError):
        pa._check_attend(q.half(), k8, k8, tables, sc, sc)
    rows = torch.zeros((1, 3, 2, 16))
    phys = torch.zeros((1, 5), dtype=torch.int32)
    assert pa._check_rows("k", rows, k8, sc, phys) == 0
    assert pa._check_rows("k", rows[None], k8[None], sc[None], phys) == 1
    for args, what in (((rows, k8.float(), sc, phys), "pool"),
                       ((rows, k8, sc[:, :2], phys), "scales"),
                       ((rows, k8, sc, phys[:, :2]), "coordinates"),
                       ((torch.zeros((2, 3, 2, 16)), k8, sc,
                         torch.zeros((2, 5), dtype=torch.int32)),
                        "coordinates"),
                       ((rows.transpose(2, 3), k8, sc, phys), "rows")):
        with pytest.raises(ValueError, match=what):
            pa._check_rows("k", *args)
