"""The decode step's store folded into the attention's launch (K4a+w), on
the CPU through its plain versions, against the JAX package.

Every decode path of the port stores the window's k/v rows and attends in
one call (``paged_attention_write``). Here the port's
``decode_window_paged`` runs on int8 pages (f32 model) and bf16 pages (bf16
model) at W 1 and W 5 over three slots: one whose window crosses a page
edge, one free (its table row all trash), one whose window runs past S to
the trash page. Held against the JAX ``decode_window_paged``: logits at the
paged tolerance (atol 2e-4 in f32; 5e-2 in bf16, where both sides round
every activation at different points); every page but the trash page, and
every scale, to the bit against the JAX engine's compiled scatter
(``quantize_kv_rows`` and ``.at[].set``) of the rows the port projected,
at the coordinates the JAX method computes (each side projects its own
rows, which agree to f32 rounding, so the stores are compared on one set).

Also, in pure Python: K4a+w's rule for which split's blocks store each
window row (``store_split``) against ``key_splits``, and, over an engine
run with slots freed and reused, that no live slot reads a pool row
another slot writes in the same step.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.models import generation as tgen
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                     init_jax_layout)

KW = dict(vocab_size=61, n_layers=2, n_heads=2, d_model=32, max_len=64)
PAGE = 16
N_LP = 4                                   # pages a slot: S = 64
TABLES = np.array([[3, 7, 0, 5], [8, 8, 8, 8], [1, 6, 2, 4]], np.int32)
TRASH = 8
POSITIONS = {1: np.array([16, 40, 63], np.int32),   # a new page; S − 1
             5: np.array([13, 40, 61], np.int32)}   # 13..17; 61..65 past S


def _models(dtype):
    cfg = ttr.TransformerConfig(**KW, dtype=dtype)
    tree = init_jax_layout(cfg, 3)
    jm = jtr.TransformerLM(jtr.TransformerConfig(**KW,
                                                 dtype=getattr(jnp, dtype)))
    return (jm, jax.tree.map(jnp.asarray, tree),
            ttr.TransformerLM(cfg, device="cpu"),
            from_jax_params(tree, cfg, "cpu"))


def _pool(quant, dtype, seed):
    """A filled pool of 8 pages + trash, as numpy: int8 rows and scales
    from the JAX quantization of random rows, or random rows in dtype."""
    rng = np.random.default_rng(seed)
    shape = (KW["n_layers"], TRASH + 1, PAGE, KW["n_heads"],
             KW["d_model"] // KW["n_heads"])
    out = {}
    for n in ("k", "v"):
        rows = rng.standard_normal(shape, dtype=np.float32)
        if quant:
            q8, sc = jax.jit(jtr.quantize_kv_rows)(jnp.asarray(rows))
            out[n], out[f"{n}_scale"] = np.asarray(q8), np.asarray(sc)
        else:
            out[n] = np.asarray(jnp.asarray(rows, getattr(jnp, dtype)))
    return out


def _jax_store(pool, rows, tables, positions, W, quant):
    """The JAX method's store on the given rows: its (page, row)
    coordinates (past S to the trash page), ``quantize_kv_rows`` and the
    scatter, compiled as the JAX engine compiles it."""
    pos_w = positions[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    S = tables.shape[1] * PAGE
    bidx = jnp.arange(tables.shape[0], dtype=jnp.int32)[:, None]
    phys = jnp.where(pos_w < S, tables[bidx, jnp.minimum(
        pos_w // PAGE, tables.shape[1] - 1)], pool["k"].shape[1] - 1)
    off = pos_w % PAGE
    out = dict(pool)
    for n in ("k", "v"):
        for li in range(pool[n].shape[0]):
            r = rows[n][li]
            if quant:
                q8, sc = jtr.quantize_kv_rows(r)
                out[n] = out[n].at[li, phys, off].set(q8)
                out[f"{n}_scale"] = out[f"{n}_scale"].at[li, phys, off].set(
                    sc)
            else:
                out[n] = out[n].at[li, phys, off].set(r)
    return out


@pytest.mark.parametrize("W", [1, 5])
@pytest.mark.parametrize("quant,dtype,atol", [(True, "float32", 2e-4),
                                              (False, "bfloat16", 5e-2)])
def test_decode_window_paged_matches_jax(monkeypatch, W, quant, dtype, atol):
    jm, jp, tm, tp = _models(dtype)
    pool = _pool(quant, dtype, seed=W)
    toks = np.random.default_rng(W + 1).integers(
        0, KW["vocab_size"], (3, W)).astype(np.int32)
    pos = POSITIONS[W]
    jl, _ = jax.jit(jm.decode_window_paged, static_argnums=5)(
        jp, {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(TABLES), jnp.asarray(toks), jnp.asarray(pos), PAGE)
    seen = {"k": [], "v": []}
    write = pa.paged_attention_write

    def spy(q, k, v, *args, **kw):
        seen["k"].append(k.detach().clone())
        seen["v"].append(v.detach().clone())
        return write(q, k, v, *args, **kw)

    monkeypatch.setattr(pa, "paged_attention_write", spy)
    tpool = {n: torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype)) if a.dtype.itemsize == 2 else
        torch.from_numpy(a.copy()) for n, a in pool.items()}
    tl, out = tm.decode_window_paged(tp, tpool, torch.from_numpy(TABLES),
                                     torch.from_numpy(toks),
                                     torch.from_numpy(pos), PAGE)
    assert out is tpool and len(seen["k"]) == KW["n_layers"]
    # live slots' logits at positions inside the position table (past it
    # the JAX embedding reads NaN, the port its last row: never emitted)
    emitted = (pos[:, None] + np.arange(W) < KW["max_len"])
    emitted[1] = False                              # slot 1 is free
    np.testing.assert_allclose(tl.float().numpy()[emitted],
                               np.asarray(jl, np.float32)[emitted],
                               atol=atol)
    rows = {n: jnp.stack([jnp.asarray(r.float().numpy(),
                                      getattr(jnp, dtype)) for r in seen[n]])
            for n in seen}
    want = jax.jit(_jax_store, static_argnums=(4, 5))(
        {n: jnp.asarray(a) for n, a in pool.items()}, rows,
        jnp.asarray(TABLES), jnp.asarray(pos), W, quant)
    for n, a in tpool.items():
        got = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        ref = np.asarray(want[n], got.dtype)
        np.testing.assert_array_equal(got[:, :TRASH], ref[:, :TRASH],
                                      err_msg=n)
        changed = np.any((got != np.asarray(pool[n], got.dtype))[:, :TRASH]
                         .reshape(KW["n_layers"], TRASH, PAGE, -1), axis=-1)
        assert changed.sum() >= 2 * (W if W == 1 else W + 3), n
    # slot 2's rows past S and the free slot's rows went to the trash page
    if W == 5:
        assert not np.array_equal(tpool["k"][:, TRASH].float().numpy(),
                                  np.asarray(pool["k"][:, TRASH],
                                             np.float32))


@pytest.mark.parametrize("slots,heads,keys,W", [
    (1, 16, 1024, 1), (8, 16, 1024, 5), (1, 2, 64, 5), (3, 16, 256, 5),
    (1, 1, 4096, 1), (2, 4, 48, 16)])
def test_each_window_row_has_one_writing_split(slots, heads, keys, W):
    """For every split count ``key_splits`` gives or is forced to, and
    windows at every start near the split edges and past the keys: each
    window row is stored by exactly one split's blocks (every head's block
    of it, its own slice), a row past the keys by the last split, and no
    split reads a window row's key that it did not store."""
    for forced in (None, 1, 2, 3, 7, 64):
        splits, per = pa.key_splits(slots, heads, keys, forced, W * 64)
        edges = sorted({0, keys - W, keys - 1, keys + 2}
                       | {s * per + d for s in range(splits)
                          for d in (-2, -1, 0, 1)})
        for start in (e for e in edges if e >= 0):
            pos = start + np.arange(W)
            kend = int(pos.max()) + 1
            owner = [pa.store_split(int(p), keys, splits, per) for p in pos]
            t_owner = pa.store_split(torch.from_numpy(pos), keys, splits,
                                     per)
            assert t_owner.tolist() == owner
            for p, o in zip(pos, owner):
                writers = [(s, h) for s in range(splits)
                           for h in range(heads) if o == s]
                assert len(writers) == heads and {h for _s, h in writers} \
                    == set(range(heads))
                assert o == (p // per if p < keys else splits - 1)
                assert 0 <= o < splits
            for s in range(splits):
                reads = range(s * per, min((s + 1) * per, keys, kend))
                for p, o in zip(pos, owner):
                    if p in reads:
                        assert o == s, (forced, start, p, s)
            # the dense cache clamps a row past S to key S − 1: the last
            # split reads it, and the last split stores it
            assert (keys - 1) // per == splits - 1


def test_no_live_slot_reads_a_row_another_slot_writes(monkeypatch):
    """An engine run over three slots with pages of 16 (slots freed and
    reused, windows crossing page edges): at every decode step, each live
    slot's table names pages no other live slot holds, and no live slot's
    keys lie on a pool row another slot's window writes in that step (the
    PageAllocator hands a page to one owner at a time)."""
    cfg = ttr.TransformerConfig(**KW)
    tm = ttr.TransformerLM(cfg, device="cpu")
    eng = tgen.DecodeEngine(tm, tm.init_params(5), max_len=64,
                            page_tokens=PAGE, device="cpu")
    calls = []
    write = pa.paged_attention_write

    def spy(q, k, v, k_pool, v_pool, tables, pos, dst, *args, **kw):
        calls.append((tables.clone(), pos.clone(), dst.clone()))
        return write(q, k, v, k_pool, v_pool, tables, pos, dst, *args, **kw)

    monkeypatch.setattr(pa, "paged_attention_write", spy)
    state = eng.new_state(3)
    trash = state.alloc.total
    rng = np.random.default_rng(0)
    positions = np.zeros(3, np.int32)
    tokens = np.zeros(3, np.int32)

    def admit(slot, n):
        first, _l, kv, t = eng.prefill(rng.integers(
            0, KW["vocab_size"], (1, n)).astype(np.int32))
        eng.insert_slot(state, kv, slot)
        tokens[slot], positions[slot] = int(first[0]), t

    def check_step():
        tables, pos, dst = calls[-1]
        live = [b for b in range(3) if state.slot_pages[b]]
        owned = [set(state.slot_pages[b]) for b in live]
        for i, b in enumerate(live):
            assert trash not in owned[i]
            assert list(state.tables[b, :len(state.slot_pages[b])]) == \
                state.slot_pages[b]
            for j in range(i):
                assert not owned[i] & owned[j], (live, owned)
        for b in set(range(3)) - set(live):
            assert (state.tables[b] == trash).all()
        S = tables.shape[1] * PAGE
        for b in live:
            kend = int(pos[b].max()) + 1
            read = {int(tables[b, j // PAGE]) * PAGE + j % PAGE
                    for j in range(min(kend, S))}
            for o in range(3):
                if o != b:
                    assert not read & {int(d) for d in dst[o]}, (b, o)

    for slot, n in ((0, 5), (1, 20), (2, 9)):
        admit(slot, n)
    for step in range(40):
        if step == 10:
            eng.free_slot(state, 1)
        if step == 14:
            admit(1, 30)
        if step == 25:
            eng.free_slot(state, 0)
            admit(0, 3)
        live = np.array([bool(p) for p in state.slot_pages])
        nxt, _lg, state = eng.decode(state, tokens, positions, step)
        check_step()
        tokens = np.where(live, nxt.cpu().numpy(), 0).astype(np.int32)
        positions = np.where(live, np.minimum(positions + 1, 63),
                             positions).astype(np.int32)
    assert len(calls) == 40 * KW["n_layers"]
