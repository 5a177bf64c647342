"""The port's chunked cross-entropy (K3's plain version and the model's
``ce_chunks`` path) against the JAX package's, at a tiny size.

The same inputs, made with numpy from a seed, go through
``deeplearning4j_tpu.kernels.chunked_ce.chunked_softmax_xent`` (and its
``jax.grad``) and the port's ``chunked_softmax_xent`` on the CPU, which runs
the kernels' plain versions. Tolerances (PERF.md states them):

- K3 loss, lse and the target logit, f32 and bf16: atol 2e-6 — both take
  f32 logits from the same operands (bf16 products are exact in f32) and
  sum in another order (logits reach ~6 here, a few f32 ulps);
- K3 dx and dE, f32: atol 1e-7 (gradients are O(1e-3) here); bf16: each
  within one bf16 ulp of the JAX value (relative 2^-7), since dlogits and
  then each gradient round to bf16 after f32 sums taken in another order;
- the model with ``ce_chunks`` against JAX's: as the ``ce_chunks=0``
  training tests (f32 loss and each leaf atol 1e-5; bf16 on JAX's flash
  path loss atol 2e-2 and each leaf's relative L2 error <= 5e-2);
- ``ce_chunks=4`` against ``ce_chunks=0`` in the port, f32: loss atol 1e-6,
  each leaf atol 1e-6 (the same function, sums in another order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deeplearning4j_tpu.kernels import chunked_ce as jce
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu_torch.kernels import chunked_ce as tce
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                     init_jax_layout,
                                                     to_jax_params)
from deeplearning4j_tpu_torch.optim.adamw import adamw
from deeplearning4j_tpu_torch.tree import tree_leaves

KW = dict(vocab_size=96, n_layers=2, n_heads=2, d_model=32, max_len=32)
LR = 3e-4


def _inputs(dtype, n_chunks, b=2, t=12, v=256, d=32, seed=0):
    """x (B, T, D) at a LayerNorm's scale, emb (V, D) at the init's, and
    targets that include every chunk's first and last id and the vocab's
    ends."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d), dtype=np.float32)
    emb = rng.standard_normal((v, d), dtype=np.float32) * np.float32(0.5)
    c = v // n_chunks
    edges = sorted({0, v - 1} | {i * c for i in range(n_chunks)}
                   | {i * c - 1 for i in range(1, n_chunks)})
    tg = rng.integers(0, v, (b * t,))
    tg[:len(edges)] = edges
    targets = rng.permutation(tg).reshape(b, t).astype(np.int32)
    jd = getattr(jnp, dtype)
    jx, je = jnp.asarray(x, jd), jnp.asarray(emb, jd)
    # the port gets the very same (rounded) values
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    te = torch.from_numpy(np.array(je.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return (jx, je, jnp.asarray(targets)), (tx, te,
                                           torch.from_numpy(targets))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_chunks", [2, 4, 8])
def test_plain_k3_matches_jax_loss_and_grads(dtype, n_chunks):
    (jx, je, jt), (tx, te, tt) = _inputs(dtype, n_chunks)
    jl, (jdx, jde) = jax.value_and_grad(
        jce.chunked_softmax_xent, argnums=(0, 1))(jx, je, jt, n_chunks)
    x, e = tx.clone().requires_grad_(), te.clone().requires_grad_()
    loss = tce.chunked_softmax_xent(x, e, tt, n_chunks)
    dx, de = torch.autograd.grad(loss, (x, e))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert dx.dtype == x.dtype and de.dtype == e.dtype
    assert abs(loss.item() - float(jl)) <= 2e-6
    for got, want in ((dx, jdx), (de, jde)):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), want, atol=1e-7)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=2 ** -7,
                                       atol=1e-7)


@pytest.mark.parametrize("n_chunks", [2, 8])
def test_plain_forward_pieces_match_jax(n_chunks):
    (jx, je, jt), (tx, te, tt) = _inputs("float32", n_chunks, seed=3)
    jlse, jcor = jce._forward_pieces(jx, je, jt, n_chunks)
    lse, cor = tce.chunked_ce_fwd_reference(
        tx.reshape(-1, tx.shape[-1]), te, tt.reshape(-1).long(), n_chunks)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(-1),
                               atol=2e-6)
    np.testing.assert_allclose(cor.numpy(), np.asarray(jcor).reshape(-1),
                               atol=2e-6)


def test_dlogits_are_softmax_minus_onehot_scaled():
    """One chunk's plain dlogits: the softmax of the full logits restricted
    to the chunk, minus the one-hot of targets that fall in it, times
    g / N; cast to x's dtype."""
    (_j), (tx, te, tt) = _inputs("float32", 4, seed=5)
    x2, t = tx.reshape(-1, tx.shape[-1]), tt.reshape(-1).long()
    lse, _ = tce.chunked_ce_fwd_reference(x2, te, t, 4)
    g = torch.tensor(3.0)
    got = tce.ce_dlogits_reference(x2, te[64:128], t, lse, 64, g, 24)
    full = torch.softmax(x2 @ te.T, -1)
    onehot = torch.nn.functional.one_hot(t, 256).float()
    want = ((full - onehot) * 3.0 / 24)[:, 64:128]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    bf = tce.ce_dlogits_reference(x2.bfloat16(), te[64:128].bfloat16(), t,
                                  lse, 64, g, 24)
    assert bf.dtype == torch.bfloat16


def test_cpu_tensors_take_the_plain_versions():
    (_j), (tx, te, tt) = _inputs("float32", 2)
    tce.launches_fwd = tce.launches_dlogits = 0
    tce.launches_fwd_wgmma = tce.launches_dlogits_wgmma = 0
    x = tx.clone().requires_grad_()
    torch.autograd.grad(tce.chunked_softmax_xent(x, te, tt, 2), x)
    assert (tce.launches_fwd, tce.launches_dlogits, tce.launches_fwd_wgmma,
            tce.launches_dlogits_wgmma) == (0, 0, 0, 0)


@pytest.mark.parametrize("device,dtype,d,aligned,want", [
    ("cpu", torch.bfloat16, 1024, True, "plain"),
    ("cpu", torch.float32, 40, False, "plain"),      # the CPU takes anything
    ("cuda", torch.bfloat16, 1024, True, "wgmma"),   # the training layer
    ("cuda", torch.bfloat16, 64, True, "wgmma"),
    ("cuda", torch.bfloat16, 192, True, "wgmma"),
    ("cuda", torch.bfloat16, 32, True, "mma_sync"),  # bf16 at other d
    ("cuda", torch.bfloat16, 96, True, "mma_sync"),
    ("cuda", torch.float32, 1024, True, "mma_sync"),  # f32 at any d
    ("cuda", torch.float32, 16, True, "mma_sync"),
    ("cuda", torch.bfloat16, 1024, False, ValueError),  # off the 16-B grid
    ("cuda", torch.float32, 256, False, ValueError),
    ("cuda", torch.bfloat16, 40, True, ValueError),     # 80 B a row
    ("cuda", torch.float32, 8, True, ValueError),
    ("cuda", torch.float16, 1024, True, TypeError),
])
def test_kernel_for_routes_each_case(device, dtype, d, aligned, want):
    if isinstance(want, str):
        assert tce.kernel_for(device, dtype, d, aligned) == want
    else:
        with pytest.raises(want):
            tce.kernel_for(device, dtype, d, aligned)


def test_tma_aligned_reads_strides_and_start():
    x = torch.zeros((16, 64), dtype=torch.bfloat16)
    assert tce.tma_aligned(x) == (x.data_ptr() % 16 == 0)
    assert not tce.tma_aligned(x[:, ::2])                  # stride 2 on d
    assert not tce.tma_aligned(torch.zeros((4, 68), dtype=torch.bfloat16)
                               [:, :64])                   # 136-byte rows
    buf = torch.zeros(16 * 64 + 8, dtype=torch.bfloat16)
    off = next(i for i in range(1, 8) if (buf.data_ptr() + 2 * i) % 16)
    assert not tce.tma_aligned(buf[off:off + 16 * 64].view(16, 64))


@pytest.mark.parametrize("n,v,tile_cols,blocks,splits,per", [
    # the wgmma kernel (256-column tiles, one block an SM)
    (8192, 32768, 256, 132, 2, 64),    # the bench's large config, batch 8
    (4096, 32768, 256, 132, 4, 32),    # batch 4
    (10, 96, 256, 132, 1, 1),          # one tile of each
    (1, 1000, 256, 132, 4, 1),         # one row: every tile its own split
    (100000, 256, 256, 132, 1, 1),     # many rows: one split
    # the mma.sync kernel (128-column tiles, four blocks an SM)
    (8192, 32768, 128, 528, 8, 32),
    (4096, 32768, 128, 528, 16, 16),
    (1, 1000, 128, 528, 8, 1),
    (100000, 256, 128, 528, 1, 2),
])
def test_vocab_splits_cover_the_vocab(n, v, tile_cols, blocks, splits, per):
    got = tce.vocab_splits(n, v, tile_cols, blocks)
    assert got == (splits, per)
    tiles = -(-v // tile_cols)
    # every tile in exactly one split, and no split empty
    assert (splits - 1) * per < tiles <= splits * per


@pytest.mark.parametrize("n", [1, 1000, 4096, 8192, 20000])
@pytest.mark.parametrize("v", [256, 384, 5000, 32768])
def test_vocab_splits_fill_one_wave(n, v):
    """The wgmma K3f's grid (the defaults): every vocab tile in exactly one
    split, no split empty, and never more blocks than one wave of the
    H100's 132 SMs unless the rows alone need more; at the training rows
    (N 8192 and 4096, V 32768) within 4 SMs of a full wave."""
    splits, per = tce.vocab_splits(n, v)
    tiles, row_tiles = -(-v // 256), -(-n // 128)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < tiles <= splits * per
    assert row_tiles * splits <= max(132, row_tiles)
    if v == 32768 and n in (4096, 8192):
        assert 128 <= row_tiles * splits <= 132


def _pair(fused=True, dtype="float32", ce_chunks=4, seed=0):
    tcfg = ttr.TransformerConfig(**KW, fused_qkv=fused, dtype=dtype,
                                 ce_chunks=ce_chunks)
    jcfg = jtr.TransformerConfig(**KW, fused_qkv=fused, ce_chunks=ce_chunks,
                                 dtype=getattr(jnp, dtype))
    tree = init_jax_layout(tcfg, seed)
    tm = ttr.TransformerLM(tcfg, device="cpu")
    return (jtr.TransformerLM(jcfg), jax.tree.map(jnp.asarray, tree), tm,
            from_jax_params(tree, tcfg, "cpu"))


def _batch(b=2, t=24, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _leaf_pairs(jtree, ttree, cfg):
    mine = dict((jax.tree_util.keystr(p), a) for p, a in
                jax.tree_util.tree_leaves_with_path(to_jax_params(ttree,
                                                                  cfg)))
    return [(jax.tree_util.keystr(p), np.asarray(a, np.float32),
             mine[jax.tree_util.keystr(p)])
            for p, a in jax.tree_util.tree_leaves_with_path(jtree)]


@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_grads_with_ce_chunks_match_jax_f32(fused):
    jm, jp, tm, tp = _pair(fused)
    toks, tgts = _batch()
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, jnp.asarray(toks), jnp.asarray(tgts))
    tl, tg = tm.loss_and_grads(tp, torch.from_numpy(toks),
                               torch.from_numpy(tgts))
    assert abs(float(tl) - float(jl)) <= 1e-5
    for path, j, t in _leaf_pairs(jg, tg, tm.config):
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=path)


def test_loss_and_grads_with_ce_chunks_match_jax_flash_path_bf16():
    jm, jp, tm, tp = _pair(dtype="bfloat16")
    toks, tgts = _batch(seed=2)
    try:
        jtr.FLASH_ATTENTION = True
        jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
            jp, jnp.asarray(toks), jnp.asarray(tgts))
    finally:
        jtr.FLASH_ATTENTION = None
    tl, tg = tm.loss_and_grads(tp, torch.from_numpy(toks),
                               torch.from_numpy(tgts))
    assert abs(float(tl) - float(jl)) <= 2e-2
    for path, j, t in _leaf_pairs(jg, tg, tm.config):
        rel = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
        assert rel <= 5e-2, (path, rel)


def test_ce_chunks_equals_the_unchunked_loss():
    """The same weights and batch give the same loss and gradients with
    ce_chunks 4 as with 0 (the chip run holds the bench's rungs to this at
    full width)."""
    _jm, _jp, tm4, tp = _pair(ce_chunks=4)
    tm0 = ttr.TransformerLM(ttr.TransformerConfig(**KW, fused_qkv=True),
                            device="cpu")
    toks, tgts = (torch.from_numpy(a) for a in _batch(seed=3))
    (l4, aux4), g4 = tm4.loss_and_grads(tp, toks, tgts, with_aux=True)
    (l0, aux0), g0 = tm0.loss_and_grads(tp, toks, tgts, with_aux=True)
    assert abs(float(l4) - float(l0)) <= 1e-6
    assert abs(float(aux4["lm_loss"]) - float(aux0["lm_loss"])) <= 1e-6
    for a, b in zip(tree_leaves(g4), tree_leaves(g0)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("return_metrics", [False, True])
def test_three_train_steps_with_ce_chunks_match_jax_f32(return_metrics):
    jm, jp, tm, tp = _pair(ce_chunks=2)
    toks, tgts = _batch(seed=5)
    jstep = jm.make_train_step(optax.adamw(LR), return_metrics)
    tstep = tm.make_train_step(adamw(LR), return_metrics)
    js = optax.adamw(LR).init(jp)
    ts = adamw(LR).init(tp)
    for i in range(3):
        jp, js, jout = jstep(jp, js, jnp.asarray(toks), jnp.asarray(tgts))
        tp, ts, tout = tstep(tp, ts, torch.from_numpy(toks),
                             torch.from_numpy(tgts))
        jl = float(jout["loss"] if return_metrics else jout)
        tl = float(tout["loss"] if return_metrics else tout)
        assert abs(tl - jl) <= 1e-5, (i, tl, jl)
        for path, j, t in _leaf_pairs(jp, tp, tm.config):
            assert np.abs(t - j).max() <= LR * (i + 1), path


@pytest.mark.parametrize("bad,match", [(dict(ce_chunks=1), ">= 2"),
                                       (dict(ce_chunks=5), "divide")])
def test_ce_chunks_config_is_checked(bad, match):
    with pytest.raises(ValueError, match=match):
        ttr.TransformerConfig(**KW, **bad)
    assert ttr.TransformerConfig(**KW, ce_chunks=8).ce_chunks == 8


def test_chunked_softmax_xent_rejects_an_uneven_split():
    (_j), (tx, te, tt) = _inputs("float32", 2)
    with pytest.raises(ValueError, match="divide"):
        tce.chunked_softmax_xent(tx, te, tt, 3)


def test_trains_bf16_with_ce_chunks():
    """12 AdamW steps of a bf16 model with ce_chunks on one batch bring the
    loss under 0.8 of its start (as the JAX package's own ce_chunks
    training test)."""
    cfg = ttr.TransformerConfig(vocab_size=96, n_layers=2, n_heads=2,
                                d_model=32, max_len=16, ce_chunks=4,
                                dtype="bfloat16", fused_qkv=True)
    tm = ttr.TransformerLM(cfg, device="cpu")
    params = tm.init_params(0)
    opt = adamw(1e-2)
    state, step = opt.init(params), tm.make_train_step(opt)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 96, (4, 16)).astype(np.int32))
    tgts = torch.roll(toks, -1, dims=1)
    losses = []
    for _ in range(12):
        params, state, loss = step(params, state, toks, tgts)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses
