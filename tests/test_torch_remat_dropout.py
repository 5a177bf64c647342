"""The port's rematerialisation (``remat`` with each ``remat_policy``) and
dropout against the JAX package's, at a tiny size.

Remat: the port's loss and gradients with each policy equal the JAX
remat model's (f32, atol 1e-5, as the dense training tests) and the port's
own without remat (atol 1e-6: the same arithmetic; the recompute replays
it). That the recompute ran is shown by counting the attention forward's
calls (twice per layer under remat) and, for the policies, which products
the backward recomputed.

Dropout: the JAX package draws threefry bits, which the port cannot
reproduce, so its masks are held by distribution (the keep share within
5σ of 1 − p), by exactness of the kept entries (x / keep), by determinism
per (rng, site), and by an exact match of the loss and gradients with the
JAX model when both are fed JAX's ``bernoulli(fold_in(rng, i))`` masks
(f32, atol 1e-5).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.parallel import moe as jmoe
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                     init_jax_layout,
                                                     to_jax_params)
from deeplearning4j_tpu_torch.nn import _remat
from deeplearning4j_tpu_torch.optim.adamw import adamw
from deeplearning4j_tpu_torch.parallel import moe as tmoe
from deeplearning4j_tpu_torch.tree import tree_leaves

KW = dict(vocab_size=64, n_layers=2, n_heads=2, d_model=32, max_len=32)
POLICIES = [None, "dots", "dots_no_batch", "nothing"]
LR = 3e-4


def _pair(moe=False, **kw):
    tkw, jkw = dict(kw), dict(kw)
    if moe:
        tkw["moe"] = tmoe.MoEConfig(num_experts=4, capacity_factor=4.0)
        jkw["moe"] = jmoe.MoEConfig(num_experts=4, capacity_factor=4.0)
    tcfg = ttr.TransformerConfig(**KW, fused_qkv=True, **tkw)
    jcfg = jtr.TransformerConfig(**KW, fused_qkv=True, **jkw)
    tree = init_jax_layout(tcfg, 0)
    return (jtr.TransformerLM(jcfg), jax.tree.map(jnp.asarray, tree),
            ttr.TransformerLM(tcfg, device="cpu"),
            from_jax_params(tree, tcfg, "cpu"))


def _batch(b=2, t=16, seed=1):
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


@pytest.fixture
def attention_calls(monkeypatch):
    """Counts the attention forward's calls (``fa.FlashAttention`` looks
    the function up at call time)."""
    calls = []
    kernel = fa.flash_attention_fwd

    def counted(*a, **k):
        calls.append(1)
        return kernel(*a, **k)
    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("moe", [False, True])
def test_remat_matches_jax_remat_and_no_remat(policy, moe, attention_calls):
    jm, jp, tm, tp = _pair(moe, remat=True, remat_policy=policy)
    toks, tgts = _batch()
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, jnp.asarray(toks), jnp.asarray(tgts))
    tl, tg = tm.loss_and_grads(tp, torch.from_numpy(toks),
                               torch.from_numpy(tgts))
    # the forward once per layer, and again per layer in the recompute
    assert len(attention_calls) == 2 * KW["n_layers"]
    assert abs(float(tl) - float(jl)) <= 1e-5
    for path, j, t in _leaf_pairs(jg, tg, tm.config):
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=path)
    _jm, _jp, plain, _tp = _pair(moe)
    attention_calls.clear()
    pl, pg = plain.loss_and_grads(tp, torch.from_numpy(toks),
                                  torch.from_numpy(tgts))
    assert len(attention_calls) == KW["n_layers"]
    assert abs(float(tl) - float(pl)) <= 1e-6
    for a, b in zip(tree_leaves(tg), tree_leaves(pg)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(policy, remat=True):
    """mm and bmm calls during the backward of the MoE model's loss."""
    _jm, _jp, tm, tp = _pair(True, remat=remat, remat_policy=policy)
    toks, tgts = (torch.from_numpy(a) for a in _batch())
    leaves = [a.detach().requires_grad_() for a in tree_leaves(tp)]
    from deeplearning4j_tpu_torch.tree import tree_unflatten
    loss = tm.loss_fn(tree_unflatten(tp, leaves), toks, tgts)
    with _CountProducts() as mode:
        torch.autograd.grad(loss, leaves)
    return mode.n


def test_policies_keep_the_named_products():
    """What the backward recomputes beyond the plain backward's own
    products: everything under full recompute; no mm under "dots_no_batch"
    but the batched expert products (and attention's, on the CPU); no
    product at all under "dots"."""
    base = _backward_products(None, remat=False)
    extra = {p: {k: n - base[k] for k, n in _backward_products(p).items()}
             for p in POLICIES}
    assert extra[None] == extra["nothing"]
    assert extra["nothing"]["mm"] > 0 and extra["nothing"]["bmm"] > 0
    assert extra["dots_no_batch"]["mm"] == 0
    assert extra["dots_no_batch"]["bmm"] == extra["nothing"]["bmm"]
    assert extra["dots"] == {"mm": 0, "bmm": 0}


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        ttr.TransformerConfig(**KW, remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        _remat.remat(lambda x: x, "dots_with_batch")
    assert _remat._POLICY_NAMES == ("dots", "dots_no_batch", "nothing")
    assert _remat.checkpoint_policy(None) is None
    assert _remat.checkpoint_policy("nothing") is None


# ------------------------------------------------------------------ dropout
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keep_share_and_scale(dtype):
    p = 0.3
    tm = ttr.TransformerLM(ttr.TransformerConfig(**KW, dropout=p),
                           device="cpu")
    x = torch.randn((64, 33, 48), generator=torch.Generator().manual_seed(0)
                    ).to(dtype)
    y = tm._dropout(x, 7, 3)
    assert y.dtype == dtype and y.shape == x.shape
    kept = y != 0
    n = x.numel()
    sigma = math.sqrt(p * (1 - p) / n)
    assert abs(kept.float().mean().item() - (1 - p)) <= 5 * sigma
    # kept entries are exactly x / keep in x's dtype, the rest exactly 0
    assert torch.equal(y[kept], (x / (1 - p))[kept])
    assert torch.equal(torch.where(kept, y, x), torch.where(kept, x / (1 - p),
                                                             x))


def test_dropout_mask_repeats_per_rng_and_site():
    shape, dev = (16, 40), torch.device("cpu")
    m = ttr.dropout_mask(3, 5, 0.5, shape, dev)
    assert m.dtype == torch.bool
    assert torch.equal(m, ttr.dropout_mask(3, 5, 0.5, shape, dev))
    assert not torch.equal(m, ttr.dropout_mask(3, 6, 0.5, shape, dev))
    assert not torch.equal(m, ttr.dropout_mask(4, 5, 0.5, shape, dev))
    # no rng, or a zero rate: the identity
    tm = ttr.TransformerLM(ttr.TransformerConfig(**KW, dropout=0.5),
                           device="cpu")
    x = torch.randn(shape)
    assert tm._dropout(x, None, 0) is x
    tm0 = ttr.TransformerLM(ttr.TransformerConfig(**KW), device="cpu")
    assert tm0._dropout(x, 3, 0) is x


@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_with_dropout_gives_dropouts_gradients(policy):
    """The recompute redraws each site's mask from (rng, site), so remat
    with dropout is dropout without remat."""
    _jm, _jp, tm, tp = _pair(dropout=0.2, remat=True, remat_policy=policy)
    _jm, _jp, plain, _tp = _pair(dropout=0.2)
    toks, tgts = (torch.from_numpy(a) for a in _batch(seed=4))
    rl, rg = tm.loss_and_grads(tp, toks, tgts, rng=11)
    pl, pg = plain.loss_and_grads(tp, toks, tgts, rng=11)
    nl, _ = plain.loss_and_grads(tp, toks, tgts)
    assert abs(float(rl) - float(pl)) <= 1e-6
    assert abs(float(pl) - float(nl)) > 1e-3        # dropout did something
    for a, b in zip(tree_leaves(rg), tree_leaves(pg)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def _jax_masks(monkeypatch, key):
    """Hand the port JAX's masks: ``bernoulli(fold_in(key, i), keep)``."""
    def mask(rng, i, keep, shape, device):
        m = jax.random.bernoulli(jax.random.fold_in(key, i), keep,
                                 tuple(shape))
        return torch.from_numpy(np.array(m)).to(device)
    monkeypatch.setattr(ttr, "dropout_mask", mask)


@pytest.mark.parametrize("extra", [{}, dict(remat=True, ce_chunks=4)])
def test_dropout_matches_jax_with_jax_masks(monkeypatch, extra):
    jm, jp, tm, tp = _pair(dropout=0.25, **extra)
    key = jax.random.key(3)
    _jax_masks(monkeypatch, key)
    toks, tgts = _batch(seed=6)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, jnp.asarray(toks), jnp.asarray(tgts), key)
    tl, tg = tm.loss_and_grads(tp, torch.from_numpy(toks),
                               torch.from_numpy(tgts), rng=0)
    assert abs(float(tl) - float(jl)) <= 1e-5
    for path, j, t in _leaf_pairs(jg, tg, tm.config):
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=path)
    # and the apply in training mode, logits
    jlog = jm.apply(jp, jnp.asarray(toks), rng=key)
    np.testing.assert_allclose(
        tm.apply(tp, torch.from_numpy(toks), rng=0).numpy(),
        np.asarray(jlog), atol=1e-4)


def test_three_train_steps_with_dropout_match_jax(monkeypatch):
    """The JAX step takes one key a step; the port one seed, mapped to the
    same key by the mask hook."""
    jm, jp, tm, tp = _pair(dropout=0.1, remat=True)
    keys = {s: jax.random.key(100 + s) for s in range(3)}

    def mask(rng, i, keep, shape, device):
        m = jax.random.bernoulli(jax.random.fold_in(keys[rng], i), keep,
                                 tuple(shape))
        return torch.from_numpy(np.array(m)).to(device)
    monkeypatch.setattr(ttr, "dropout_mask", mask)
    toks, tgts = _batch(seed=8)
    jstep = jm.make_train_step(optax.adamw(LR))
    tstep = tm.make_train_step(adamw(LR))
    js, ts = optax.adamw(LR).init(jp), adamw(LR).init(tp)
    for i in range(3):
        jp, js, jl = jstep(jp, js, jnp.asarray(toks), jnp.asarray(tgts),
                           keys[i])
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(toks),
                           torch.from_numpy(tgts), i)
        assert abs(float(tl) - float(jl)) <= 1e-5, i
        for path, j, t in _leaf_pairs(jp, tp, tm.config):
            assert np.abs(t - j).max() <= LR * (i + 1), path
