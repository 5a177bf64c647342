"""The port's MoE FFN (routing, K7's plain versions, the flagship with
``moe``) against the JAX package's, at a tiny size.

The same params and inputs, made with numpy from a seed, go through
``deeplearning4j_tpu.parallel.moe`` and ``deeplearning4j_tpu_torch.parallel.
moe`` (and the two ``TransformerLM``s) on the CPU. Tolerances (PERF.md
states them):

- f32: routing (each choice's expert and drop) exactly equal, and the
  dropped fraction; y and the aux loss atol 1e-6, every gradient rtol 1e-5
  and atol 5e-6 (the same arithmetic, f32 sums in another order; the
  gradients reach ~20 here, and a sum that cancels keeps their ulps); the per-expert fractions atol
  1e-7 (the mean of the same 0/1 values rounds one ulp apart);
- bf16: router probabilities round at other points on the two sides, so
  near-equal experts can swap: held by the share of tokens routed
  identically (>= 0.97, set from readings: 1.0 at these sizes) and by y on
  those tokens (two bf16 ulps, rtol 2^-6 with atol 2e-2: the outputs reach
  ~2.5 and both round every product to bf16, at different points); no expert queue here passes 256,
  where the reference's bf16 positions collide;
- the flagship, f32: loss, aux entries and every grad leaf atol 1e-5 (as
  the dense training tests), 3 train steps' losses atol 1e-5, greedy
  decode tokens exactly equal.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deeplearning4j_tpu.models import generation as jgen
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.parallel import moe as jmoe
from deeplearning4j_tpu_torch.kernels import moe_route as mr
from deeplearning4j_tpu_torch.models import generation as tgen
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import (adamw_state_from_numpy,
                                                     adamw_state_to_numpy,
                                                     from_jax_params,
                                                     init_jax_layout,
                                                     to_jax_params)
from deeplearning4j_tpu_torch.optim.adamw import adamw
from deeplearning4j_tpu_torch.parallel import moe as tmoe
from deeplearning4j_tpu_torch.tree import tree_leaves, tree_unflatten

D, F, E = 16, 32, 4
KW = dict(vocab_size=64, n_layers=2, n_heads=2, d_model=32, max_len=32)
LR = 3e-4


def _params(seed=0, scale=0.3, e=E, d=D, f=F):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    cfg = tmoe.MoEConfig(d_model=d, d_ff=f, num_experts=e)
    tree = tmoe.moe_layout(cfg, normal)
    tree["b1"] = normal(e, f)
    tree["b2"] = normal(e, d)
    return tree


def _both(tree, dtype="float32"):
    jp = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in tree.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in tree.items()}
    return jp, tp


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _cfgs(top_k, cf, e=E, d=D, f=F):
    return (jmoe.MoEConfig(d_model=d, d_ff=f, num_experts=e, top_k=top_k,
                           capacity_factor=cf),
            tmoe.MoEConfig(d_model=d, d_ff=f, num_experts=e, top_k=top_k,
                           capacity_factor=cf))


def _jax_routing(jp, jx, cfg):
    """(choices (G, K), kept (G, K)) by the reference's own arithmetic,
    read back from its dispatch: which (expert, slot) each choice took."""
    xt = jx.reshape(-1, jx.shape[-1])
    probs = jax.nn.softmax(xt @ jp["Wg"], axis=-1)
    idx = np.asarray(jnp.argmax(probs, axis=-1))
    ch = [idx]
    if cfg.top_k == 2:
        oh = jax.nn.one_hot(idx, cfg.num_experts, dtype=jx.dtype)
        ch.append(np.asarray(jnp.argmax(probs * (1.0 - oh), axis=-1)))
    return np.stack(ch, -1)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [4.0, 0.5])          # no drops / drops
def test_moe_ffn_matches_jax_f32(top_k, cf):
    jcfg, tcfg = _cfgs(top_k, cf)
    jp, tp = _both(_params(seed=top_k))
    jx, tx = _x((2, 12, D), seed=7)
    w = np.random.default_rng(8).standard_normal((2, 12, D),
                                                 dtype=np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, jcfg)
        return jnp.sum(y * w) + aux["aux_loss"], (y, aux)

    (jl, (jy, jaux)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(jp, jx)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    y, aux = tmoe.moe_ffn(leaves, x, tcfg)
    loss = (y * torch.from_numpy(w)).sum() + aux["aux_loss"]
    grads = torch.autograd.grad(loss, [*leaves.values(), x])
    # routing: the same expert for every choice, and the same drops
    G = 24
    probs = torch.softmax(tx.reshape(G, D) @ tp["Wg"], -1)
    choices, _g, slot, src, _oh = tmoe.route(probs, tcfg,
                                             tmoe.capacity(G, tcfg))
    np.testing.assert_array_equal(choices.numpy(), _jax_routing(jp, jx,
                                                                jcfg))
    assert (float(aux["dropped_fraction"])
            == float(jaux["dropped_fraction"]))
    assert (float(aux["dropped_fraction"]) > 0) == (cf < 1)
    np.testing.assert_allclose(aux["expert_fraction"].numpy(),
                               np.asarray(jaux["expert_fraction"]),
                               atol=1e-7)
    assert abs(float(aux["aux_loss"]) - float(jaux["aux_loss"])) <= 1e-6
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-6)
    for name, got in zip([*leaves, "x"], grads):
        want = jg[1] if name == "x" else jg[0][name]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=5e-6, err_msg=name)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_dense_reference_without_drops(top_k):
    jcfg, tcfg = _cfgs(top_k, 4.0)
    jp, tp = _both(_params(seed=3))
    jx, tx = _x((2, 6, D), seed=4)
    y, aux = tmoe.moe_ffn(tp, tx, tcfg)
    dense = tmoe.moe_reference_dense(tp, tx, tcfg)
    assert float(aux["dropped_fraction"]) == 0.0
    torch.testing.assert_close(y, dense, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(jmoe.moe_reference_dense(jp, jx, jcfg)),
        atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_bf16_routes_as_jax(top_k):
    """bf16 at 128 tokens over 4 experts (no queue past 256): the share of
    tokens routed identically, and y on those tokens."""
    jcfg, tcfg = _cfgs(top_k, 2.0)
    jp, tp = _both(_params(seed=5), "bfloat16")
    jx, tx = _x((2, 64, D), seed=6, dtype="bfloat16")
    jy, jaux = jmoe.moe_ffn(jp, jx, jcfg)
    y, aux = tmoe.moe_ffn(tp, tx, tcfg)
    assert y.dtype == torch.bfloat16 and aux["aux_loss"].dtype == \
        torch.bfloat16
    G = 128
    probs = torch.softmax(tx.reshape(G, D) @ tp["Wg"], -1)
    choices, _g, slot, _src, _oh = tmoe.route(probs, tcfg,
                                              tmoe.capacity(G, tcfg))
    same = (choices.numpy() == _jax_routing(jp, jx, jcfg)).all(-1)
    # a token also needs every choice kept on both sides to compare y; at
    # cf 2 nothing drops on either
    assert float(jaux["dropped_fraction"]) == 0.0
    assert int((slot < 0).sum()) == 0
    assert same.mean() >= 0.97, same.mean()
    got = y.float().reshape(G, D).numpy()[same]
    want = np.asarray(jy.astype(jnp.float32)).reshape(G, D)[same]
    np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=2e-2)
    assert abs(float(aux["aux_loss"]) - float(jaux["aux_loss"])) <= 2e-2


def test_bf16_positions_are_one_to_one_where_the_reference_collides():
    """G = 1024 tokens over E = 2 experts in bf16, capacity for all
    (cf 2). The reference numbers queue places with a bf16 cumsum
    (``parallel/moe.py:97-100``), exact only up to 256: its kept tokens
    share (expert, slot) pairs, and the tokens that share a slot have their
    inputs summed there, so its output leaves its own uncapped path. The
    port's int32 count gives every token a slot of its own and keeps to
    its uncapped path."""
    jcfg, tcfg = _cfgs(1, 2.0, e=2)
    jp, tp = _both(_params(seed=9, e=2), "bfloat16")
    jx, tx = _x((4, 256, D), seed=10, dtype="bfloat16")
    G = 1024
    # the reference's own expression for the queue places
    xt = jx.reshape(G, D)
    idx = jnp.argmax(jax.nn.softmax(xt @ jp["Wg"], axis=-1), axis=-1)
    onehot = jax.nn.one_hot(idx, 2, dtype=jnp.bfloat16)
    pos = np.asarray(jnp.cumsum(onehot, axis=0) * onehot - 1.0,
                     np.float32).max(-1).astype(np.int64)
    ref_pairs = set(zip(np.asarray(idx).tolist(), pos.tolist()))
    assert len(ref_pairs) < G                # slots shared
    probs = torch.softmax(tx.reshape(G, D) @ tp["Wg"], -1)
    _c, _g, slot, src, _oh = tmoe.route(probs, tcfg, tmoe.capacity(G, tcfg))
    kept = slot[slot >= 0]
    assert kept.numel() == G and kept.unique().numel() == G
    assert int((src >= 0).sum()) == G
    # the consequence in y: the reference's capped path leaves its uncapped
    # one on the tokens that share slots; the port's stays on its own
    jy, _ = jmoe.moe_ffn(jp, jx, jcfg)
    jdense = jmoe.moe_reference_dense(jp, jx, jcfg)
    ref_off = np.abs(np.asarray(jy, np.float32)
                     - np.asarray(jdense, np.float32)).max(-1).reshape(-1)
    y, _ = tmoe.moe_ffn(tp, tx, tcfg)
    dense = tmoe.moe_reference_dense(tp, tx, tcfg)
    off = (y.float() - dense.float()).abs().amax(-1).reshape(-1)
    assert (ref_off > 0.25).mean() > 0.2
    assert float(off.max()) <= 0.05


def test_k7_plain_versions_match_the_one_hot_einsums():
    """dispatch, combine and combine's backward by index maps against the
    reference's one-hot einsums over the same routing (top-2, drops)."""
    rng = np.random.default_rng(11)
    G, K, C, d = 12, 2, 4, 8
    x = torch.from_numpy(rng.standard_normal((G, d), dtype=np.float32))
    probs = torch.softmax(torch.from_numpy(
        rng.standard_normal((G, E), dtype=np.float32)), -1)
    cfg = tmoe.MoEConfig(d_model=d, d_ff=d, num_experts=E, top_k=K)
    choices, gates, slot, src, _oh = tmoe.route(probs, cfg, C)
    assert int((slot < 0).sum()) > 0            # some choices drop
    onehot = torch.zeros((G, K, E * C))
    for g in range(G):
        for k in range(K):
            if slot[g, k] >= 0:
                onehot[g, k, slot[g, k]] = 1.0
    dispatch = onehot.sum(1)                                  # (G, E·C)
    combine = (onehot * gates[:, :, None]).sum(1)
    ei = mr.dispatch_reference(x, src, K)
    torch.testing.assert_close(ei, dispatch.T @ x)
    out_e = torch.from_numpy(rng.standard_normal((E * C, d),
                                                 dtype=np.float32))
    torch.testing.assert_close(mr.combine_reference(out_e, slot, gates),
                               combine @ out_e)
    torch.testing.assert_close(mr.combine_reference(ei, slot),
                               dispatch @ ei)
    dy = torch.from_numpy(rng.standard_normal((G, d), dtype=np.float32))
    d_out, d_gates = mr.dispatch_grad_reference(dy, src, K, gates, out_e)
    torch.testing.assert_close(d_out, combine.T @ dy)
    want = torch.einsum("gd,gkc,cd->gk", dy, onehot, out_e)
    torch.testing.assert_close(d_gates, want)
    # CPU tensors take the plain versions and launch nothing
    mr.launches_dispatch = mr.launches_combine = 0
    mr.moe_dispatch(x, src, K), mr.moe_combine(ei, slot, gates)
    mr.moe_dispatch_grad(dy, src, K, gates, out_e)
    assert (mr.launches_dispatch, mr.launches_combine) == (0, 0)


def test_top2_second_choices_queue_behind_first():
    """Capacity for the first choices only: every first choice is kept and
    the second choices fill what is left, behind them."""
    cfg = tmoe.MoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=2,
                         capacity_factor=0.5)
    _jp, tp = _both(_params(seed=0))
    _jx, tx = _x((2, 16, D), seed=2)
    G = 32
    n_cap = tmoe.capacity(G, cfg)
    probs = torch.softmax(tx.reshape(G, D) @ tp["Wg"], -1)
    choices, _g, slot, _src, _oh = tmoe.route(probs, cfg, n_cap)
    firsts = torch.bincount(choices[:, 0], minlength=E)
    for e in range(E):
        pos1 = slot[:, 0][(choices[:, 0] == e) & (slot[:, 0] >= 0)] - e * n_cap
        pos2 = slot[:, 1][(choices[:, 1] == e) & (slot[:, 1] >= 0)] - e * n_cap
        assert pos1.numel() == min(int(firsts[e]), n_cap)
        if pos2.numel():
            assert int(pos2.min()) >= int(firsts[e])
    y, aux = tmoe.moe_ffn(tp, tx, cfg)
    assert float(aux["dropped_fraction"]) > 0.0
    assert bool(torch.isfinite(y).all())


def test_capacity_sweep_drop_rate_telemetry():
    """As capacity_factor rises the dropped fraction falls to 0, and the
    routed fractions are a distribution over the experts."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 16, 8), dtype=np.float32))
    tree = _params(seed=1, scale=0.02, d=8, f=16)
    tp = {k: torch.from_numpy(v) for k, v in tree.items()}
    drops = []
    for cf in (0.25, 0.5, 1.0, 4.0):
        cfg = tmoe.MoEConfig(d_model=8, d_ff=16, num_experts=E,
                             capacity_factor=cf)
        _y, stats = tmoe.moe_ffn(tp, x, cfg)
        drops.append(float(stats["dropped_fraction"]))
    assert all(a >= b - 1e-6 for a, b in zip(drops, drops[1:])), drops
    assert drops[0] > 0.0 and drops[-1] == 0.0, drops
    assert abs(float(stats["expert_fraction"].sum()) - 1.0) < 1e-6


def test_moe_config_is_checked():
    with pytest.raises(ValueError, match="top_k"):
        tmoe.MoEConfig(top_k=3)
    with pytest.raises(ValueError, match="unset"):
        tmoe.moe_ffn({}, torch.zeros((1, 2, 8)), tmoe.MoEConfig())
    assert tmoe.capacity(8192, tmoe.MoEConfig(num_experts=8)) == 1280
    assert tmoe.capacity(10, tmoe.MoEConfig(num_experts=4, top_k=2,
                                            capacity_factor=1.0)) == \
        math.ceil(10 / 4 * 2)


def test_router_noise_with_an_rng_is_a_seeded_uniform_jitter():
    """The jitter is uniform in [1 - noise, 1 + noise) per logit: a seeded
    draw repeats, another seed differs, and without an rng (the flagship)
    nothing is added."""
    cfg = tmoe.MoEConfig(d_model=D, d_ff=F, num_experts=E,
                         router_noise=0.5, capacity_factor=4.0)
    _jp, tp = _both(_params(seed=2))
    _jx, tx = _x((4, 64, D), seed=3)
    y1, _ = tmoe.moe_ffn(tp, tx, cfg, rng=5)
    y2, _ = tmoe.moe_ffn(tp, tx, cfg, rng=5)
    y3, _ = tmoe.moe_ffn(tp, tx, cfg, rng=6)
    y0, _ = tmoe.moe_ffn(tp, tx, cfg)
    quiet = tmoe.MoEConfig(d_model=D, d_ff=F, num_experts=E,
                           capacity_factor=4.0)
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    assert not torch.equal(y1, y3)
    torch.testing.assert_close(y0, tmoe.moe_ffn(tp, tx, quiet)[0])
    g = torch.Generator().manual_seed(5)
    noise = 0.5 + torch.rand((256, E), generator=g)
    assert abs(float(noise.mean()) - 1.0) < 5 * 0.5 / math.sqrt(3 * 256 * E)
    assert 0.5 <= float(noise.min()) and float(noise.max()) < 1.5


# ------------------------------------------------------------- the flagship
def _flagship(top_k=1, cf=4.0, dtype="float32", seed=0, **kw):
    tcfg = ttr.TransformerConfig(**KW, fused_qkv=True, dtype=dtype,
                                 moe=tmoe.MoEConfig(num_experts=E,
                                                    capacity_factor=cf,
                                                    top_k=top_k), **kw)
    jcfg = jtr.TransformerConfig(**KW, fused_qkv=True,
                                 dtype=getattr(jnp, dtype),
                                 moe=jmoe.MoEConfig(num_experts=E,
                                                    capacity_factor=cf,
                                                    top_k=top_k), **kw)
    tree = init_jax_layout(tcfg, seed)
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


def test_moe_config_resolves_dims_and_params_have_expert_leaves():
    _jm, _jp, tm, tp = _flagship()
    assert tm.config.moe.d_model == 32 and tm.config.moe.d_ff == 128
    assert tp["blocks"][0]["moe"]["W1"].shape == (E, 32, 128)
    assert "mlp" not in tp["blocks"][0]
    with pytest.raises(TypeError, match="MoEConfig"):
        ttr.TransformerConfig(**KW, moe=jmoe.MoEConfig())


@pytest.mark.parametrize("top_k,cf,extra", [
    (1, 4.0, {}), (2, 4.0, {}), (1, 0.5, {}),
    # every single-device option at once
    (2, 1.0, dict(remat=True, remat_policy="dots", ce_chunks=4))])
def test_flagship_with_moe_matches_jax_f32(top_k, cf, extra):
    jm, jp, tm, tp = _flagship(top_k, cf, **extra)
    toks, tgts = _batch()
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, a, b: jm.loss_fn(p, a, b, with_aux=True), has_aux=True))(
        jp, jnp.asarray(toks), jnp.asarray(tgts))
    (tl, taux), tg = tm.loss_and_grads(tp, torch.from_numpy(toks),
                                       torch.from_numpy(tgts), with_aux=True)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert set(taux) == set(jaux)
    for k in taux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   atol=1e-5, err_msg=k)
    assert taux["moe_expert_fraction"].shape == (E,)
    assert float(taux["moe_aux_loss"]) > 0.5
    for path, j, t in _leaf_pairs(jg, tg, tm.config):
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=path)


def test_three_train_steps_with_moe_match_jax_f32():
    jm, jp, tm, tp = _flagship(top_k=2)
    toks, tgts = _batch(seed=5)
    jstep = jm.make_train_step(optax.adamw(LR), return_metrics=True)
    tstep = tm.make_train_step(adamw(LR), return_metrics=True)
    js, ts = optax.adamw(LR).init(jp), adamw(LR).init(tp)
    for i in range(3):
        jp, js, jm_ = jstep(jp, js, jnp.asarray(toks), jnp.asarray(tgts))
        tp, ts, tm_ = tstep(tp, ts, torch.from_numpy(toks),
                            torch.from_numpy(tgts))
        for k in ("loss", "lm_loss", "moe_aux_loss"):
            assert abs(float(tm_[k]) - float(jm_[k])) <= 1e-5, (i, k)
        for path, j, t in _leaf_pairs(jp, tp, tm.config):
            assert np.abs(t - j).max() <= LR * (i + 1), path


@pytest.mark.parametrize("page_tokens", [0, 16])
def test_moe_greedy_decode_matches_jax_tokens(page_tokens):
    """Capacity for every token (cf = num_experts): a full-sequence apply
    could drop what single-token decode keeps otherwise."""
    jm, jp, tm, tp = _flagship(top_k=2, cf=float(E))
    prompt = np.random.default_rng(3).integers(
        0, KW["vocab_size"], (2, 7)).astype(np.int32)
    ref = jgen.DecodeEngine(jm, jp, max_len=24,
                            page_tokens=page_tokens).generate(prompt, 6)
    got = tgen.DecodeEngine(tm, tp, max_len=24, page_tokens=page_tokens,
                            device="cpu").generate(prompt, 6)
    np.testing.assert_array_equal(got, np.asarray(ref))
    # and the decode matches the port's own full forward (teacher forcing)
    full = np.concatenate([prompt, got[:, :-1]], axis=1)
    logits = tm.apply(tp, torch.from_numpy(full))
    np.testing.assert_array_equal(
        logits[:, prompt.shape[1] - 1:].argmax(-1).numpy(), got)


@pytest.mark.parametrize("scan", [False, True])
def test_moe_params_and_adamw_state_round_trip(scan):
    cfg = ttr.TransformerConfig(**KW, scan_layers=scan,
                                moe=tmoe.MoEConfig(num_experts=E))
    tree = init_jax_layout(cfg, 6)
    if scan:
        assert tree["blocks"]["moe"]["W2"].shape == (2, E, 128, 32)
    tp = from_jax_params(tree, cfg, "cpu")
    assert tp["blocks"][1]["moe"]["b1"].shape == (E, 128)
    back = to_jax_params(tp, cfg)
    flat_a, def_a = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    opt = adamw(LR)
    st = opt.init(tp)
    g = tree_unflatten(tp, [torch.full_like(a, 0.5)
                            for a in tree_leaves(tp)])
    _u, st = opt.update(g, st, tp)
    back = adamw_state_from_numpy(adamw_state_to_numpy(st, cfg), cfg, "cpu")
    for a, b in zip(tree_leaves(st.mu), tree_leaves(back.mu)):
        assert torch.equal(a, b)
    # a dense tree does not load into a MoE config, nor the other way
    with pytest.raises(ValueError, match="moe"):
        from_jax_params(init_jax_layout(ttr.TransformerConfig(**KW), 0),
                        cfg, "cpu")
    with pytest.raises(ValueError, match="mlp"):
        from_jax_params(tree, ttr.TransformerConfig(**KW), "cpu")


def test_aux_loss_in_metrics_and_loss_decreases():
    """12 steps of the MoE flagship with ``return_metrics``: the loss falls
    under 0.7 of its start, the Switch aux loss stays finite near its floor
    of 1 per layer, and the drop rate and per-expert fractions ride the
    metrics (as the JAX package's own flagship MoE test)."""
    cfg = ttr.TransformerConfig(**dict(KW, max_len=16), fused_qkv=True,
                                moe=tmoe.MoEConfig(num_experts=E,
                                                   capacity_factor=4.0))
    tm = ttr.TransformerLM(cfg, device="cpu")
    params = tm.init_params(0)
    opt = adamw(1e-2)
    state, step = opt.init(params), tm.make_train_step(opt, True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, KW["vocab_size"], (4, 16)).astype(np.int32))
    tgts = torch.roll(toks, -1, dims=1)
    losses, auxes = [], []
    for _ in range(12):
        params, state, metrics = step(params, state, toks, tgts)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["moe_aux_loss"]))
    assert losses[-1] < losses[0] * 0.7, losses
    assert all(np.isfinite(a) and a > 0.5 for a in auxes), auxes
    assert "lm_loss" in metrics
    assert 0.0 <= float(metrics["moe_dropped_fraction"]) <= 1.0
    frac = metrics["moe_expert_fraction"]
    assert frac.shape == (E,) and 0.0 <= float(frac.sum()) <= 1.0 + 1e-5


def test_top2_output_blends_two_experts():
    """Top-2 output differs from top-1 on the same params and input: the
    second expert contributes."""
    _jp, tp = _both(_params(seed=0))
    _jx, tx = _x((2, 6, D), seed=1)
    cfg2 = tmoe.MoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=2,
                          capacity_factor=4.0)
    cfg1 = tmoe.MoEConfig(d_model=D, d_ff=F, num_experts=E, top_k=1,
                          capacity_factor=8.0)
    y2, _ = tmoe.moe_ffn(tp, tx, cfg2)
    y1, _ = tmoe.moe_ffn(tp, tx, cfg1)
    assert not torch.allclose(y1, y2, atol=1e-4)


def test_learned_router_balances_load():
    """Training a top-2 MoE FFN with the aux load-balance loss on inputs
    clustered so the fresh router is imbalanced: the largest first-choice
    fraction shrinks and the aux loss falls (as the JAX package's own
    test)."""
    d, f = 8, 16
    cfg = tmoe.MoEConfig(d_model=d, d_ff=f, num_experts=E, top_k=2,
                         capacity_factor=4.0)
    params = tmoe.init_moe_params(cfg, seed=0, scale=0.3, device="cpu")
    rng = np.random.default_rng(4)
    base = rng.normal(size=(1, 1, d)) * 2.0
    x = torch.tensor(base + 0.3 * rng.normal(size=(8, 16, d)),
                     dtype=torch.float32)
    target = torch.tensor(rng.normal(size=(8, 16, d)), dtype=torch.float32)
    opt = adamw(5e-2, weight_decay=0.0)          # Adam
    state = opt.init(params)
    from deeplearning4j_tpu_torch.optim.adamw import apply_updates

    def step(p, s):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        y, aux = tmoe.moe_ffn(leaves, x, cfg)
        loss = ((y - target) ** 2).mean() + 0.05 * aux["aux_loss"]
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        up, s = opt.update(grads, s, p)
        return apply_updates(p, up), s, aux

    params, state, aux0 = step(params, state)
    aux = aux0
    for _ in range(60):
        params, state, aux = step(params, state)
    imb0 = float(aux0["expert_fraction"].max())
    imb1 = float(aux["expert_fraction"].max())
    assert imb1 < imb0 - 0.05, (imb0, imb1)
    assert float(aux["aux_loss"]) < float(aux0["aux_loss"])
