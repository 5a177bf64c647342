"""The head-dim domain of the port's flash attention, the numpy emulation
of the f32 forward's products, and the model at head dims beyond the old
kernels' 16-128, on the CPU.

- :func:`fa.kernel_for` maps every ``d % 8 == 0`` in [8, 256] to a kernel
  pair for f32 and bf16 (the wgmma pair only for bf16 at 64 and 128) and
  raises outside that domain.
- :func:`fa.tf32_round` is ``cvt.rna.tf32.f32`` (round to nearest, ties
  away from zero, 10 explicit mantissa bits); :func:`fa.tf32_split` and
  :func:`fa.split_matmul` are the three-product split the f32 forward
  computes on tensor cores. The split's attention forward meets K1's f32
  row of PERF.md's tolerance table against the JAX ``flash_attention``
  (Pallas interpret mode), o atol 5e-5 and lse atol 1e-3, at BWD_CASES'
  f32 shapes scaled down. (The f32 backward kernel multiplies in f32, not
  on the split: PERF.md §6.)
- ``TransformerLM`` at head dims 40 and 256 against the JAX model:
  ``prefill`` and ``loss_fn``'s gradients, f32 and bf16 (JAX on its flash
  path), at PERF.md's rows for the model (prefill atol 1e-4 f32 and 5e-2
  bf16; loss and every leaf atol 1e-5 f32; bf16 loss atol 2e-2 and each
  leaf's relative L2 ≤ 5e-2).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.kernels.flash_attention import _fwd_pallas
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                     init_jax_layout,
                                                     to_jax_params)

DTYPES = (torch.float32, torch.bfloat16)


# ------------------------------------------------------ head-dim domain
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_for_takes_every_multiple_of_8_up_to_256(dtype, d):
    want = ("wgmma" if dtype == torch.bfloat16 and d in (64, 128)
            else "simple")
    assert fa.kernel_for(dtype, d) == want


def test_head_dims_are_the_multiples_of_8_in_8_to_256():
    assert fa.HEAD_DIMS == tuple(range(8, 257, 8)) and len(fa.HEAD_DIMS) == 32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [0, 4, 12, 20, 264, 272])
def test_kernel_for_raises_outside_the_domain(dtype, d):
    with pytest.raises(ValueError, match="head dim"):
        fa.kernel_for(dtype, d)


def test_kernel_for_raises_on_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.kernel_for(torch.float16, 64)


@pytest.mark.parametrize("d", [8, 40, 136, 256])
def test_wrapper_layout_args_take_any_domain_head_dim(d):
    """The forward's argument tuple (shared by both forward kernels) on
    fused-QKV views at head dims the old kernels refused."""
    b, t, h = 2, 5, 3
    c = h * d
    qkv = torch.zeros((b, t, 3 * c))
    q, k, v = (x.reshape(b, t, h, d).transpose(1, 2)
               for x in torch.split(qkv, c, dim=-1))
    o = torch.empty((b, t, h, d)).transpose(1, 2)
    lse = torch.empty((b, h, t))
    args = fa.wgmma_args(q, k, v, o, lse, True, 0.5)
    assert args[5:10] == (b, h, t, t, d)
    assert args[10:13] == (t * 3 * c, d, 3 * c)          # q's (b, h, t)
    assert args[19:22] == (t * c, d, c)                  # o's


# ---------------------------------------------------------- TF32 split
def test_tf32_round_clears_the_low_13_bits_within_half_a_tf32_ulp():
    x = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    x *= np.float32(2.0) ** np.random.default_rng(1).integers(-20, 20, 10000)
    r = fa.tf32_round(x)
    assert r.dtype == np.float32
    assert not (r.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(r.astype(np.float64) - x) <= 2.0 ** -11 * np.abs(x)).all()


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_tf32_round_breaks_ties_away_from_zero(sign):
    one = np.float32(sign)
    ulp = 2.0 ** -10                           # TF32's spacing at 1
    tie = np.float32(sign * (1 + ulp / 2))     # halfway: rounds away
    below = np.float32(sign * (1 + ulp / 2 - 2.0 ** -23))
    got = fa.tf32_round(np.array([tie, below, one], np.float32))
    assert got[0] == np.float32(sign * (1 + ulp))
    assert got[1] == one and got[2] == one
    assert np.isinf(fa.tf32_round(np.array([sign * np.inf], np.float32)))[0]


def test_tf32_split_parts_are_tf32_and_sum_to_x():
    x = np.random.default_rng(2).standard_normal(10000).astype(np.float32)
    big, small = fa.tf32_split(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(big.astype(np.float64) + small - x)
    assert (err <= 2.0 ** -22 * np.abs(x)).all()
    # one part alone is TF32's rounding: 2^-11, far above the split's
    assert np.abs(big.astype(np.float64) - x).max() > 2.0 ** -14


def test_split_matmul_is_near_f32_where_one_tf32_product_is_not():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 256), dtype=np.float32)
    b = rng.standard_normal((256, 48), dtype=np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)

    def rel(x):
        return np.linalg.norm(x - exact) / np.linalg.norm(exact)

    tf32_alone = (fa.tf32_round(a).astype(np.float64)
                  @ fa.tf32_round(b).astype(np.float64))
    assert rel(fa.split_matmul(a, b)) <= 4e-7 < 1e-4 <= rel(tf32_alone)


# Emulated attention against JAX: BWD_CASES' f32 shapes scaled down (the
# (16, 256, 256, 64) table case, the gpu tests' fused (1, 4, 200, 64) and
# non-causal (20, 130, 48) ones), in f32 with 16-row Pallas blocks
SPLIT_CASES = [(2, 128, 128, 64, True), (1, 77, 77, 64, True),
               (3, 20, 130, 48, False)]


def _split_case(bh, t_q, t_k, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, t_q, d), dtype=np.float32)
    k, v = (rng.standard_normal((bh, t_k, d), dtype=np.float32)
            for _ in range(2))
    return q, k, v, rng.standard_normal((bh, t_q, d), dtype=np.float32)


@pytest.mark.parametrize("bh,t_q,t_k,d,causal", SPLIT_CASES)
def test_split_forward_meets_the_f32_k1_row_against_jax(bh, t_q, t_k, d,
                                                        causal):
    q, k, v, _g = _split_case(bh, t_q, t_k, d, bh * 100 + t_q + d)
    o_j, lse_j = _fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             1.0 / math.sqrt(d), causal, 16, 16,
                             interpret=True)
    o, lse = fa.flash_attention_split_emulation(q, k, v, causal)
    assert o.dtype == np.float32 and lse.shape == (bh, t_q)
    np.testing.assert_allclose(o, np.asarray(o_j), atol=5e-5)
    np.testing.assert_allclose(lse, np.asarray(lse_j), atol=1e-3)


# ---------------------------------------------- the model at new head dims
def _model_pair(hd, dtype, seed=0):
    kw = dict(vocab_size=61, n_layers=2, n_heads=2, d_model=2 * hd,
              max_len=32)
    tcfg = ttr.TransformerConfig(**kw, fused_qkv=True, dtype=dtype)
    jcfg = jtr.TransformerConfig(**kw, fused_qkv=True,
                                 dtype=getattr(jnp, dtype))
    tree = init_jax_layout(tcfg, seed)
    return (jtr.TransformerLM(jcfg), jax.tree.map(jnp.asarray, tree),
            ttr.TransformerLM(tcfg, device="cpu"),
            from_jax_params(tree, tcfg, "cpu"))


def _toks(b, t, seed):
    toks = np.random.default_rng(seed).integers(0, 61, (b, t)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _on_flash_path(fn):
    try:
        jtr.FLASH_ATTENTION = True
        return fn()
    finally:
        jtr.FLASH_ATTENTION = None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [40, 256])
def test_model_prefill_matches_jax_at_new_head_dims(hd, dtype):
    jm, jp, tm, tp = _model_pair(hd, dtype)
    toks, _t = _toks(2, 24, hd)
    f32 = dtype == "float32"
    jl, jkv = (jax.jit(jm.prefill)(jp, jnp.asarray(toks)) if f32 else
               _on_flash_path(lambda: jax.jit(jm.prefill)(
                   jp, jnp.asarray(toks))))
    tl, tkv = tm.prefill(tp, torch.from_numpy(toks))
    atol = 1e-4 if f32 else 5e-2
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol)
    for name in ("k", "v"):
        assert tkv[name].shape == (2, 2, 24, 2, hd)
        np.testing.assert_allclose(
            tkv[name].float().numpy(),
            np.asarray(jkv[name].astype(jnp.float32)), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [40, 256])
def test_model_loss_grads_match_jax_at_new_head_dims(hd, dtype):
    jm, jp, tm, tp = _model_pair(hd, dtype)
    toks, tgts = _toks(2, 24, hd + 1)
    f32 = dtype == "float32"

    def jax_grad():
        return jax.jit(jax.value_and_grad(jm.loss_fn))(
            jp, jnp.asarray(toks), jnp.asarray(tgts))

    jl, jg = jax_grad() if f32 else _on_flash_path(jax_grad)
    tl, tg = tm.loss_and_grads(tp, torch.from_numpy(toks),
                               torch.from_numpy(tgts))
    assert abs(float(tl) - float(jl)) <= (1e-5 if f32 else 2e-2)
    mine = dict((jax.tree_util.keystr(p), a) for p, a in
                jax.tree_util.tree_leaves_with_path(
                    to_jax_params(tg, tm.config)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        j = np.asarray(leaf, np.float32)
        t = np.asarray(mine[jax.tree_util.keystr(path)], np.float32)
        if f32:
            np.testing.assert_allclose(t, j, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
        else:
            rel = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
            assert rel <= 5e-2, (jax.tree_util.keystr(path), rel)
