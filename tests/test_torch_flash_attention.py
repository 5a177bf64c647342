"""The port's flash attention, forward and backward, against the JAX
package's (the backward's tolerances are stated with its tests below).

On the CPU the port's ``flash_attention`` takes its plain version
(``flash_attention_reference``); it is held here against the JAX Pallas
kernel run in interpret mode (as ``tests/test_kernels_native.py`` runs
it) and against ``naive_attention``. Tolerances: f32 atol 1e-5 (the two
sides differ only in the order of f32 sums); bf16 atol 2e-2 (both sides
take bf16 operands with f32 accumulation, but round P to bf16 at
different points: the kernel with the running max, the plain version
with the final one).

The CUDA kernels themselves run only on the card:
``tests/test_torch_kernels_gpu.py`` holds them against this plain version
there. What the CPU does reach is tested here too: which kernel a dtype
and head dim go to, and the wgmma kernel's layout rules and launch
arguments on the fused-QKV views the model hands it.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.kernels.flash_attention import (_fwd_pallas,
                                                        flash_attention,
                                                        naive_attention)
from deeplearning4j_tpu_torch.kernels import flash_attention as fa

F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _inputs(shape_q, t_k=None, seed=0):
    rng = np.random.default_rng(seed)
    shape_k = shape_q[:-2] + ((t_k or shape_q[-2]), shape_q[-1])
    return (rng.standard_normal(shape_q, dtype=np.float32),
            rng.standard_normal(shape_k, dtype=np.float32),
            rng.standard_normal(shape_k, dtype=np.float32))


def _jax_kernel(q, k, v, causal, block=16):
    """(o, lse) of the JAX Pallas kernel in interpret mode."""
    d = q.shape[-1]
    o, lse = _fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         1.0 / math.sqrt(d), causal, block, block,
                         interpret=True)
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [64, 50])
def test_reference_matches_jax_kernel_f32(causal, t):
    """3-D (BH, T, d), full and ragged T with 16-row blocks: o and lse
    against the Pallas kernel, o against naive attention."""
    q, k, v = _inputs((3, t, 16), seed=t)
    o, lse = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal)
    o_jax, lse_jax = _jax_kernel(q, k, v, causal)
    o_naive = naive_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), o_jax, atol=F32_ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_naive), atol=F32_ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_jax, atol=F32_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_public_wrapper_4d_matches_jax(causal):
    """(B, H, T, d) through the public wrapper, which flattens the
    leading dims exactly as the JAX ``flash_attention`` does."""
    q, k, v = _inputs((2, 3, 40, 32), seed=7)
    o = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal)
    o_jax = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, block_q=16, block_k=16)
    assert o.shape == (2, 3, 40, 32)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_jax), atol=F32_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_bf16_matches_jax_kernel(causal):
    q, k, v = _inputs((2, 50, 16), seed=3)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o_jax, lse_jax = _jax_kernel(jq, jk, jv, causal)
    np.testing.assert_allclose(o.float().numpy(), o_jax, atol=BF16_ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_jax, atol=BF16_ATOL)


def test_cpu_path_does_not_count_launches():
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 2, 16, 16)))
    fa.launches_wgmma = fa.launches_simple = 0
    fa.flash_attention(q, k, v, causal=True)
    fa.flash_attention_fwd(q[0], k[0], v[0])
    fa.flash_attention_fwd(*(t.to(torch.bfloat16) for t in (q, k, v)))
    assert fa.launches_wgmma == 0 and fa.launches_simple == 0


def test_non_cpu_non_cuda_tensor_raises():
    """Only a CPU tensor takes the plain version; any other device must
    reach the kernel or raise — never fall back."""
    q = torch.empty((1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, q, q)


def test_cpu_out_receives_o_and_lse_has_q_shape():
    q, k, v = (torch.from_numpy(a) for a in _inputs((2, 3, 24, 32), seed=5))
    out = torch.full((2, 24, 3, 32), float("nan")).transpose(1, 2)
    o, lse = fa.flash_attention_fwd(q, k, v, True, out=out)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, True)
    assert o is out and lse.shape == (2, 3, 24)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    np.testing.assert_array_equal(lse.numpy(), ref_lse.numpy())


@pytest.mark.parametrize("dtype,d,wgmma", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 16, False), (torch.bfloat16, 80, False),
    (torch.bfloat16, 112, False), (torch.float32, 64, False),
    (torch.float32, 128, False)])
def test_dispatch_by_dtype_and_head_dim(dtype, d, wgmma):
    assert (fa.kernel_for(dtype, d) == "wgmma") is wgmma


def _fused_qkv_views(b=2, t=5, h=2, hd=64, dtype=torch.bfloat16):
    """q, k, v as ``TransformerLM._attn`` hands them over: (B, H, T, hd)
    views of one (B, T, 3C) projection, and the (B, H, T, hd) view of the
    (B, T, H, hd) output buffer."""
    c = h * hd
    qkv = torch.zeros((b, t, 3 * c), dtype=dtype)
    q, k, v = (x.reshape(b, t, h, hd).transpose(1, 2)
               for x in torch.split(qkv, c, dim=-1))
    o = torch.empty((b, t, h, hd), dtype=dtype)
    return qkv, q, k, v, o


@pytest.mark.parametrize("hd", [64, 128])
def test_wgmma_layout_takes_fused_qkv_views_and_args(hd):
    b, t, h = 2, 5, 2
    c = h * hd
    qkv, q, k, v, o = _fused_qkv_views(b, t, h, hd)
    out = o.transpose(1, 2)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        assert not x.is_contiguous()
        assert fa.tma_operand(name, x)[0] == x.data_ptr()
    lse = torch.empty((b, h, t), dtype=torch.float32)
    args = fa.wgmma_args(q, k, v, out, lse, True, 0.125)
    base, item = qkv.data_ptr(), qkv.element_size()
    assert args[:5] == (base, base + c * item, base + 2 * c * item,
                        o.data_ptr(), lse.data_ptr())
    assert args[5:10] == (b, h, t, t, hd)
    qkv_strides = (t * 3 * c, hd, 3 * c)           # (b, h, t) in elements
    assert args[10:19] == qkv_strides * 3
    assert args[19:22] == (t * c, hd, c)
    assert args[22:] == (0.125, 1)


def test_wgmma_args_of_3d_operands_have_one_head():
    q = torch.zeros((6, 33, 64), dtype=torch.bfloat16)
    assert fa.tma_operand("q", q) == (q.data_ptr(), 33 * 64, 33 * 64, 64)
    args = fa.wgmma_args(q, q, q, q, torch.empty((6, 33)), False, 1.0)
    assert args[5:10] == (6, 1, 33, 33, 64)
    assert args[10:13] == (33 * 64, 33 * 64, 64)
    assert args[-1] == 0


@pytest.mark.parametrize("bad,match", [
    ("d_strided", "unit stride"),
    ("misaligned", "16-byte boundary"),
    ("row_stride", "multiples of 16 bytes"),
])
def test_wgmma_layout_rejects_what_tma_cannot_read(bad, match):
    if bad == "d_strided":          # every other column of a d=128 tensor
        x = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16)[..., ::2]
    elif bad == "misaligned":       # starts one element into its storage
        x = torch.zeros((1, 2, 8, 65), dtype=torch.bfloat16)[..., 1:]
    else:                           # rows 136 bytes apart
        x = torch.zeros((1, 2, 8, 68), dtype=torch.bfloat16)[..., :64]
    assert x.shape[-1] == 64
    with pytest.raises(ValueError, match=match):
        fa.tma_operand("q", x)
    ok = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        fa.wgmma_args(ok, ok, x, ok, torch.empty((1, 2, 8)), True, 1.0)


# ------------------------------------------------------------- backward
# Plain K2 against the JAX ``_bwd_blockwise`` on identical (q, k, v, o, lse,
# dO) from the JAX forward: f32 atol 1e-5 (f32 sums in another order), bf16
# atol 2e-2 (bf16 products exact in f32 on both sides, but dq/dk/dv are
# rounded to bf16 after sums taken in another order: half an ulp at |g| ~ 2-4
# is 8e-3).
def _jax_bwd(q, k, v, do, causal, block=16, scale=None):
    from deeplearning4j_tpu.kernels.flash_attention import _bwd_blockwise
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = _fwd_pallas(jq, jk, jv, scale, causal, block, block,
                         interpret=True)
    grads = _bwd_blockwise(jq, jk, jv, o, lse, jdo, scale, causal, block)
    return o, lse, [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("causal,t_q,t_k,block", [
    (True, 64, 64, 16), (False, 64, 64, 16),
    (True, 50, 50, 16),              # ragged T, a ragged last key block
    (False, 40, 23, 8),              # Tq != Tk, several small key blocks
    (True, 30, 70, 32),              # causal Tq < Tk: keys nobody sees
    (False, 9, 9, 64)])              # one block longer than T
def test_bwd_reference_matches_jax_blockwise_f32(causal, t_q, t_k, block):
    q, k, v = _inputs((3, t_q, 16), t_k, seed=t_q + t_k)
    do = np.random.default_rng(9).standard_normal(q.shape, dtype=np.float32)
    o, lse, want = _jax_bwd(q, k, v, do, causal, block)
    got = fa.flash_attention_bwd_reference(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)),
        causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=F32_ATOL)
    if causal and t_k > t_q:
        assert not got[1][:, t_q:].any() and not got[2][:, t_q:].any()


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_reference_matches_jax_blockwise_bf16(causal):
    q, k, v = (a.astype(jnp.bfloat16) for a in _inputs((2, 50, 32), seed=8))
    do = np.random.default_rng(10).standard_normal(
        q.shape, dtype=np.float32).astype(jnp.bfloat16)
    o, lse, want = _jax_bwd(q, k, v, do, causal)
    to_t = (lambda a: torch.from_numpy(np.array(a, np.float32))
            .to(torch.bfloat16))
    got = fa.flash_attention_bwd_reference(
        to_t(q), to_t(k), to_t(v), to_t(o),
        torch.from_numpy(np.array(lse)), to_t(do), causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=BF16_ATOL)


@pytest.mark.parametrize("causal,fused", [(True, True), (False, True),
                                          (True, False)])
def test_autograd_function_matches_jax_vjp(causal, fused):
    """``fa.FlashAttention`` over the model's (B, T, ·) projections, the
    gradient landing in one buffer shaped like each input, against
    ``jax.vjp`` of the JAX ``flash_attention`` (Pallas interpret mode)."""
    b, t, h, hd = 2, 37, 2, 16
    c = h * hd
    rng = np.random.default_rng(11)
    qkv = rng.standard_normal((b, t, 3 * c), dtype=np.float32)
    g_o = rng.standard_normal((b, t, c), dtype=np.float32)

    def heads(a):                                   # (B, T, C) → (B, H, T, hd)
        return a.reshape(b, t, h, hd).transpose(0, 2, 1, 3)

    jq, jk, jv = (heads(jnp.asarray(a)) for a in np.split(qkv, 3, -1))
    o_j, vjp = jax.vjp(lambda q, k, v: flash_attention(
        q, k, v, causal=causal, block_q=16, block_k=16), jq, jk, jv)
    want = [np.asarray(g.transpose(0, 2, 1, 3).reshape(b, t, c))
            for g in vjp(heads(jnp.asarray(g_o)))]
    want_o = np.asarray(o_j.transpose(0, 2, 1, 3).reshape(b, t, c))

    x = torch.from_numpy(qkv)
    xs = ((x.clone().requires_grad_(),) if fused else
          tuple(a.clone().requires_grad_() for a in torch.split(x, c, -1)))
    o = fa.FlashAttention.apply(h, causal, 1.0 / math.sqrt(hd), *xs)
    assert o.shape == (b, t, c)
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=F32_ATOL)
    o.backward(torch.from_numpy(g_o))
    got = (torch.split(xs[0].grad, c, -1) if fused
           else [a.grad for a in xs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=F32_ATOL)


def test_bwd_wrapper_cpu_writes_out_views_and_counts_nothing():
    b, t, h, hd = 2, 20, 2, 32
    qkv, q, k, v, _o = _fused_qkv_views(b, t, h, hd, torch.float32)
    qkv.normal_(generator=torch.Generator().manual_seed(0))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(1))
    dqkv = torch.full_like(qkv, float("nan"))
    views = tuple(x.reshape(b, t, h, hd).transpose(1, 2)
                  for x in torch.split(dqkv, h * hd, dim=-1))
    fa.launches_bwd = 0
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True, out=views)
    assert fa.launches_bwd == 0
    assert all(g is w for g, w in zip(got, views))
    assert not dqkv.isnan().any()
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_bwd_args_on_fused_views_read_the_gradient_buffer_in_place():
    """The launch arguments the card path builds for the model's backward:
    q/k/v and dq/dk/dv are the three column blocks of one (B, T, 3C)
    tensor each, dO the (B, H, T, hd) view of a (B, T, C) gradient."""
    b, t, h, hd = 2, 5, 2, 64
    c = h * hd
    qkv, q, k, v, o = _fused_qkv_views(b, t, h, hd)
    dqkv, dq, dk, dv, g = _fused_qkv_views(b, t, h, hd)
    o4, do4 = o.transpose(1, 2), g.transpose(1, 2)
    lse = torch.empty((b, h, t))
    delta = torch.empty((b, h, t))
    args, strides = fa.bwd_args(q, k, v, o4, lse, do4, dq, dk, dv, delta)
    item = 2
    base, gbase = qkv.data_ptr(), dqkv.data_ptr()
    assert args[:10] == (base, base + c * item, base + 2 * c * item,
                         o.data_ptr(), g.data_ptr(), lse.data_ptr(),
                         gbase, gbase + c * item, gbase + 2 * c * item,
                         delta.data_ptr())
    assert args[10:] == (b, h, t, t, hd)
    fused, plain = (t * 3 * c, hd, 3 * c), (t * c, hd, c)
    assert strides == list(fused * 3 + plain * 2 + fused * 3)


def test_bwd_args_reject_an_output_the_kernel_cannot_write():
    ok = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    bad = torch.zeros((1, 2, 8, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="flash_attention_bwd: dk strides"):
        fa.bwd_args(ok, ok, ok, ok, torch.empty((1, 2, 8)), ok, ok, bad, ok,
                    torch.empty((1, 2, 8)))


# ------------------------------------------------- the wgmma backward's route
@pytest.mark.parametrize("dtype,d,wgmma", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 32, False), (torch.bfloat16, 80, False),
    (torch.float32, 64, False), (torch.float32, 128, False)])
def test_bwd_dispatch_by_dtype_and_head_dim(dtype, d, wgmma):
    """bf16 at d 64 and 128 (the model's layer) takes the wgmma backward;
    every other pair the forwards take goes to the mma.sync / f32 one
    (one rule, ``fa.kernel_for``, routes both directions)."""
    assert (fa.kernel_for(dtype, d) == "wgmma") is wgmma


@pytest.mark.parametrize("b_h,t_q,want", [(1, 1, 2 * 64), (3, 64, 6 * 64),
                                           (2, 65, 4 * 128),
                                           (128, 1024, 256 * 1024)])
def test_bwd_scratch_is_d_and_lse_padded_to_query_tiles(b_h, t_q, want):
    assert fa.bwd_scratch_numel(b_h, t_q) == want


@pytest.mark.parametrize("hd", [64, 128])
def test_bwd_wgmma_args_on_fused_views_and_one_gradient_buffer(hd):
    """The model's backward: q, k, v the column blocks of one (B, T, 3C)
    projection, o and dO the (B, H, T, hd) views of (B, T, C) buffers, and
    dq, dk, dv the column blocks of one (B, T, 3C) gradient, all passed by
    pointer and stride as they are."""
    b, t, h = 2, 5, 3
    c = h * hd
    qkv, q, k, v, o = _fused_qkv_views(b, t, h, hd)
    dqkv, dq, dk, dv, g = _fused_qkv_views(b, t, h, hd)
    o4, do4 = o.transpose(1, 2), g.transpose(1, 2)
    lse = torch.empty((b, h, t))
    scratch = torch.empty(fa.bwd_scratch_numel(b * h, t))
    args, strides = fa.bwd_wgmma_args(q, k, v, o4, lse, do4, dq, dk, dv,
                                      scratch)
    item = 2
    base, gbase = qkv.data_ptr(), dqkv.data_ptr()
    assert args[:10] == (base, base + c * item, base + 2 * c * item,
                         o.data_ptr(), g.data_ptr(), lse.data_ptr(),
                         gbase, gbase + c * item, gbase + 2 * c * item,
                         scratch.data_ptr())
    assert args[10:] == (b, h, t, t, hd)
    fused, plain = (t * 3 * c, hd, 3 * c), (t * c, hd, c)
    assert strides == list(fused * 3 + plain * 2 + fused * 3)
    for x in (q, k, v, o4, do4, dq, dk, dv):
        assert not x.is_contiguous()


def test_bwd_wgmma_args_of_3d_operands_have_one_head():
    q = torch.zeros((6, 33, 64), dtype=torch.bfloat16)
    grads = [torch.empty_like(q) for _ in range(3)]
    scratch = torch.empty(fa.bwd_scratch_numel(6, 33))
    args, strides = fa.bwd_wgmma_args(q, q, q, q, torch.empty((6, 33)), q,
                                      *grads, scratch)
    assert args[9] == scratch.data_ptr()
    assert args[10:] == (6, 1, 33, 33, 64)
    assert strides == [33 * 64, 33 * 64, 64] * 8


@pytest.mark.parametrize("bad,match", [
    ("row_stride", "flash_attention_bwd: do strides"),
    ("misaligned", "flash_attention_bwd: v does not start"),
    ("dtype", "takes bf16 at head dim 64 or 128"),
    ("head_dim", "takes bf16 at head dim 64 or 128"),
    ("scratch", "scratch needs 256 f32"),
])
def test_bwd_wgmma_args_reject_what_the_kernel_cannot_take(bad, match):
    ok = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    ops = dict(q=ok, k=ok, v=ok, o=ok, do=ok, dq=ok, dk=ok, dv=ok)
    scratch = torch.empty(fa.bwd_scratch_numel(2, 8))
    if bad == "row_stride":         # rows 136 bytes apart
        ops["do"] = torch.zeros((1, 2, 8, 68), dtype=torch.bfloat16)[..., :64]
    elif bad == "misaligned":       # starts one element into its storage
        ops["v"] = torch.zeros((1, 2, 8, 65), dtype=torch.bfloat16)[..., 1:]
    elif bad == "dtype":
        ops = {n: x.float() for n, x in ops.items()}
    elif bad == "head_dim":
        ops = {n: x[..., :32] for n, x in ops.items()}
    else:
        scratch = scratch[:-1]
    with pytest.raises(ValueError, match=match):
        fa.bwd_wgmma_args(ops["q"], ops["k"], ops["v"], ops["o"],
                          torch.empty((1, 2, 8)), ops["do"], ops["dq"],
                          ops["dk"], ops["dv"], scratch)


def test_bwd_cpu_path_counts_no_launch_of_either_backward():
    """On the CPU both backwards' counters stay put: the plain version is
    no launch."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs((1, 2, 16, 64)))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    fa.launches_bwd = fa.launches_bwd_wgmma = 0
    got = fa.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o), True)
    assert (fa.launches_bwd, fa.launches_bwd_wgmma) == (0, 0)
    assert all(g.dtype == torch.bfloat16 for g in got)
