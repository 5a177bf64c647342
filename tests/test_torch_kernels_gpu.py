"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without CUDA every test here skips. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch and the CUDA toolkit::

    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py -k "one_key_tile or one_tile"
    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py -k bwd_wgmma_one_tile
    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest`` because the suite's conftest sets up JAX.) Tolerances as
in PERF.md: bf16 ``o`` atol 2e-2, f32 ``o`` atol 5e-5, ``lse`` atol 1e-3;
the backward's are stated with its tests below. The wgmma kernels (forward
and backward) take bf16 at d 64 and 128; the simple forward and the
``mma.sync`` backward f32 and the other head dims.
"""
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import flash_attention as fa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")


def _held_to_reference(q, k, v, causal, out=None):
    """Run the wrapper once, count which kernel launched, and hold o and
    lse against the plain version."""
    fa.launches_wgmma = fa.launches_simple = 0
    o, lse = fa.flash_attention_fwd(q, k, v, causal, out=out)
    torch.cuda.synchronize()
    wgmma = fa.takes_wgmma(q.dtype, q.shape[-1])
    assert (fa.launches_wgmma, fa.launches_simple) == (
        (1, 0) if wgmma else (0, 1))
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal)
    atol = 2e-2 if q.dtype == torch.bfloat16 else 5e-5
    assert (o.float() - o_ref.float()).abs().max().item() <= atol
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    return o


def _rand(shape, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_one_key_tile(cuda, causal):
    """T equal to one 128-row key tile: the accumulator and A-fragment
    layouts, the descriptors and one pass of the ring, before anything
    larger."""
    q, k, v = (_rand((2, 128, 64), i, torch.bfloat16) for i in range(3))
    _held_to_reference(q, k, v, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,causal,t_q,t_k,d", [
    (torch.bfloat16, True, 1000, 1000, 64),
    (torch.bfloat16, False, 128, 77, 64),
    (torch.bfloat16, True, 33, 33, 16),
    (torch.bfloat16, False, 64, 200, 128),
    (torch.float32, True, 77, 77, 64),
    (torch.float32, False, 20, 130, 48),
    # block edges and the model's ragged apply length, both paths
    (torch.bfloat16, True, 1, 1, 64),
    (torch.bfloat16, True, 127, 127, 64),
    (torch.bfloat16, True, 129, 129, 64),
    (torch.bfloat16, True, 991, 991, 64),
    (torch.bfloat16, True, 129, 129, 128),
    # d 128 has a 3-stage ring: 8 key tiles wrap it twice
    (torch.bfloat16, True, 1000, 1000, 128),
    (torch.bfloat16, False, 300, 1000, 128),
    (torch.bfloat16, False, 300, 1000, 64),
    (torch.bfloat16, True, 129, 129, 80),
    (torch.float32, True, 129, 129, 128),
    (torch.float32, True, 1, 1, 64)])
def test_flash_kernel_matches_reference(cuda, dtype, causal, t_q, t_k, d):
    q = _rand((4, t_q, d), t_q * 1000 + t_k, dtype)
    k, v = (_rand((4, t_k, d), t_q * 1000 + t_k + i, dtype)
            for i in (1, 2))
    _held_to_reference(q, k, v, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,hd,dtype", [
    (1, 16, 1024, 64, torch.bfloat16),    # the model's prefill at 1024
    (4, 16, 128, 64, torch.bfloat16),     # the batch bucket
    (2, 8, 300, 128, torch.bfloat16),
    (2, 4, 100, 32, torch.bfloat16),      # simple path, copied in and out
    (1, 4, 200, 64, torch.float32)])
def test_flash_kernel_on_fused_qkv_views(cuda, b, h, t, hd, dtype):
    """The strided (B, H, T, hd) views of one fused projection, and o
    written into the (B, H, T, hd) view of a (B, T, H, hd) buffer, as
    ``TransformerLM._attn`` calls it."""
    c = h * hd
    qkv = _rand((b, t, 3 * c), b * t + hd, dtype)
    q, k, v = (x.reshape(b, t, h, hd).transpose(1, 2)
               for x in torch.split(qkv, c, dim=-1))
    o = torch.full((b, t, h, hd), float("nan"), device="cuda", dtype=dtype)
    got = _held_to_reference(q, k, v, True, out=o.transpose(1, 2))
    assert got.data_ptr() == o.data_ptr() and not o.isnan().any()


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 32, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q[..., :40], q[..., :40], q[..., :40])
    with pytest.raises(ValueError, match="unit stride"):
        t = torch.zeros((2, 32, 128), device="cuda",
                        dtype=torch.bfloat16)[..., ::2]
        fa.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="16 bytes"):
        t = torch.zeros((2, 32, 68), device="cuda",
                        dtype=torch.bfloat16)[..., :64]
        fa.flash_attention_fwd(t, t, t)


# ------------------------------------------------------------- backward
# K2 against its plain version on the kernel's own forward (o, lse): each of
# dq, dk, dv within 1e-2 (bf16) or 1e-5 (f32) times the larger of 1 and the
# plain version's largest magnitude (PERF.md: the outputs round to bf16 after
# sums taken in another order, up to an ulp at the largest entries; where
# the gradient cancels to ~0, as at T 1, the floor of 1 keeps the bound
# absolute); and each 64-row tile along T within a relative L2 error of
# 1e-3 (bf16) or 5e-7 (f32), its norm floored at an rms of 1e-3 or 1e-6, so
# that the small gradients of late keys and queries are held as tightly as
# the first rows' large ones.
def _max_tile_rel_l2(x, ref, rms_floor, rows=64):
    worst = 0.0
    for a, b in zip(x.float().split(rows, dim=-2),
                    ref.float().split(rows, dim=-2)):
        den = max(b.norm().item(), rms_floor * b.numel() ** 0.5)
        worst = max(worst, (a - b).norm().item() / den)
    return worst


def _bwd_held_to_reference(q, k, v, causal, do, out=None):
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    _o, lse_plain = fa.flash_attention_reference(q, k, v, causal)
    # the forward's lse is the natural-log lse that exp(s - lse) needs
    assert (lse - lse_plain).abs().max().item() <= 1e-3
    fa.launches_bwd = fa.launches_bwd_wgmma = 0
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, out=out)
    torch.cuda.synchronize()
    wgmma = fa.takes_wgmma_bwd(q.dtype, q.shape[-1])
    assert (fa.launches_bwd_wgmma, fa.launches_bwd) == (
        (1, 0) if wgmma else (0, 1))
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    bf16 = q.dtype == torch.bfloat16
    tol, tile_tol, floor = (1e-2, 1e-3, 1e-3) if bf16 else (1e-5, 5e-7, 1e-6)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        scale = max(r.float().abs().max().item(), 1.0)
        assert (g.float() - r.float()).abs().max().item() <= tol * scale
        assert _max_tile_rel_l2(g, r, floor) <= tile_tol
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_wgmma_one_tile(cuda, causal):
    """The wgmma backward on one 64-row query tile against one 64-row key
    tile (one block of each kernel, one pass of each ring, half of each
    block's own rows past T): the SS and RS descriptors, the accumulator
    and A-fragment layouts, the lse and D stages and the stores, before
    anything larger."""
    q, k, v, do = (_rand((2, 64, 64), 20 + i, torch.bfloat16)
                   for i in range(4))
    _bwd_held_to_reference(q, k, v, causal, do)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_one_tile(cuda, causal):
    """The ``mma.sync`` backward (bf16 at d 32) on one 64-row query tile
    against one 64-row key tile: the mma fragments, the transposed products
    and the stores, before anything larger."""
    q, k, v, do = (_rand((2, 64, 32), 20 + i, torch.bfloat16)
                   for i in range(4))
    _bwd_held_to_reference(q, k, v, causal, do)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,causal,t_q,t_k,d", [
    (torch.bfloat16, True, 1024, 1024, 64),
    (torch.bfloat16, True, 991, 991, 64),
    (torch.bfloat16, True, 1, 1, 64),
    (torch.bfloat16, True, 127, 127, 64),
    (torch.bfloat16, True, 129, 129, 128),
    (torch.bfloat16, False, 300, 77, 64),
    (torch.bfloat16, True, 77, 200, 64),    # keys past every query row
    (torch.bfloat16, True, 77, 300, 128),
    # d 128: 16 query tiles and 16 key tiles wrap each 3-stage ring 5 times
    (torch.bfloat16, True, 1000, 1000, 128),
    (torch.bfloat16, False, 1000, 1000, 128),
    (torch.bfloat16, False, 130, 1000, 64),
    (torch.bfloat16, True, 200, 200, 32),
    (torch.bfloat16, True, 129, 129, 80),
    (torch.float32, True, 256, 256, 64),
    (torch.float32, False, 20, 130, 48)])
def test_bwd_kernel_matches_reference(cuda, dtype, causal, t_q, t_k, d):
    seed = t_q * 1000 + t_k + d
    q, do = (_rand((3, t_q, d), seed + i, dtype) for i in (0, 3))
    k, v = (_rand((3, t_k, d), seed + i, dtype) for i in (1, 2))
    _bwd_held_to_reference(q, k, v, causal, do)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,hd,dtype", [
    (2, 16, 1024, 64, torch.bfloat16),     # the training layer, two rows
    (2, 8, 300, 128, torch.bfloat16),
    (2, 4, 100, 32, torch.bfloat16),
    (1, 4, 200, 64, torch.float32)])
def test_bwd_kernel_on_fused_qkv_views(cuda, b, h, t, hd, dtype):
    """q, k, v the views of one fused projection, dO the (B, H, T, hd) view
    of a (B, T, C) gradient, and dq, dk, dv written into the views of one
    (B, T, 3C) gradient buffer, as ``fa.FlashAttention`` calls it."""
    c = h * hd
    qkv = _rand((b, t, 3 * c), b * t + hd, dtype)
    q, k, v = (x.reshape(b, t, h, hd).transpose(1, 2)
               for x in torch.split(qkv, c, dim=-1))
    do = _rand((b, t, c), hd, dtype).view(b, t, h, hd).transpose(1, 2)
    dqkv = torch.full_like(qkv, float("nan"))
    views = tuple(x.reshape(b, t, h, hd).transpose(1, 2)
                  for x in torch.split(dqkv, c, dim=-1))
    got = _bwd_held_to_reference(q, k, v, True, do, out=views)
    assert all(g is w for g, w in zip(got, views))
    assert not dqkv.isnan().any()


@pytest.mark.gpu
def test_autograd_function_launches_both_kernels(cuda):
    """The model's layer (fused QKV, bf16, d 64) goes through the wgmma
    forward and the wgmma backward, and neither of the other two."""
    b, t, h, hd = 2, 256, 16, 64
    x = _rand((b, t, 3 * h * hd), 5, torch.bfloat16).requires_grad_()
    fa.launches_wgmma = fa.launches_simple = 0
    fa.launches_bwd = fa.launches_bwd_wgmma = 0
    o = fa.FlashAttention.apply(h, True, hd ** -0.5, x)
    (g,) = torch.autograd.grad(o, x, torch.ones_like(o))
    torch.cuda.synchronize()
    assert (fa.launches_wgmma, fa.launches_bwd_wgmma) == (1, 1)
    assert (fa.launches_simple, fa.launches_bwd) == (0, 0)
    assert g.shape == x.shape and g.isfinite().all()


@pytest.mark.gpu
def test_wgmma_kernels_launch_from_a_thread_that_has_no_context(cuda):
    """Autograd runs a backward on a thread of its own; before anything
    else touches CUDA there, no context is current on it, and the wgmma
    kernels' tensor maps must still be encoded (both bind the context)."""
    import threading
    q, k, v, do = (_rand((2, 128, 64), 40 + i, torch.bfloat16)
                   for i in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(fa.flash_attention_fwd(q, k, v, True))
            got.append(fa.flash_attention_bwd(q, k, v, o, lse, do, True))
            torch.cuda.synchronize()
        except Exception as e:      # re-raised on the test's thread
            errors.append(e)

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert not errors, errors
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    for g, r in zip(got[1], ref):
        assert (g.float() - r.float()).abs().max().item() <= 1e-2 * max(
            1.0, r.float().abs().max().item())


# ------------------------------------------------------------- LM head
@pytest.mark.gpu
def test_tied_head_matches_f32_autograd(cuda):
    """``_TiedHead`` at the training layer (bench large config, batch 8:
    x (8, 1024, 1024), e (32768, 1024), bf16) against autograd through
    ``torch.matmul(x.float(), e.float().T)`` on the same inputs, with the
    cross-entropy gradient of random targets as dlogits. Relative L2
    error: logits ≤ 5e-6 (bf16 products are exact in f32; only the order
    of the f32 sums differs), dx and de ≤ 5e-3 (dlogits and both gradients
    round to bf16), each about 5× and 3× the readings in PERF.md: far
    under the error of a wrong transpose, scale or dropped gradient."""
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.models.transformer import _TiedHead
    resolve_device()
    b, t, c, vocab = 8, 1024, 1024, 32768
    x = _rand((b, t, c), 11, torch.bfloat16)
    e = (0.02 * _rand((vocab, c), 12, torch.float32)).bfloat16()
    xr, er = (a.float().requires_grad_() for a in (x, e))
    ref = torch.matmul(xr, er.T)
    g = torch.Generator(device="cuda").manual_seed(13)
    targets = torch.randint(0, vocab, (b * t,), generator=g, device="cuda")
    with torch.no_grad():
        dlogits = torch.softmax(ref, -1)
        dlogits.view(b * t, vocab)[torch.arange(b * t, device="cuda"),
                                   targets] -= 1.0
        dlogits /= b * t
    dx_ref, de_ref = torch.autograd.grad(ref, (xr, er), dlogits)
    xk, ek = (a.detach().requires_grad_() for a in (x, e))
    logits = _TiedHead.apply(xk, ek)
    dx, de = torch.autograd.grad(logits, (xk, ek), dlogits)
    assert logits.dtype == torch.float32 and logits.shape == (b, t, vocab)
    assert dx.dtype == de.dtype == torch.bfloat16

    def rel(got, want):
        return ((got.float() - want).norm() / want.norm()).item()

    assert rel(logits, ref.detach()) <= 5e-6
    assert rel(dx, dx_ref) <= 5e-3
    assert rel(de, de_ref) <= 5e-3
