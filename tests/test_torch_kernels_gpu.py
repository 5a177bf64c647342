"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without CUDA every test here skips. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch and the CUDA toolkit::

    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py -k "one_key_tile or one_tile"
    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py -k simple_one_tile
    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py -k bwd_wgmma_one_tile
    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py -k ce_wgmma_one_tile
    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py -k ce_tf32_one_tile
    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py -k k4a_one_tile
    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest`` because the suite's conftest sets up JAX.) Tolerances as
in PERF.md: bf16 ``o`` atol 2e-2, f32 ``o`` atol 5e-5, ``lse`` atol 1e-3;
the backward's are stated with its tests below. The wgmma kernels (forward
and backward) take bf16 at d 64 and 128; the simple forward and the
``mma.sync`` / FMA backward f32 and the other head dims, every d % 8 == 0
in [8, 256].
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
    wgmma = fa.kernel_for(q.dtype, q.shape[-1]) == "wgmma"
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_simple_one_tile(cuda, dtype, causal):
    """The simple forward on one 64-row query tile against one 64-row key
    tile, f32 (the three-product split) and bf16 at d 32: the fragment
    layouts, the key renumbering of P V and the stores, before anything
    larger."""
    q, k, v = (_rand((2, 64, 32 if dtype == torch.bfloat16 else 64), 60 + i,
                     dtype) for i in range(3))
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
    (torch.float32, True, 1, 1, 64),
    # head dims past the old 16-128: 8, 40 (d % 16 == 8 in bf16), 136 and
    # 256 (tile widths 192 and 256, shorter key tiles)
    (torch.float32, True, 130, 130, 8),
    (torch.bfloat16, True, 130, 130, 8),
    (torch.float32, False, 77, 200, 40),
    (torch.bfloat16, True, 200, 200, 40),
    (torch.float32, True, 150, 150, 136),
    (torch.float32, True, 300, 300, 256),
    (torch.bfloat16, False, 100, 300, 256)])
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
    (2, 4, 100, 32, torch.bfloat16),      # the simple kernel, bf16
    (1, 4, 200, 64, torch.float32),
    (1, 16, 1024, 64, torch.float32),     # the f32 model's prefill
    (8, 16, 1024, 64, torch.float32),     # the f32 training layer
    (2, 3, 90, 40, torch.bfloat16),
    (1, 2, 120, 256, torch.float32)])
def test_flash_kernel_on_fused_qkv_views(cuda, b, h, t, hd, dtype):
    """The strided (B, H, T, hd) views of one fused projection, and o
    written into the (B, H, T, hd) view of a (B, T, H, hd) buffer, as
    ``TransformerLM._attn`` calls it: both kernels read and write the views
    in place, so the wrapper allocates nothing beside lse."""
    c = h * hd
    qkv = _rand((b, t, 3 * c), b * t + hd, dtype)
    q, k, v = (x.reshape(b, t, h, hd).transpose(1, 2)
               for x in torch.split(qkv, c, dim=-1))
    o = torch.full((b, t, h, hd), float("nan"), device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fa.flash_attention_fwd(q, k, v, True, out=o.transpose(1, 2))
    torch.cuda.synchronize()
    # the call's peak is lse alone, (B, H, T) f32 in 512-byte blocks: no
    # copy of q, k, v or o
    lse_bytes = -(-4 * b * h * t // 512) * 512
    assert torch.cuda.max_memory_allocated() - before <= lse_bytes
    got = _held_to_reference(q, k, v, True, out=o.transpose(1, 2))
    assert got.data_ptr() == o.data_ptr() and not o.isnan().any()


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 32, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q[..., :36], q[..., :36], q[..., :36])
    wide = torch.zeros((2, 32, 264), device="cuda", dtype=torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="unit stride"):
        t = torch.zeros((2, 32, 128), device="cuda",
                        dtype=torch.bfloat16)[..., ::2]
        fa.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="16 bytes"):
        t = torch.zeros((2, 32, 68), device="cuda",
                        dtype=torch.bfloat16)[..., :64]
        fa.flash_attention_fwd(t, t, t)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64),
                                      (torch.bfloat16, 40)])
def test_simple_kernel_copies_views_it_cannot_read(cuda, dtype, hd):
    """The simple kernel takes views outside tma_operand's rule through
    contiguous copies, as the backward does: a non-unit stride on d, an
    expanded (zero) stride, a start off 16 bytes, and an ``out`` of a
    non-unit stride on d, which receives o. The backward takes the same
    views."""
    q = _rand((2, 3, 70, 2 * hd), 11, dtype)[..., ::2]
    k = _rand((2, 1, 90, hd), 12, dtype).expand(2, 3, 90, hd)
    v = _rand((2 * 3 * 90 * hd + 1,), 13, dtype)[1:].view(2, 3, 90, hd)
    assert all(fa._layout_error(t) is not None for t in (q, k, v))
    o = torch.full((2, 3, 70, 2 * hd), float("nan"), device="cuda",
                   dtype=dtype)
    got = _held_to_reference(q, k, v, True, out=o[..., ::2])
    assert not o[..., ::2].isnan().any() and o[..., 1::2].isnan().all()
    assert (got.float() - o[..., ::2].float()).abs().max().item() == 0
    do = _rand((2, 3, 70, 2 * hd), 14, dtype)[..., 1::2]
    _bwd_held_to_reference(q, k, v, True, do)


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
    wgmma = fa.kernel_for(q.dtype, q.shape[-1]) == "wgmma"
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
@pytest.mark.parametrize("causal", [True, False])
def test_bwd_f32_one_tile(cuda, causal):
    """The f32 backward (FMA on the CUDA cores, each sum in the plain
    version's order) on one 32-row query tile against one key tile, before
    anything larger."""
    q, k, v, do = (_rand((2, 32, 64), 30 + i, torch.float32)
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
    (torch.float32, False, 20, 130, 48),
    # head dims past the old 16-128; from tile width 192 (f32 from 128) the
    # dK/dV block splits into a dV and a dK group
    (torch.float32, True, 130, 130, 8),
    (torch.bfloat16, True, 130, 130, 8),
    (torch.float32, True, 200, 200, 40),
    (torch.bfloat16, False, 77, 200, 40),
    (torch.float32, True, 150, 150, 136),
    (torch.float32, True, 300, 300, 256),
    (torch.bfloat16, True, 300, 300, 256),
    (torch.float32, False, 300, 77, 256),
    (torch.float32, True, 1024, 1024, 64)])
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
    (1, 4, 200, 64, torch.float32),
    (8, 16, 1024, 64, torch.float32),     # the f32 training layer
    (2, 3, 90, 40, torch.bfloat16),
    (1, 2, 120, 256, torch.float32)])
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
def test_autograd_function_in_f32_launches_the_simple_pair(cuda):
    """The f32 model's layer (fused QKV, d 64) goes through the simple
    forward and the mma.sync / FMA backward, never a wgmma kernel, and its
    gradient matches the plain versions' within the K2 rows."""
    b, t, h, hd = 2, 200, 4, 64
    x = _rand((b, t, 3 * h * hd), 6, torch.float32).requires_grad_()
    fa.launches_wgmma = fa.launches_simple = 0
    fa.launches_bwd = fa.launches_bwd_wgmma = 0
    o = fa.FlashAttention.apply(h, True, hd ** -0.5, x)
    g_o = _rand(o.shape, 7, torch.float32)
    (g,) = torch.autograd.grad(o, x, g_o)
    torch.cuda.synchronize()
    assert (fa.launches_simple, fa.launches_bwd) == (1, 1)
    assert (fa.launches_wgmma, fa.launches_bwd_wgmma) == (0, 0)
    q, k, v = (a.reshape(b, t, h, hd).transpose(1, 2)
               for a in torch.split(x.detach(), h * hd, -1))
    o_ref, lse = fa.flash_attention_reference(q, k, v, True)
    assert (o.detach().view(b, t, h, hd).transpose(1, 2) - o_ref).abs() \
        .max().item() <= 5e-5
    ref = fa.flash_attention_bwd_reference(
        q, k, v, o.detach().view(b, t, h, hd).transpose(1, 2), lse,
        g_o.view(b, t, h, hd).transpose(1, 2), True)
    for got, want in zip(torch.split(g, h * hd, -1), ref):
        want = want.transpose(1, 2).reshape(b, t, h * hd)
        assert (got - want).abs().max().item() <= 1e-5 * max(
            1.0, want.abs().max().item())


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


# ------------------------------------------------ K3: chunked cross-entropy
# K3f against its plain version: lse and the loss within 1e-4 (both take
# f32 logits from the same operands and sum in another order; the kernel's
# expf against torch's exp). K3b's dlogits, (p − onehot)·g/N in x's dtype:
# the entries off the target within a relative L2 error of 5e-3 (bf16: one
# rounding of each) or 1e-5 (f32), the target entries within 2^-7 (bf16) or
# 1e-5 (f32) of g/N. The two are held apart because the target entries
# (≈ −g/N each) would hide a wrong softmax (≈ g/(N·V) each) in any norm
# over all entries (``chip_smoke.dlogits_errors``).
def _ce_inputs(n, v, d, dtype, seed):
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    x = _rand((n, d), seed, dtype)
    e = (0.5 * _rand((v, d), seed + 1, torch.float32) / d ** 0.5).to(dtype)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    t = torch.randint(0, v, (n,), generator=g, device="cuda")
    t[: min(n, 4)] = torch.tensor([0, v - 1, v // 2, 127], device="cuda")[
        : min(n, 4)].clamp(max=v - 1)
    return ce, x, e, t


def _ce_counts(ce):
    return (ce.launches_fwd, ce.launches_dlogits, ce.launches_fwd_wgmma,
            ce.launches_dlogits_wgmma, ce.launches_fwd_tf32,
            ce.launches_dlogits_tf32, ce.launches_split_tf32)


def _ce_reset(ce):
    ce.launches_fwd = ce.launches_dlogits = 0
    ce.launches_fwd_wgmma = ce.launches_dlogits_wgmma = 0
    ce.launches_fwd_tf32 = ce.launches_dlogits_tf32 = 0
    ce.launches_split_tf32 = 0


def _ce_want(path, k3f, k3b, splits=None):
    """_ce_counts after ``k3f`` K3f and ``k3b`` K3b launches on ``path``
    (each tf32 call without parts splits first)."""
    at = {"mma_sync": (0, 1), "wgmma": (2, 3), "tf32": (4, 5)}[path]
    want = [0] * 7
    want[at[0]], want[at[1]] = k3f, k3b
    if path == "tf32":
        want[6] = k3f + k3b if splits is None else splits
    return tuple(want)


def _ce_held_to_reference(n, v, d, dtype, seed=0, n_chunks=2, kernel=None,
                          edges=False):
    """K3f and every chunk's K3b once, on the kernel the wrappers choose
    (or ``kernel``), each held to its plain version; asserts which kernel
    launched. ``edges``: targets also on the 256-column tile edges and on
    the chunk edges."""
    import chip_smoke
    ce, x, e, t = _ce_inputs(n, v, d, dtype, seed)
    c = v // n_chunks
    if edges and n > 4:
        at = torch.tensor([255, 256, c - 1, c, 2 * c - 1, 511, 512, v - 2],
                          device="cuda").clamp(max=v - 1)
        k = min(n, 4 + at.numel())
        t[4:k] = at[: k - 4]
    path = kernel or ce.kernel_for("cuda", dtype, d, True)
    _ce_reset(ce)
    lse, loss = ce.chunked_ce_fwd(x, e, t, n_chunks, kernel=kernel)
    torch.cuda.synchronize()
    assert _ce_counts(ce) == _ce_want(path, 1, 0)
    lse_ref, cor = ce.chunked_ce_fwd_reference(x, e, t, n_chunks)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    assert abs(loss.item() - (lse_ref - cor).mean().item()) <= 1e-4
    g = torch.tensor(2.5, device="cuda")
    for i in range(n_chunks):
        got = ce.ce_dlogits(x, e[i * c:(i + 1) * c], t, lse_ref, i * c, g, n,
                            kernel=kernel)
        ref = ce.ce_dlogits_reference(x, e[i * c:(i + 1) * c], t, lse_ref,
                                      i * c, g, n)
        assert got.dtype == x.dtype and got.shape == (n, c)
        local = torch.where((t >= i * c) & (t < (i + 1) * c), t - i * c, -1)
        rel, at = chip_smoke.dlogits_errors(got, ref, local, 2.5 / n)
        bf16 = dtype == torch.bfloat16
        assert rel <= (5e-3 if bf16 else 1e-5), (i, rel)
        assert at <= (2 ** -7 if bf16 else 1e-5), (i, at)
    torch.cuda.synchronize()
    assert _ce_counts(ce) == _ce_want(path, 1, n_chunks)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 32)])
def test_ce_one_tile(cuda, dtype, d):
    """chunked_ce.cu's K3f and K3b on one 128-row tile against one
    128-column vocab tile (one block each, one split), before anything
    larger; bf16 at d 64 is forced onto it (the wrappers choose wgmma)."""
    _ce_held_to_reference(128, 256, d, dtype, n_chunks=2,
                          kernel="mma_sync")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_ce_wgmma_one_tile(cuda, d):
    """The wgmma K3f and K3b on one 128 × 256 block tile (one block, one
    split, one K3b tile; one and two panels of d): the accumulator layout,
    the descriptors, one pass of the ring, the staging swizzle and the TMA
    store, before anything larger."""
    _ce_held_to_reference(128, 256, d, torch.bfloat16, n_chunks=1)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64])
def test_ce_tf32_one_tile(cuda, d):
    """The tf32 K3f and K3b on one 128 × 256 block tile (one block, one
    split, one K3b tile; one and two 32-column panels of d), after the
    split pass: the TF32 descriptors, one pass of the ring, the epilogue's
    stores, before anything larger."""
    _ce_held_to_reference(128, 256, d, torch.float32, n_chunks=1)


@pytest.mark.gpu
@pytest.mark.parametrize("n,v,d,n_chunks", [
    (8192, 32768, 1024, 8),    # the f32 training layer (batch 8)
    (1000, 5000, 1024, 4),     # ragged rows, vocab and chunks (C 1250)
    (1, 384, 256, 3),          # one row at d 256; chunks of 128
    (129, 520, 48, 2),         # d not a multiple of 32: a padded panel
    (1000, 5000, 96, 4),       # three panels at ragged rows and vocab
    (300, 2304, 80, 9),        # more ring stages than panels a tile
])
def test_ce_tf32_matches_reference(cuda, n, v, d, n_chunks):
    """The tf32 kernels at the training shape and at ragged ones, with
    targets on 256-column tile edges and on chunk edges (every chunk past
    the first starts at col0 > 0)."""
    _ce_held_to_reference(n, v, d, torch.float32, seed=n + v + d,
                          n_chunks=n_chunks, edges=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n,v,d,ld", [(8192, 32768, 1024, 1024),
                                      (257, 640, 48, 52)])
def test_split_tf32_matches_plain(cuda, n, v, d, ld):
    """The split pass against split_tf32_reference, bit for bit, for
    rows ``ld`` apart (a column view of a wider buffer past d)."""
    from deeplearning4j_tpu_torch.kernels import chunked_ce as ce
    x = _rand((n, ld), 5, torch.float32)[:, :d]
    e = _rand((v, ld), 6, torch.float32)[:, :d]
    _ce_reset(ce)
    got = ce.split_tf32(x, e)
    torch.cuda.synchronize()
    assert ce.launches_split_tf32 == 1
    want = ce.split_tf32_reference(x) + ce.split_tf32_reference(e)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n,v,d,n_chunks", [
    (8192, 32768, 1024, 8),    # the training layer (batch 8)
    (4096, 32768, 1024, 8),    # batch 4
    (1000, 5000, 1024, 4),     # ragged rows, vocab and chunks (C 1250)
    (1, 384, 64, 3),           # one row; chunks of 128, half a tile
    (129, 520, 192, 2),        # a row past a tile; chunks of 260
    (300, 2304, 64, 9),        # more ring stages than panels a tile
])
def test_ce_wgmma_matches_reference(cuda, n, v, d, n_chunks):
    """The wgmma kernels at chip_smoke's CE cases and at ragged ones, with
    targets on 256-column tile edges and on chunk edges."""
    _ce_held_to_reference(n, v, d, torch.bfloat16, seed=n + v + d,
                          n_chunks=n_chunks, edges=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n,v,d,dtype,n_chunks", [
    (300, 1000, 64, torch.bfloat16, 4),      # ragged rows and vocab
    (1, 384, 32, torch.bfloat16, 3),
    (1024, 8192, 1024, torch.bfloat16, 8),   # the training width
    (2048, 4096, 256, torch.bfloat16, 2),    # many splits of few tiles
    (257, 640, 48, torch.float32, 5),
    (129, 130, 16, torch.float32, 2)])
def test_ce_kernels_match_reference(cuda, n, v, d, dtype, n_chunks):
    _ce_held_to_reference(n, v, d, dtype, seed=n + v, n_chunks=n_chunks)


@pytest.mark.gpu
def test_chunked_softmax_xent_on_the_card_matches_plain(cuda, monkeypatch):
    """The autograd function (K3f, then K3b and the two products per
    chunk) against the same function with the plain versions swapped in:
    the loss within 1e-4, dx and dE by relative L2 within 5e-3 (bf16)."""
    _autograd_vs_plain(monkeypatch, torch.bfloat16, 5e-3)


@pytest.mark.gpu
def test_chunked_softmax_xent_f32_on_the_card_matches_plain(cuda,
                                                            monkeypatch):
    """The same in f32 on the tf32 kernels: one split pass for the
    forward and one before the backward's chunks, whose K3b read row views
    of E's parts; dx and dE by relative L2 within the f32 K3b row (1e-5)."""
    _autograd_vs_plain(monkeypatch, torch.float32, 1e-5)


def _autograd_vs_plain(monkeypatch, dtype, tol):
    ce, x, e, t = _ce_inputs(512, 2048, 128, dtype, 9)
    path = ce.kernel_for("cuda", dtype, 128, True)
    xs, es = (a.detach().requires_grad_() for a in (x, e))
    _ce_reset(ce)
    loss = ce.chunked_softmax_xent(xs.view(2, 256, 128), es, t.view(2, 256),
                                   4)
    dx, de = torch.autograd.grad(loss, (xs, es))
    assert _ce_counts(ce) == _ce_want(path, 1, 4, splits=2)
    monkeypatch.setattr(ce, "chunked_ce_fwd", lambda x2, emb, tg, k: (
        lambda lc: (lc[0], (lc[0] - lc[1]).mean()))(
            ce.chunked_ce_fwd_reference(x2, emb, tg, k)))
    monkeypatch.setattr(ce, "ce_dlogits", lambda *a, parts=None, **k:
                        ce.ce_dlogits_reference(*a, **k))
    monkeypatch.setattr(ce, "split_tf32", lambda x2, emb: None)
    _ce_reset(ce)
    xs2, es2 = (a.detach().requires_grad_() for a in (x, e))
    ref = ce.chunked_softmax_xent(xs2.view(2, 256, 128), es2,
                                  t.view(2, 256), 4)
    dx_ref, de_ref = torch.autograd.grad(ref, (xs2, es2))
    assert _ce_counts(ce) == (0,) * 7
    assert abs(loss.item() - ref.item()) <= 1e-4
    for a, b in ((dx, dx_ref), (de, de_ref)):
        assert a.dtype == dtype
        assert ((a.float() - b.float()).norm() / b.float().norm()).item() \
            <= tol


@pytest.mark.gpu
def test_ce_kernels_reject_what_they_do_not_take(cuda):
    ce, x, e, t = _ce_inputs(64, 256, 64, torch.bfloat16, 3)
    with pytest.raises(ValueError, match="multiple"):
        ce.chunked_ce_fwd(x[:, :40].contiguous(), e[:, :40].contiguous(),
                          t, 2)
    with pytest.raises(ValueError, match="int64"):
        ce.chunked_ce_fwd(x, e, t.int(), 2)
    with pytest.raises(TypeError, match="bfloat16"):
        ce.chunked_ce_fwd(x, e.float(), t, 2)
    with pytest.raises(ValueError, match="stride"):
        ce.ce_dlogits(x[:, ::2], e[:, ::2], t, torch.zeros(64,
                      device="cuda"), 0, torch.ones((), device="cuda"), 64)
    # a start off the 16-byte grid: neither kernel's loads can take it
    xs = torch.empty(64 * 64 + 1, device="cuda",
                     dtype=torch.bfloat16)[1:].view(64, 64)
    with pytest.raises(ValueError, match="aligned"):
        ce.chunked_ce_fwd(xs, e, t, 2)
    # the wgmma kernel is bf16 at d % 64 == 0 only
    with pytest.raises(ValueError, match="wgmma"):
        ce.chunked_ce_fwd(x.float(), e.float(), t, 2, kernel="wgmma")
    with pytest.raises(ValueError, match="wgmma"):
        ce.chunked_ce_fwd(x[:, :32].contiguous(), e[:, :32].contiguous(), t,
                          2, kernel="wgmma")
    ce.launches_fwd = ce.launches_fwd_wgmma = 0
    ce.chunked_ce_fwd(x[:, :32].contiguous(), e[:, :32].contiguous(), t, 2)
    torch.cuda.synchronize()
    assert (ce.launches_fwd, ce.launches_fwd_wgmma) == (1, 0)
    # the tf32 kernel is f32 only, and its parts must be split_tf32's
    with pytest.raises(ValueError, match="tf32"):
        ce.chunked_ce_fwd(x, e, t, 2, kernel="tf32")
    xf, ef = x.float(), e.float()
    xb, xs_, eb, es = ce.split_tf32(xf, ef)
    with pytest.raises(ValueError, match="parts"):
        ce.ce_dlogits(xf, ef[:128], t, torch.zeros(64, device="cuda"), 0,
                      torch.ones((), device="cuda"), 64,
                      parts=(xb, xs_, eb, es))


# ---------------------------------------------- K7: MoE dispatch / combine
# Dispatch copies rows: exact. Its gradient mode: d_out = gate·dy rounded
# once, exact; d_gate a dot product in another order, 1e-2 (bf16) or 1e-5
# (f32) relative to the largest. Combine: f32 sums with fused multiply-adds
# against the plain version's rounded products, one bf16 ulp (2^-8
# relative to the largest output) or 1e-6 in f32.
def _route(G, E, C, K, seed):
    from deeplearning4j_tpu_torch.parallel import moe as tmoe
    g = torch.Generator(device="cuda").manual_seed(seed)
    probs = torch.softmax(torch.randn((G, E), generator=g, device="cuda"), -1)
    cfg = tmoe.MoEConfig(d_model=8, d_ff=8, num_experts=E, top_k=K)
    return tmoe.route(probs, cfg, C)


@pytest.mark.gpu
@pytest.mark.parametrize("G,E,C,K,d,dtype", [
    (8, 2, 4, 1, 64, torch.bfloat16),            # one block of each
    (8192, 8, 1280, 1, 1024, torch.bfloat16),    # the training width
    (1000, 8, 100, 2, 512, torch.bfloat16),      # top-2 with drops
    (300, 4, 100, 2, 96, torch.float32),
    (33, 3, 5, 1, 4, torch.float32)])
def test_moe_kernels_match_reference(cuda, G, E, C, K, d, dtype):
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    _c, gates, slot, src, _oh = _route(G, E, C, K, G + d)
    gates = gates.to(dtype).contiguous()
    x = _rand((G, d), 1, dtype)
    out_e = _rand((E * C, d), 2, dtype)
    dy = _rand((G, d), 3, dtype)
    mr.launches_dispatch = mr.launches_combine = 0
    ei = mr.moe_dispatch(x, src, K)
    y = mr.moe_combine(out_e, slot, gates)
    dx = mr.moe_combine(ei, slot)
    d_out, d_gates = mr.moe_dispatch_grad(dy, src, K, gates, out_e)
    torch.cuda.synchronize()
    assert (mr.launches_dispatch, mr.launches_combine) == (2, 2)
    assert torch.equal(ei, mr.dispatch_reference(x, src, K))
    ref_out, ref_gates = mr.dispatch_grad_reference(dy, src, K, gates, out_e)
    assert torch.equal(d_out, ref_out)
    bf16 = dtype == torch.bfloat16
    for got, ref, tol in ((y, mr.combine_reference(out_e, slot, gates),
                           2 ** -8 if bf16 else 1e-6),
                          (dx, mr.combine_reference(ei, slot),
                           2 ** -8 if bf16 else 1e-6),
                          (d_gates, ref_gates, 1e-2 if bf16 else 1e-5)):
        assert got.dtype == dtype and got.shape == ref.shape
        top = max(ref.float().abs().max().item(), 1e-30)
        assert (got.float() - ref.float()).abs().max().item() <= tol * top


@pytest.mark.gpu
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_on_the_card_matches_plain(cuda, monkeypatch, top_k):
    """``moe_ffn`` through K7 (forward and backward) against the same
    function with the plain versions swapped in, bf16: y exactly (the same
    products; combine's sums within one ulp), every gradient by relative
    L2 within 1e-2."""
    from deeplearning4j_tpu_torch.kernels import moe_route as mr
    from deeplearning4j_tpu_torch.parallel import moe as tmoe
    cfg = tmoe.MoEConfig(d_model=256, d_ff=512, num_experts=8, top_k=top_k)
    params = {k: v.bfloat16() for k, v in tmoe.init_moe_params(
        cfg, seed=4, scale=0.1).items()}
    x = _rand((4, 256, 256), 6, torch.bfloat16)

    def run():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        xs = x.detach().requires_grad_()
        y, aux = tmoe.moe_ffn(leaves, xs, cfg)
        grads = torch.autograd.grad((y.float().square().sum()
                                     + aux["aux_loss"].float()),
                                    [*leaves.values(), xs])
        return y, grads

    mr.launches_dispatch = mr.launches_combine = 0
    y, grads = run()
    assert (mr.launches_dispatch, mr.launches_combine) == (2, 2)
    for name in ("moe_dispatch", "moe_combine", "moe_dispatch_grad"):
        monkeypatch.setattr(mr, name, getattr(
            mr, name.replace("moe_", "") + "_reference"))
    y_ref, grads_ref = run()
    top = y_ref.float().abs().max().item()
    assert (y.float() - y_ref.float()).abs().max().item() <= 2 ** -8 * top
    for a, b in zip(grads, grads_ref):
        assert ((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item() <= 1e-2


# ------------------------------------------- K4: paged decode attention
# K4a against its plain version (the gather and the reference attention):
# bf16 o atol 2e-2 (as K1: the reference rounds the scores and P to bf16,
# the kernel keeps them in f32), f32 atol 5e-5 (f32 sums in another order).
# K4w bit-exact: the same f32 amax, product, IEEE division and rounding.
def _k4_inputs(B, W, H, hd, P, n_lp, dtype, quant, ctx, seed, trash=()):
    """q as the strided (B, W, H, hd) view of a fused projection, pools of
    B·n_lp pages + trash (int8 with scales under ``quant``), each slot's
    pages a random permutation, slots in ``trash`` all trash, and window
    positions ending at ``ctx[b] - 1``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = B * n_lp + 1
    proj = torch.randn((B, W, 3 * H * hd), generator=g, device="cuda")
    q = proj.to(dtype)[..., :H * hd].view(B, W, H, hd)
    rows = torch.randn((2, n_pages, P, H, hd), generator=g, device="cuda")
    if quant:
        from deeplearning4j_tpu_torch.kernels import paged_attention as pa
        k8, ks = pa.quantize_kv_rows_reference(rows[0])
        v8, vs = pa.quantize_kv_rows_reference(rows[1])
        pools = (k8, v8, ks, vs)
    else:
        rows = rows.to(dtype)
        pools = (rows[0], rows[1], None, None)
    perm = torch.randperm(B * n_lp, generator=g, device="cuda")
    tables = perm.view(B, n_lp).to(torch.int32)
    for b in trash:
        tables[b] = n_pages - 1
    pos = (torch.tensor(ctx, device="cuda")[:, None] - W
           + torch.arange(W, device="cuda")[None, :]).clamp_min(0)
    return q, pools, tables, pos


def _k4a_held_to_reference(q, pools, tables, pos):
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    k, v, ks, vs = pools
    pa.launches_attend = 0
    o = pa.paged_attention(q, k, v, tables, pos, ks, vs)
    torch.cuda.synchronize()
    assert pa.launches_attend == 1
    ref = pa.paged_attention_reference(q, k, v, tables, pos, ks, vs)
    assert o.shape == ref.shape and o.dtype == q.dtype
    atol = 2e-2 if q.dtype == torch.bfloat16 else 5e-5
    assert (o.float() - ref.float()).abs().max().item() <= atol
    return o


@pytest.mark.gpu
def test_k4a_one_tile(cuda):
    """One slot, one head, 64 keys, one split (no ticket merge): the lane
    chunks, the row reductions and the online softmax before anything
    larger."""
    _k4a_held_to_reference(*_k4_inputs(1, 1, 1, 64, 64, 1, torch.bfloat16,
                                       False, [64], 0))


@pytest.mark.gpu
@pytest.mark.parametrize("B,W,H,hd,P,n_lp,dtype,quant,ctx", [
    # the serving shapes: contexts 37, 500, 960 and 1024 of a 1024 span
    (1, 1, 16, 64, 64, 16, torch.bfloat16, False, [37]),
    (1, 1, 16, 64, 64, 16, torch.bfloat16, False, [1024]),
    (1, 5, 16, 64, 64, 16, torch.bfloat16, False, [500]),
    (8, 1, 16, 64, 64, 16, torch.bfloat16, False, [960] * 8),
    (8, 5, 16, 64, 64, 16, torch.bfloat16, True, [37, 500, 960, 1024] * 2),
    (1, 1, 16, 64, 64, 16, torch.bfloat16, True, [1024]),
    # edges: P 16 and P = S (the dense view), other head dims, f32
    (2, 3, 4, 64, 16, 9, torch.bfloat16, False, [100, 7]),
    (3, 1, 16, 64, 1024, 1, torch.bfloat16, False, [1, 600, 1024]),
    (2, 2, 2, 128, 32, 5, torch.bfloat16, True, [150, 33]),
    (2, 4, 3, 16, 8, 7, torch.bfloat16, False, [56, 3]),
    (1, 16, 2, 256, 64, 3, torch.bfloat16, False, [192]),
    (2, 3, 2, 8, 1, 70, torch.bfloat16, True, [70, 2]),
    (2, 5, 16, 64, 64, 16, torch.float32, False, [300, 1024]),
    (1, 2, 4, 40, 16, 4, torch.float32, True, [64]),
])
def test_k4a_matches_reference(cuda, B, W, H, hd, P, n_lp, dtype, quant,
                               ctx):
    _k4a_held_to_reference(*_k4_inputs(B, W, H, hd, P, n_lp, dtype, quant,
                                       ctx, B * 7 + W + hd))


@pytest.mark.gpu
def test_k4a_window_past_the_span_and_a_free_slot(cuda):
    """A window whose tail runs past S (its queries see every key) and a
    free slot whose table row is all trash: both as the plain version."""
    q, pools, tables, pos = _k4_inputs(3, 5, 16, 64, 64, 4, torch.bfloat16,
                                       True, [258, 40, 300], 3, trash=(1,))
    assert int(pos.max()) >= 256
    _k4a_held_to_reference(q, pools, tables, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("B,W,H,hd,P,n_lp,dtype,quant,ctx", [
    (1, 1, 16, 64, 64, 16, torch.bfloat16, False, [1024]),
    (1, 1, 16, 64, 64, 16, torch.bfloat16, True, [1024]),
    (8, 5, 16, 64, 64, 16, torch.bfloat16, False, [1024] * 8),
    (2, 5, 16, 64, 64, 16, torch.float32, False, [300, 1024]),
])
def test_k4a_gives_the_same_bits_eagerly_and_in_graph_replays(
        cuda, B, W, H, hd, P, n_lp, dtype, quant, ctx):
    """Two eager calls give bit-identical o, and so does each of 20
    launches captured in one CUDA graph over 3 replays: the last split's
    block merges in split order and leaves every ticket counter at 0."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, (k, v, ks, vs), tables, pos = _k4_inputs(
        B, W, H, hd, P, n_lp, dtype, quant, ctx, 11)

    def call():
        return pa.paged_attention(q, k, v, tables, pos, ks, vs)

    first = _k4a_held_to_reference(q, (k, v, ks, vs), tables, pos)
    assert torch.equal(first, call())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(20)]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(first, o) for o in outs)
    assert not pa._counters[q.device].any()


@pytest.mark.gpu
def test_k4a_many_splits_through_the_ticket_merge(cuda):
    """One slot, one head, 4096 keys in pages of 64: 64 splits, the last
    block to finish merging all of them; also forced to 1, 7 and 256
    splits."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, (k, v, ks, vs), tables, pos = _k4_inputs(
        1, 1, 1, 64, 64, 64, torch.bfloat16, False, [4096], 12)
    assert pa.attend_splits(q, k, v, tables)[0] == 64
    first = _k4a_held_to_reference(q, (k, v, ks, vs), tables, pos)
    ref = pa.paged_attention_reference(q, k, v, tables, pos)
    for splits in (1, 7, 256):
        o = pa.paged_attention(q, k, v, tables, pos, splits=splits)
        assert (o.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.equal(first, pa.paged_attention(q, k, v, tables, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_k4a_widest_window_at_hd_128(cuda, quant):
    """W 16 at hd 128, where each warp's q and o take the most registers
    (its queries split across two warps' worth)."""
    _k4a_held_to_reference(*_k4_inputs(1, 16, 8, 128, 64, 16,
                                       torch.bfloat16, quant, [1024], 13))


@pytest.mark.gpu
def test_k4a_rejects_what_it_does_not_take(cuda):
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, (k, v, _ks, _vs), tables, pos = _k4_inputs(
        1, 1, 2, 64, 16, 2, torch.bfloat16, False, [10], 1)
    with pytest.raises(ValueError, match="window"):
        wide = torch.zeros((1, 17, 2, 64), device="cuda",
                           dtype=torch.bfloat16)
        pa.paged_attention(wide, k, v, tables, pos.expand(1, 17))
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention(q[..., :60], k[..., :60], v[..., :60], tables,
                           pos)
    with pytest.raises(ValueError, match="pool"):
        pa.paged_attention(q, k.float(), v.float(), tables, pos)
    with pytest.raises(ValueError, match="scale"):
        pa.paged_attention(q, k.to(torch.int8), v.to(torch.int8), tables,
                           pos)
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), k, v, tables, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4w_is_bit_exact(cuda, dtype):
    """A decode window's rows (strided views of a fused projection, one of
    them all zero) through (page, row) coordinates, and a prefill's 20 rows
    into two whole pages of every layer with zero padding rows: pools and
    scales equal the plain version's to the bit."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    g = torch.Generator(device="cuda").manual_seed(5)
    H, hd, P = 16, 64, 16
    proj = torch.randn((3, 2, 3 * H * hd), generator=g, device="cuda")
    proj[1, 1] = 0.0
    proj = proj.to(dtype)
    k = proj[..., H * hd:2 * H * hd].view(3, 2, H, hd)
    v = proj[..., 2 * H * hd:].view(3, 2, H, hd)
    phys = torch.tensor([[2, 2], [0, 6], [6, 6]], dtype=torch.int32,
                        device="cuda")
    off = torch.tensor([[3, 4], [15, 0], [7, 8]], dtype=torch.int32,
                       device="cuda")

    def pools(layers=()):
        return [torch.zeros((*layers, 7, P, H, hd), dtype=torch.int8,
                            device="cuda") for _ in range(2)] + [
            torch.zeros((*layers, 7, P), device="cuda") for _ in range(2)]

    got, want = pools(), pools()
    pa.launches_quant_write = 0
    pa.kv_quant_write(k, v, phys, off, *got)
    pa.kv_quant_write_reference(k, v, phys, off, *want)
    torch.cuda.synchronize()
    assert pa.launches_quant_write == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2][6, 0] == 1.0                          # the zero row
    kv = torch.randn((2, 2, 1, 20, H, hd), generator=g,
                     device="cuda").to(dtype)
    t = torch.arange(2 * P, device="cuda")
    ids = torch.tensor([5, 1], device="cuda")
    got, want = pools((3,)), pools((3,))
    pa.kv_quant_write(kv[0, :, :], kv[1], ids[t // P][None], (t % P)[None],
                      *[x[1:] for x in got])
    pa.kv_quant_write_reference(kv[0], kv[1], ids[t // P][None],
                                (t % P)[None], *[x[1:] for x in want])
    torch.cuda.synchronize()
    assert pa.launches_quant_write == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[2][1:, 1, 4:] == 1.0).all() and (got[2][0] == 0).all()


# K4a+w (the store in K4a's launch) against the two-launch path (K4w for
# int8 pools, index_put_ otherwise, then K4a): o, pools and scales the same
# bits, the trash page aside (slots write it in no fixed order); against
# the plain version at K4a's tolerance. Inputs and the two-launch path are
# chip_smoke.py's (``k4aw_inputs``, ``two_launch_store``), cases laid out
# as its DECODE_CASES (a P = S case is the dense cache).
@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (1, 1, 1, 64, 64, 1, "bfloat16", "int8", (64,), ()),        # one tile
    (1, 1, 1, 64, 64, 1, "bfloat16", "same", (64,), ()),        # dense
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (1024,), ()),    # the step
    (1, 1, 16, 64, 64, 16, "bfloat16", "int8", (1024,), ()),
    (1, 1, 16, 64, 1024, 1, "bfloat16", "same", (1024,), ()),
    (1, 1, 16, 64, 64, 16, "bfloat16", "same", (37,), ()),
    (8, 5, 16, 64, 64, 16, "bfloat16", "int8", (37, 500, 960, 1024) * 2,
     ()),
    (8, 5, 16, 64, 64, 16, "bfloat16", "same", (37, 500, 960, 1024) * 2,
     ()),
    # a window crossing a page edge, one past S, and a free slot
    (3, 5, 16, 64, 64, 4, "bfloat16", "int8", (258, 66, 300), (2,)),
    (3, 5, 16, 64, 64, 4, "bfloat16", "same", (258, 66, 300), (2,)),
    (2, 5, 16, 64, 256, 1, "bfloat16", "same", (258, 66), ()),   # drops
    (2, 3, 4, 128, 16, 9, "float32", "same", (100, 7), ()),
    (2, 3, 4, 128, 16, 9, "float32", "int8", (100, 7), ()),
    (1, 16, 8, 128, 64, 16, "bfloat16", "int8", (1024,), ()),
])
def test_k4aw_matches_the_two_launch_path(cuda, case):
    import chip_smoke
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    B, trash = case[0], case[-1]
    q, k, v, pools, tables, pos, dst, dense = chip_smoke.k4aw_inputs(torch,
                                                                     case)
    fused, two, plain = ([None if x is None else x.clone() for x in pools]
                         for _ in range(3))
    pa.launches_attend = pa.launches_attend_write = 0
    pa.launches_quant_write = 0
    o = pa.paged_attention_write(q, k, v, fused[0], fused[1], tables, pos,
                                 dst, fused[2], fused[3])
    torch.cuda.synchronize()
    assert (pa.launches_attend, pa.launches_attend_write,
            pa.launches_quant_write) == (0, 1, 0)
    chip_smoke.two_launch_store(torch, k, v, two, dst)()
    o2 = pa.paged_attention(q, two[0], two[1], tables, pos, two[2], two[3])
    ref = pa.paged_attention_write_reference(q, k, v, plain[0], plain[1],
                                             tables, pos, dst, plain[2],
                                             plain[3])
    live = [b for b in range(B) if b not in trash]
    assert torch.equal(o[live], o2[live])
    atol = 2e-2 if q.dtype == torch.bfloat16 else 5e-5
    assert (o[live].float() - ref[live].float()).abs().max().item() <= atol
    keep = slice(None) if dense else slice(0, -1)       # the trash aside
    for a, b, c in zip(fused, two, plain):
        if a is not None:
            assert torch.equal(a[keep], b[keep])
            assert torch.equal(a[keep], c[keep])
    assert not torch.equal(fused[0][keep], pools[0][keep])   # it wrote
    if dense and int(pos.max()) >= fused[0].shape[1]:        # rows past S
        assert int((dst < 0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["int8", "same"])
def test_k4aw_gives_the_same_bits_in_graph_replays(cuda, pool):
    """The store writes the same rows every launch, so 20 launches captured
    in one CUDA graph give the eager o over 3 replays, and every ticket
    counter is back at 0."""
    import chip_smoke
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, k, v, (kp, vp, ks, vs), tables, pos, dst, _ = chip_smoke.k4aw_inputs(
        torch, (8, 5, 16, 64, 64, 16, "bfloat16", pool, (1024,) * 8, ()))

    def call():
        return pa.paged_attention_write(q, k, v, kp, vp, tables, pos, dst,
                                        ks, vs)

    first = call()
    assert torch.equal(first, call())
    outs = chip_smoke.graph_outputs(call, torch)
    assert len(outs) == 60 and all(torch.equal(first, o) for o in outs)
    assert not pa._counters[q.device].any()


@pytest.mark.gpu
def test_k4aw_rejects_rows_it_does_not_take(cuda):
    import chip_smoke
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    q, k, v, (kp, vp, _ks, _vs), tables, pos, dst, _ = chip_smoke.k4aw_inputs(
        torch, (1, 2, 4, 64, 16, 2, "bfloat16", "same", (10,), ()))
    with pytest.raises(ValueError, match="rows"):
        pa.paged_attention_write(q, k.float(), v, kp, vp, tables, pos, dst)
    with pytest.raises(ValueError, match="rows"):
        pa.paged_attention_write(q, k.transpose(2, 3), v, kp, vp, tables,
                                 pos, dst)
    with pytest.raises(ValueError, match="dst"):
        pa.paged_attention_write(q, k, v, kp, vp, tables, pos, dst[:, :1])


@pytest.mark.gpu
def test_k4w_insert_is_bit_exact_at_every_quant_case(cuda):
    """The warp-a-row K4w at every QUANT_CASES shape of ``chip_smoke.py``
    (decode windows and the bucket-1024 and bucket-32 prefill inserts of 12
    layers, each with an all-zero row), and a row of 2048 elements (read
    twice) and one whose pieces are not 16-byte aligned: pools and scales
    equal the plain version's to the bit."""
    import chip_smoke
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    for case in chip_smoke.QUANT_CASES:
        k, v, phys, off, pools = chip_smoke.quant_inputs(torch, case)
        got, want = pools(), pools()
        pa.kv_quant_write(k, v, phys, off, *got)
        pa.kv_quant_write_reference(k, v, phys, off, *want)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), case
    g = torch.Generator(device="cuda").manual_seed(3)
    for H, hd, lo in ((32, 64, 0), (4, 40, 1)):
        rows = torch.randn((2, 1, 6, H * hd + lo), generator=g,
                           device="cuda").to(torch.bfloat16)
        k = rows[0, ..., lo:].view(1, 6, H, hd)
        v = rows[1, ..., lo:].view(1, 6, H, hd)
        phys = torch.tensor([[0, 0, 1, 1, 2, 2]], dtype=torch.int32,
                            device="cuda")
        off = torch.tensor([[0, 3, 1, 2, 0, 3]], dtype=torch.int32,
                           device="cuda")
        got = [torch.zeros((3, 4, H, hd), dtype=torch.int8, device="cuda")
               for _ in range(2)] + [torch.zeros((3, 4), device="cuda")
                                     for _ in range(2)]
        want = [x.clone() for x in got]
        pa.kv_quant_write(k, v, phys, off, *got)
        pa.kv_quant_write_reference(k, v, phys, off, *want)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (H, hd, lo)


@pytest.mark.gpu
def test_k4w_is_bit_exact_over_every_bf16_value(cuda):
    """K4w divides by the row's scale on the IEEE division's fast path,
    its reciprocal computed once a row, where the scale lies in [2^-100,
    2^100], and by the division itself outside. Every finite bf16 value,
    at row maxima from 2^-120 to 2^120 (three mantissas each, and both
    edges of that window): rows of 1023 values of |x| <= the maximum and
    the maximum itself, through K4w and its plain version, give pools and
    scales equal to the bit; and f32 rows at log-uniform maxima."""
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa
    every = torch.arange(65536, dtype=torch.int32, device="cuda").to(
        torch.int16).view(torch.bfloat16).float()
    every = every[torch.isfinite(every)]
    maxima = [m * 2.0 ** e for e in list(range(-120, 121, 12))
              + [-94, -93, -92, 106, 107, 108]
              for m in (1.0, 1.5078125, 1.9921875)]
    rows = []
    for i, amax in enumerate(maxima):
        vals = every[every.abs() <= amax]
        pad = -vals.numel() % 1023
        vals = torch.cat([vals, vals.new_zeros(pad)]).view(-1, 1023)
        top = vals.new_full((vals.shape[0], 1), amax if i % 2 else -amax)
        rows.append(torch.cat([vals, top], dim=1))
    g = torch.Generator(device="cuda").manual_seed(9)
    f32 = torch.randn((1024, 1024), generator=g, device="cuda") * torch.exp2(
        torch.rand((1024, 1), generator=g, device="cuda") * 240 - 120)
    for x in (torch.cat(rows).to(torch.bfloat16), f32):
        R = x.shape[0]
        k, v = x.view(1, R, 16, 64), (-x).view(1, R, 16, 64)
        t = torch.arange(R, device="cuda", dtype=torch.int32)[None]
        n_pages = -(-R // 64)
        got = [torch.zeros((n_pages, 64, 16, 64), dtype=torch.int8,
                           device="cuda") for _ in range(2)] + [
            torch.zeros((n_pages, 64), device="cuda") for _ in range(2)]
        want = [a.clone() for a in got]
        pa.kv_quant_write(k, v, t // 64, t % 64, *got)
        pa.kv_quant_write_reference(k, v, t // 64, t % 64, *want)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (x.dtype, (a != b).sum().item())
