"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without CUDA every test here skips. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch and the CUDA toolkit::

    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py -k one_key_tile   # first, alone
    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest`` because the suite's conftest sets up JAX.) Tolerances as
in PERF.md: bf16 ``o`` atol 2e-2, f32 ``o`` atol 5e-5, ``lse`` atol 1e-3.
The wgmma kernel takes bf16 at d 64 and 128; the simple kernel f32 and the
other head dims.
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
