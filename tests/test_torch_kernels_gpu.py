"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without CUDA every test here skips. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch and the CUDA toolkit::

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest`` because the suite's conftest sets up JAX.) Tolerances as
in PERF.md: bf16 ``o`` atol 2e-2, f32 ``o`` atol 5e-5, ``lse`` atol 1e-3.
"""
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import flash_attention as fa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,causal,t_q,t_k,d", [
    (torch.bfloat16, True, 1000, 1000, 64),
    (torch.bfloat16, False, 128, 77, 64),
    (torch.bfloat16, True, 33, 33, 16),
    (torch.bfloat16, False, 64, 200, 128),
    (torch.float32, True, 77, 77, 64),
    (torch.float32, False, 20, 130, 48)])
def test_flash_kernel_matches_reference(cuda, dtype, causal, t_q, t_k, d):
    g = torch.Generator(device="cuda").manual_seed(t_q * 1000 + t_k)
    q = torch.randn((4, t_q, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((4, t_k, d), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    fa.launches = 0
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == 1
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal)
    atol = 2e-2 if dtype == torch.bfloat16 else 5e-5
    assert (o.float() - o_ref.float()).abs().max().item() <= atol
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 32, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q[..., :40], q[..., :40], q[..., :40])
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(0, 1)
        fa.flash_attention_fwd(t, t, t)
