"""The port's flash-attention forward against the JAX package's.

On the CPU the port's ``flash_attention`` takes its plain version
(``flash_attention_reference``); it is held here against the JAX Pallas
kernel run in interpret mode (as ``tests/test_kernels_native.py`` runs
it) and against ``naive_attention``. Tolerances: f32 atol 1e-5 (the two
sides differ only in the order of f32 sums); bf16 atol 2e-2 (both sides
take bf16 operands with f32 accumulation, but round P to bf16 at
different points: the kernel with the running max, the plain version
with the final one).

The CUDA kernel itself runs only on the card:
``tests/test_torch_kernels_gpu.py`` holds it against this plain version
there.
"""
import math

import numpy as np
import pytest

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
    fa.launches = 0
    fa.flash_attention(q, k, v, causal=True)
    fa.flash_attention_fwd(q[0], k[0], v[0])
    assert fa.launches == 0


def test_non_cpu_non_cuda_tensor_raises():
    """Only a CPU tensor takes the plain version; any other device must
    reach the kernel or raise — never fall back."""
    q = torch.empty((1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, q, q)
