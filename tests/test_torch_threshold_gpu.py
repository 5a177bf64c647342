"""K6 (``kernels/csrc/threshold.cu``) against its plain versions, on the card.

Marked ``gpu``: without CUDA every test here skips. Imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch and the CUDA
toolkit::

    timeout 120 python -m pytest --noconftest -m gpu \\
        tests/test_torch_threshold_gpu.py -k k6_one_tile
    python -m pytest --noconftest -m gpu tests/test_torch_threshold_gpu.py

Rows (PERF.md): signs, counts, entries, n, sparse residuals and decodes
exact (bit for bit, a NaN where the plain version has one: the card's
arithmetic gives NaN its own payload); the scale terms and Σ residual'²
relative 1e-6; a second launch bit-identical.
"""
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import threshold as K

pytestmark = pytest.mark.gpu

TOL_SCALAR = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")


def _vals(n, seed, specials=False, scale=1e-3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * scale
    if specials and n >= 8:
        x[:8] = torch.tensor([float("nan"), float("inf"), float("-inf"),
                              -0.0, 0.0, 2e-3, -2e-3, 1e-3])
    return x.cuda()


def same(a, b):
    """Equal, bit for bit where not NaN, NaN where the other is NaN (the
    card's arithmetic gives its own NaN payload)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def check_dense(n, t, seed=0, specials=False, n_rep=1):
    g, r = _vals(n, seed, specials), _vals(n, seed + 1, scale=1e-4)
    thr = torch.tensor(t, dtype=torch.float32, device="cuda")
    before = (K.launches_encode, K.launches_decode)
    s, p = K.encode_dense(g, r, thr)
    s2, p2 = K.encode_dense(g, r, thr)
    s_ref, p_ref = K.encode_dense_reference(g, r, thr)
    assert torch.equal(s, s_ref) and torch.equal(s, s2)
    assert same(p, p2)
    assert p[1] == p_ref[1]
    assert _rel(p[2], p_ref[2]) <= TOL_SCALAR
    assert _rel(p[0], p_ref[0]) <= TOL_SCALAR or (
        p[0].isnan() and p_ref[0].isnan())
    wire = (s.to(torch.int32) * n_rep).clamp(-127, 127).to(torch.int8)
    packed = p * n_rep
    d, nr, q = K.decode_dense(g, r, s, wire, packed, n_rep)
    d_ref, nr_ref, q_ref = K.decode_dense_reference(g, r, s, wire, packed,
                                                    n_rep)
    assert same(d, d_ref) and same(nr, nr_ref)
    assert _rel(q, q_ref) <= TOL_SCALAR or (q.isnan() and q_ref.isnan())
    # in place over g and the residual: the same values
    g2, r2 = g.clone(), r.clone()
    K.decode_dense(g2, r2, s, wire, packed, n_rep, decoded=g2,
                   new_residual=r2)
    assert same(g2, d) and same(r2, nr)
    assert (K.launches_encode - before[0], K.launches_decode - before[1]) \
        == (2, 2)


def check_sparse(n, t, cap, seed=0, specials=False):
    x = _vals(n, seed, specials)
    e, res = K.threshold_encode(x, t, cap)
    e2, res2 = K.threshold_encode(x, t, cap)
    e_ref, res_ref = K.threshold_encode_reference(x, t, cap)
    assert torch.equal(e, e_ref) and torch.equal(e, e2)
    assert same(res, res_ref) and same(res, res2)
    d = K.threshold_decode(e, t, (n,))
    assert same(d, K.threshold_decode_reference(e, t, (n,)))
    signs = torch.where(x.abs() >= t, torch.sign(x),
                        torch.zeros((), device="cuda")).to(torch.int8)
    es = K.sparse_from_dense(signs, cap)
    assert torch.equal(es, K.sparse_from_dense_reference(signs, cap))
    assert torch.equal(K.dense_from_sparse(es, n),
                       K.dense_from_sparse_reference(es, n))


def test_k6_one_tile(cuda):
    check_dense(1000, 1e-3)
    check_sparse(1000, 1e-3, 2000)


@pytest.mark.parametrize("n", [1, 33, 4099, 2 ** 20 + 7])
@pytest.mark.parametrize("t", [1e-3, 0.0, 1.0])
def test_k6_dense_sizes(cuda, n, t):
    check_dense(n, t, seed=n)


@pytest.mark.parametrize("n", [33, 4099])
def test_k6_dense_specials(cuda, n):
    check_dense(n, 1e-3, specials=True)
    check_dense(n, 0.0, specials=True)


def test_k6_dense_replicas(cuda):
    check_dense(4099, 1e-3, n_rep=4)


@pytest.mark.parametrize("n,t,cap", [(1, 5e-4, 1), (33, 1e-3, 40),
                                     (4099, 1e-3, 5000),
                                     (2 ** 20 + 7, 2e-3, 2 ** 20),
                                     (4099, 5e-4, 100), (33, 1.0, 40),
                                     (33, 0.0, 40), (33, 1e-3, 0)])
def test_k6s_encode_decode(cuda, n, t, cap):
    check_sparse(n, t, cap, seed=n)


@pytest.mark.parametrize("specials_t", [1e-3, 0.0, float("inf")])
def test_k6s_specials(cuda, specials_t):
    check_sparse(33, specials_t, 40, specials=True)


@pytest.mark.parametrize("enc,size", [([5, 3, 3, -3, 1, 2], 4),
                                      ([4, 9, -12, 2, 100000], 8),
                                      ([50, 1, -2, 3], 4),
                                      ([-3, 1, 2, 3], 4),
                                      ([2, -2 ** 31, 1], 4)])
def test_k6s_malformed(cuda, enc, size):
    e = torch.tensor(enc, dtype=torch.int32, device="cuda")
    assert same(K.threshold_decode(e, 0.25, (size,)),
                K.threshold_decode_reference(e, 0.25, (size,)))
    assert torch.equal(K.dense_from_sparse(e, size),
                       K.dense_from_sparse_reference(e, size))
