"""The port's ``ops/tranche4.py`` ``_bp`` ops and legacy derivative
transforms against the JAX package's, on the CPU: each ``_bp`` op held
against the reference's ``jax.vjp`` result (the sweep) and against
autograd of the port's own forward; the derivatives against the
reference's ``jax.grad`` (``_torch_ops_parity`` states the tolerances).
"""
import numpy as np
import pytest
import torch

from _torch_ops_parity import RED, case_ids, check_case, n, u
from deeplearning4j_tpu_torch.ops import registry as TR


def _grad_like(fwd_inputs, out_shape):
    return lambda r: fwd_inputs(r) + [n(r, *out_shape)]


BP = [
    ("conv1d_bp", lambda r: [n(r, 2, 7, 3), n(r, 3, 3, 4)], (2, 7, 4), {}),
    ("conv2d_bp", lambda r: [n(r, 1, 5, 5, 2), n(r, 3, 3, 2, 3)],
     (1, 5, 5, 3), {}),
    ("conv3d_bp", lambda r: [n(r, 1, 4, 4, 4, 2), n(r, 2, 2, 2, 2, 3)],
     (1, 4, 4, 4, 3), {}),
    ("deconv2d_bp", lambda r: [n(r, 1, 3, 3, 2), n(r, 3, 3, 2, 2)],
     (1, 6, 6, 2), {"strides": (2, 2)}),
    ("depthwise_conv2d_bp", lambda r: [n(r, 1, 5, 5, 2), n(r, 3, 3, 2, 2)],
     (1, 5, 5, 4), {}),
    ("maxpool2d_bp", lambda r: [n(r, 1, 4, 4, 2)], (1, 2, 2, 2), {}),
    ("avgpool2d_bp", lambda r: [n(r, 1, 4, 4, 2)], (1, 2, 2, 2), {}),
    ("maxpool3d_bp", lambda r: [n(r, 1, 4, 4, 4, 2)], (1, 2, 2, 2, 2), {}),
    ("avgpool3d_bp", lambda r: [n(r, 1, 4, 4, 4, 2)], (1, 2, 2, 2, 2), {}),
    ("pnormpool2d_bp", lambda r: [n(r, 1, 4, 4, 2)], (1, 2, 2, 2), {}),
    ("upsampling2d_bp", lambda r: [n(r, 1, 2, 3, 2)], (1, 4, 6, 2), {}),
    ("upsampling3d_bp", lambda r: [n(r, 1, 2, 2, 2, 2)], (1, 4, 4, 4, 2),
     {}),
    ("lrn_bp", lambda r: [n(r, 1, 2, 2, 6)], (1, 2, 2, 6),
     {"depth_radius": 2}),
    ("layer_norm_bp", lambda r: [n(r, 3, 6), n(r, 6), n(r, 6)], (3, 6), {}),
    ("im2col_bp", lambda r: [n(r, 1, 5, 5, 2)], (1, 2, 2, 18),
     {"kernel": (3, 3), "strides": (2, 2)}),
    ("softmax_bp", lambda r: [n(r, 3, 5)], (3, 5), {}),
    ("log_softmax_bp", lambda r: [n(r, 3, 5)], (3, 5), {}),
    ("prelu_bp", lambda r: [n(r, 3, 5), u(r, 5)], (3, 5), {}),
    ("tanh_bp", lambda r: [n(r, 3, 5)], (3, 5), {}),
    ("sigmoid_bp", lambda r: [n(r, 3, 5)], (3, 5), {}),
]

CASES = [
    (nm, nm, lambda r: [u(r, 3, 4, lo=-2.5, hi=2.5) + 0.01], {}, RED)
    for nm in ("cube_derivative", "elu_derivative", "selu_derivative",
               "softsign_derivative", "softplus_derivative",
               "hardsigmoid_derivative", "hardtanh_derivative",
               "rationaltanh_derivative", "rectifiedtanh_derivative",
               "leakyrelu_derivative", "relu_derivative", "relu6_derivative",
               "swish_derivative", "mish_derivative", "gelu_derivative")
] + [
    (nm, nm, _grad_like(mk, shp), attrs, RED) for nm, mk, shp, attrs in BP
]


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_op_matches_reference(case):
    check_case(case)


@pytest.mark.parametrize("name, make, shape, attrs", BP,
                         ids=[b[0] for b in BP])
def test_bp_is_autograd_of_the_forward(name, make, shape, attrs):
    rng = np.random.default_rng(11)
    xs = [torch.tensor(a, requires_grad=True) for a in make(rng)]
    g = torch.as_tensor(n(rng, *shape))
    fwd = name[:-3]
    out = TR.exec_op(fwd, *xs, **attrs)
    want = torch.autograd.grad((out * g).sum(), xs)
    got = TR.exec_op(name, *[x.detach() for x in xs], g, **attrs)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **RED)
