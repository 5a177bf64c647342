"""The port's ``ops/tranche5.py`` and ``ops/tranche6.py`` against the JAX
package's, on the CPU.

One parametrised sweep runs each op the two modules define in both
registries on the same seeded numpy inputs (``_torch_ops_parity`` states
the tolerances). ``dot_product_attention_v2`` is swept over its routes
and ``multi_head_dot_product_attention_bp`` held against the reference's
``jax.vjp``; the legacy random family and the ONNX generators by their
moments and seed reproducibility.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_ops_parity import (EW, RED, SPECIAL, case_ids, check_case, ids,
                               n, spd, u)
from deeplearning4j_tpu.ops import registry as JR
from deeplearning4j_tpu_torch.ops import registry as TR


def _qkv(r, t_q=5, t_k=6, d=8):
    return [n(r, 2, 2, t_q, d), n(r, 2, 2, t_k, d), n(r, 2, 2, t_k, d)]


def _mha(r):
    d, h, dh = 8, 2, 8
    return [n(r, 2, 5, d), n(r, 2, 6, d), n(r, 2, 6, d),
            n(r, d, h, dh) * 0.3, n(r, d, h, dh) * 0.3, n(r, d, h, dh) * 0.3,
            n(r, h, dh, d) * 0.3, n(r, 2, 5, d)]


def _kmask(keep, t_k=6):
    return (np.arange(t_k)[None, :] < np.asarray(keep)[:, None])[
        :, None, None, :]


INT_WIDTHS = [np.int8, np.int16, np.int32, np.uint8, np.uint16, np.uint32]

CASES = [
    (nm, nm, lambda r: [n(r, 5) * 3], {}, EW)
    for nm in ("to_double", "to_float32", "to_float16", "to_int32",
               "to_int64", "to_uint32", "to_uint64")
] + [
    ("euclidean", "euclidean", lambda r: [n(r, 3, 4), n(r, 3, 4)], {}, RED),
    ("euclidean_dims", "euclidean", lambda r: [n(r, 3, 4), n(r, 3, 4), 1],
     {"keepdims": True}, RED),
    ("manhattan", "manhattan", lambda r: [n(r, 3, 4), n(r, 3, 4), 0], {},
     RED),
    ("cosinesim", "cosinesim", lambda r: [n(r, 3, 4), n(r, 3, 4), 1], {},
     RED),
    ("cosinedistance", "cosinedistance", lambda r: [n(r, 3, 4), n(r, 3, 4)],
     {}, RED),
    ("hammingdistance", "hammingdistance", lambda r: [
        ids(r, 2, 3, 4), ids(r, 2, 3, 4), 1], {}, EW),
    ("jaccarddistance", "jaccarddistance", lambda r: [
        u(r, 3, 4, lo=0, hi=1), u(r, 3, 4, lo=0, hi=1)], {}, RED),
    ("cholesky_solve", "cholesky_solve", lambda r: [
        np.linalg.cholesky(spd(r, 4)).astype(np.float32), n(r, 4, 2)], {},
     RED),
    ("cholesky_solve_vec", "cholesky_solve", lambda r: [
        np.linalg.cholesky(spd(r, 4)).T.astype(np.float32), n(r, 4)],
     {"lower": False}, RED),
    ("sqrtm", "sqrtm", lambda r: [spd(r, 4)], {}, SPECIAL),
    ("gemm", "gemm", lambda r: [n(r, 4, 3), n(r, 5, 4), n(r, 3, 5)],
     {"alpha": 0.5, "beta": 2.0, "transA": True, "transB": True}, RED),
    ("gemv", "gemv", lambda r: [n(r, 3, 4), n(r, 3), n(r, 4)],
     {"alpha": 1.5, "beta": 0.5, "transA": True}, RED),
    ("dot_product", "dot_product", lambda r: [n(r, 3, 4), n(r, 3, 4)], {},
     RED),
    ("floormod", "floormod", lambda r: [ids(r, 20, 8) - 10,
                                        ids(r, 4, 8) + 1], {}, EW),
    ("remainder", "remainder", lambda r: [n(r, 8) * 3,
                                          u(r, 8, lo=0.5, hi=2)], {}, EW),
    ("realdiv", "RealDiv", lambda r: [n(r, 6), u(r, 6, lo=0.5, hi=2)], {},
     EW),
    ("truncatediv_int", "truncatediv", lambda r: [
        ids(r, 20, 8) - 10, ids(r, 4, 8) + 1], {}, EW),
    ("reversemod", "reversemod", lambda r: [ids(r, 4, 8) + 1,
                                            ids(r, 20, 8) - 10], {}, EW),
    ("max_pairwise", "max_pairwise", lambda r: [n(r, 5), n(r, 5)], {}, EW),
    ("min_pairwise", "min_pairwise", lambda r: [n(r, 5), n(r, 5)], {}, EW),
    ("assign_add", "assign_add", lambda r: [n(r, 5), n(r, 5)], {}, EW),
    ("assign_sub", "assign_sub", lambda r: [n(r, 5), n(r, 5)], {}, EW),
    ("set_scalar", "set_scalar", lambda r: [n(r, 2, 3)], {"value": 2.5}, EW),
    ("compare_and_set", "compare_and_set", lambda r: [
        np.array([1.0, 2.0, 3.0, 2.0], np.float32), np.float32(2.0),
        np.float32(-1.0)], {}, EW),
    ("popcount_float", "popcount", lambda r: [n(r, 6) * 100], {}, EW),
] + [
    (f"popcount_{np.dtype(dt).name}", "bitcount", lambda r, dt=dt: [
        r.integers(np.iinfo(dt).min, np.iinfo(dt).max, 8,
                   endpoint=True).astype(dt)], {}, EW)
    for dt in INT_WIDTHS
] + [
    (f"cyclic_rshift_bits_{np.dtype(dt).name}", "cyclic_rshift_bits",
     lambda r, dt=dt: [r.integers(np.iinfo(dt).min, np.iinfo(dt).max, 8,
                                  endpoint=True).astype(dt)],
     {"shift": 3}, EW)
    for dt in INT_WIDTHS
] + [
    ("tanhderivative", "tanhderivative", lambda r: [n(r, 6)], {}, EW),
    ("softmaxderivative", "softmaxderivative", lambda r: [n(r, 3, 4)],
     {"axis": 0}, EW),
    ("alpha_dropout_eval", "alpha_dropout", lambda r: [n(r, 6)],
     {"training": False}, EW),
    ("softmax_cross_entropy_with_logits", "SoftmaxCrossEntropyWithLogits",
     lambda r: [n(r, 4, 5), np.eye(5, dtype=np.float32)[[0, 3, 1, 4]]], {},
     RED),
    ("ctc_loss_grad", "ctc_loss_grad", lambda r: [
        np.log(np.asarray(jax.nn.softmax(n(r, 2, 6, 4)))).astype(np.float32),
        np.array([[1, 2, 0], [3, 3, 1]], np.int32),
        np.array([6, 5], np.int32), np.array([2, 3], np.int32)], {}, RED),
    ("ctc_greedy_decoder", "ctc_greedy_decoder", lambda r: [
        n(r, 2, 8, 4) * 3, np.array([8, 5], np.int32)], {}, RED),
    ("ctc_greedy_no_merge", "ctc_greedy_decoder", lambda r: [
        n(r, 2, 8, 4) * 3], {"merge_repeated": False}, RED),
    ("ctc_beam", "ctc_beam_decoder", lambda r: [
        np.log(np.asarray(jax.nn.softmax(n(r, 2, 5, 3) * 2))).astype(
            np.float32)], {"beam_width": 3}, EW),
    # attention v2 over its routes
    ("dpa_v2", "DotProductAttentionV2", _qkv, {}, RED),
    ("dpa_v2_scale", "dot_product_attention_v2", _qkv, {"scale": 0.2}, RED),
    ("dpa_v2_causal", "dot_product_attention_v2",
     lambda r: _qkv(r, t_q=6), {"causal": True}, RED),
    ("dpa_v2_key_mask", "dot_product_attention_v2",
     lambda r: _qkv(r), {"mask": None}, RED),
    ("dpa_v2_3d", "dot_product_attention_v2",
     lambda r: [n(r, 3, 5, 4), n(r, 3, 6, 4), n(r, 3, 6, 4)], {}, RED),
    ("mhdpa_bp", "multi_head_dot_product_attention_bp", _mha, {}, RED),
    ("mhdpa_bp_causal", "multi_head_dot_product_attention_bp",
     lambda r: [n(r, 2, 6, 8)] + _mha(r)[1:7] + [n(r, 2, 6, 8)],
     {"causal": True}, RED),
    ("standardize_bp", "standardize_bp", lambda r: [n(r, 3, 6), n(r, 3, 6)],
     {}, RED),
    ("parallel_stack", "ParallelConcat", lambda r: [n(r, 2, 3), n(r, 2, 3)],
     {}, EW),
    ("where_np", "where_np", lambda r: [n(r, 4) > 0, n(r, 4), n(r, 4)], {},
     EW),
    ("where_np_coords", "where_np", lambda r: [n(r, 3, 4) > 0], {}, EW),
    ("flatten_2d", "Flatten2D", lambda r: [n(r, 2, 3, 4)], {"axis": 2}, EW),
    ("flatten_2d_0", "flatten_2d", lambda r: [n(r, 2, 3, 4)], {"axis": 0},
     EW),
    ("order", "order", lambda r: [n(r, 2, 3)], {}, EW),
    ("shapes_of", "shapes_of", lambda r: [n(r, 2, 3), n(r, 4)], {}, EW),
    ("tear", "tear", lambda r: [n(r, 3, 4), 1], {}, EW),
    ("logentropy", "logentropy", lambda r: [u(r, 3, 4, lo=0.05, hi=1), 1],
     {}, RED),
    ("biasadd", "BiasAdd", lambda r: [n(r, 2, 3, 4), n(r, 4)], {}, EW),
    ("biasadd_nchw", "biasadd", lambda r: [n(r, 2, 3, 4, 4), n(r, 3)],
     {"data_format": "NCHW"}, EW),
    ("grs_to_rgb", "GrayscaleToRgb", lambda r: [n(r, 2, 3, 1)], {}, EW),
    ("grs_to_rgb_stack", "grs_to_rgb", lambda r: [n(r, 2, 3)], {}, EW),
    ("apply_gradient_descent", "ApplyGradientDescent", lambda r: [
        n(r, 4), n(r, 4)], {"lr": 0.3}, EW),
    ("compat_sparse_to_dense", "compat_sparse_to_dense", lambda r: [
        np.array([[0, 1], [2, 0]], np.int32), np.array([3, 2], np.int32),
        n(r, 2)], {"default": -1.0}, EW),
    ("compat_string_split", "compat_string_split", lambda r: [
        ["a bc", "d e f"]], {}, EW),
    ("expose", "expose", lambda r: [n(r, 2), n(r, 3)], {}, EW),
    ("print_variable", "print_variable", lambda r: [n(r, 2)],
     {"message": "v="}, EW),
    ("print_affinity", "print_affinity", lambda r: [n(r, 2)], {}, EW),
    ("hard_swish", "HardSwish", lambda r: [n(r, 8) * 4], {}, EW),
    ("reduce_norm_max", "norm_max", lambda r: [n(r, 3, 4), 1],
     {"keepdims": True}, EW),
    ("reduce_norm_max_all", "reduce_norm_max", lambda r: [n(r, 3, 4)], {},
     EW),
    # tranche 6
    ("grid_sample", "grid_sample", lambda r: [
        n(r, 2, 3, 5, 6), u(r, 2, 4, 3, 2, lo=-1.2, hi=1.2)], {}, RED),
    ("grid_sample_border_ac", "grid_sample", lambda r: [
        n(r, 1, 2, 5, 6), u(r, 1, 4, 3, 2, lo=-1.2, hi=1.2)],
     {"padding_mode": "border", "align_corners": True}, RED),
    ("grid_sample_nearest", "grid_sample", lambda r: [
        n(r, 1, 2, 5, 6), u(r, 1, 4, 3, 2, lo=-1.0, hi=1.0)],
     {"mode": "nearest"}, EW),
    ("max_unpool", "max_unpool", lambda r: [
        n(r, 1, 2, 2, 2), np.array([[[[0, 3], [9, 14]], [[5, 2], [8, 15]]]],
                                   np.int32)],
     {"output_shape": (1, 2, 4, 4)}, EW),
    ("conv_integer", "conv_integer", lambda r: [
        ids(r, 255, 1, 2, 5, 5, dtype=np.uint8),
        ids(r, 255, 3, 2, 3, 3, dtype=np.uint8), np.uint8(128),
        np.uint8(100)], {"strides": (2, 1), "padding": ((1, 0), (1, 1))}, EW),
    ("conv_integer_int8", "conv_integer", lambda r: [
        (ids(r, 255, 1, 2, 4, 4) - 128).astype(np.int8),
        (ids(r, 255, 2, 2, 2, 2) - 128).astype(np.int8)],
     {"dilations": (2, 2)}, EW),
    ("lp_pool2d_nchw", "lp_pool2d_nchw", lambda r: [n(r, 1, 2, 5, 6)],
     {"kernel": (2, 3), "strides": (1, 2), "padding": ((1, 0), (0, 1)),
      "p": 3.0}, RED),
]


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_op_matches_reference(case):
    check_case(case)


@pytest.mark.parametrize("causal, keep", [(False, [2, 6]), (True, None),
                                          (True, [3, 6]), (False, [0, 6])])
def test_dpa_v2_masked_matches_reference(causal, keep):
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, t_q=6)
    mask = None if keep is None else _kmask(keep)
    j = JR.exec_op("dot_product_attention_v2", *map(jnp.asarray, (q, k, v)),
                   causal=causal,
                   mask=None if mask is None else jnp.asarray(mask))
    t = TR.exec_op("dot_product_attention_v2", *map(torch.as_tensor,
                                                    (q, k, v)),
                   causal=causal,
                   mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **RED)


def test_mhdpa_bp_with_key_mask_matches_reference():
    rng = np.random.default_rng(9)
    ins = _mha(rng)
    mask = _kmask([3, 6])
    j = JR.exec_op("multi_head_dot_product_attention_bp",
                   *map(jnp.asarray, ins), mask=jnp.asarray(mask))
    t = TR.exec_op("multi_head_dot_product_attention_bp",
                   *map(torch.as_tensor, ins), mask=torch.as_tensor(mask))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **RED)


@pytest.mark.parametrize("name, attrs, mean, std, lo, hi", [
    ("normal", {"mean": 1.0, "stddev": 2.0}, 1.0, 2.0, None, None),
    ("uniform", {"minval": -1.0, "maxval": 3.0}, 1.0, 4 / 12 ** 0.5, -1, 3),
    ("truncatednormal", {"mean": 0.5, "stddev": 1.0}, 0.5, 0.8796, -1.5,
     2.5),
    ("lognormal", {"mean": 0.0, "stddev": 0.5}, float(np.exp(0.125)),
     float(np.sqrt((np.exp(0.25) - 1) * np.exp(0.25))), 0, None),
    ("binomial", {"trials": 10, "p": 0.3}, 3.0, float(np.sqrt(2.1)), 0, 10),
    ("exponential_distribution", {"lam": 2.0}, 0.5, 0.5, 0, None),
    ("random_normal_gen", {"mean": -1.0, "scale": 0.5}, -1.0, 0.5, None,
     None),
    ("random_uniform_gen", {"low": 2.0, "high": 4.0}, 3.0, 2 / 12 ** 0.5, 2,
     4),
])
def test_legacy_random_family_holds_moments(name, attrs, mean, std, lo, hi):
    shape = [20000]
    outs = [TR.exec_op(name, shape=shape, seed=5, **attrs).numpy(),
            np.asarray(JR.exec_op(name, shape=shape, seed=5, **attrs))]
    gen = torch.Generator().manual_seed(1)
    outs.append(TR.exec_op(name, shape=shape, generator=gen,
                           **attrs).numpy())
    for out in outs:
        assert out.shape == (20000,) and out.dtype == np.float32
        assert abs(out.mean() - mean) < 0.05 * max(abs(mean), std)
        assert abs(out.std() - std) < 0.05 * std
        if lo is not None:
            assert out.min() >= lo
        if hi is not None:
            assert out.max() <= hi
    again = TR.exec_op(name, shape=shape, seed=5, **attrs).numpy()
    np.testing.assert_array_equal(again, outs[0])


def test_alpha_dropout_keeps_mean_and_variance():
    x = np.random.default_rng(0).standard_normal(40000).astype(np.float32)
    t = TR.exec_op("alpha_dropout", torch.as_tensor(x), p=0.2, seed=3).numpy()
    j = np.asarray(JR.exec_op("alpha_dropout", jnp.asarray(x), p=0.2,
                              seed=3))
    for out in (t, j):
        assert abs(out.mean()) < 0.03 and abs(out.std() - 1.0) < 0.03


def test_set_and_get_seed():
    with torch.random.fork_rng():
        assert int(TR.exec_op("set_seed", 42)) == 42
        assert int(TR.exec_op("get_seed")) == 42
        a = TR.exec_op("normal", shape=[4])
        TR.exec_op("set_seed", 42)
        np.testing.assert_array_equal(
            TR.exec_op("normal", shape=[4]).numpy(), a.numpy())
