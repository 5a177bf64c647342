"""The port's ``ops/extended.py`` against the JAX package's, on the CPU:
its segment and scatter, bitwise, image, linalg, loss, nn, spectral and
CTC sections and its random ops (``test_torch_ops_extended`` sweeps the
rest; ``_torch_ops_parity`` states the tolerances). The random ops are
held by their distributions and by seed reproducibility, the
decompositions with a free sign by what is defined.
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

INT_WIDTHS = [np.int8, np.int16, np.int32, np.uint8, np.uint16, np.uint32]

CASES = [
    # segment / scatter
    ("segment_max", "SegmentMax", lambda r: [
        n(r, 6, 2), np.array([0, 0, 1, 1, 1, 3], np.int32)], {}, EW),
    ("segment_min", "segment_min", lambda r: [
        n(r, 6, 2), np.array([0, 0, 1, 1, 1, 2], np.int32)],
     {"num_segments": 4}, EW),
    ("segment_prod", "SegmentProd", lambda r: [
        n(r, 6), np.array([0, 0, 1, 1, 1, 2], np.int32)], {}, RED),
    ("segment_mean", "SegmentMean", lambda r: [
        n(r, 6, 3), np.array([0, 0, 1, 1, 1, 3], np.int32)], {}, RED),
    ("segment_max_int", "SegmentMax", lambda r: [
        ids(r, 50, 5), np.array([0, 1, 1, 3, 3], np.int32)], {}, EW),
    ("unsorted_segment_sqrt_n", "UnsortedSegmentSqrtN", lambda r: [
        n(r, 6, 2), np.array([2, 0, 2, 1, 2, 0], np.int32)],
     {"num_segments": 4}, RED),
    ("scatter_sub", "ScatterSub", lambda r: [
        n(r, 5, 3), np.array([1, 3, 1], np.int32), n(r, 3, 3)], {}, EW),
    ("scatter_mul", "ScatterMul", lambda r: [
        n(r, 5, 3), np.array([1, 3, 1], np.int32), n(r, 3, 3)], {}, EW),
    ("scatter_div", "ScatterDiv", lambda r: [
        n(r, 5, 3), np.array([1, 3], np.int32),
        u(r, 2, 3, lo=0.5, hi=2)], {}, EW),
    ("scatter_max", "ScatterMax", lambda r: [
        n(r, 5, 3), np.array([1, 3, 1], np.int32), n(r, 3, 3)], {}, EW),
    ("scatter_min", "ScatterMin", lambda r: [
        n(r, 5, 3), np.array([4, 0, 4], np.int32), n(r, 3, 3)], {}, EW),
    ("scatter_nd", "ScatterNd", lambda r: [
        np.array([[0, 1], [2, 2], [0, 1]], np.int32), n(r, 3)],
     {"shape": [3, 4]}, EW),
    ("scatter_nd_add", "TensorScatterAdd", lambda r: [
        n(r, 3, 4), np.array([[0, 1], [2, 2]], np.int32), n(r, 2)], {}, EW),
    ("scatter_nd_update", "ScatterNdUpdate", lambda r: [
        n(r, 3, 4), np.array([[1], [2]], np.int32), n(r, 2, 4)], {}, EW),
    ("scatter_nd_sub", "ScatterNdSub", lambda r: [
        n(r, 3, 4), np.array([[0, 1], [2, 2]], np.int32), n(r, 2)], {}, EW),
    # bitwise
    ("bitwise_and", "BitwiseAnd", lambda r: [ids(r, 255, 6), ids(r, 255, 6)],
     {}, EW),
    ("bitwise_or", "BitwiseOr", lambda r: [ids(r, 255, 6), ids(r, 255, 6)],
     {}, EW),
    ("bitwise_xor", "BitwiseXor", lambda r: [ids(r, 255, 6),
                                             ids(r, 255, 6)], {}, EW),
    ("toggle_bits", "bitwise_not", lambda r: [ids(r, 255, 6) - 100], {}, EW),
] + [
    (f"{nm}_{np.dtype(dt).name}", nm, lambda r, dt=dt: [
        r.integers(np.iinfo(dt).min, np.iinfo(dt).max, 8,
                   endpoint=True).astype(dt),
        np.array([0, 1, 3, 5, 7, 2, 4, 6], dt)], {}, EW)
    for nm in ("shift_bits", "rshift_bits", "cyclic_shift_bits")
    for dt in INT_WIDTHS
] + [
    (f"bits_hamming_distance_{np.dtype(dt).name}", "BitsHammingDistance",
     lambda r, dt=dt: [
        r.integers(np.iinfo(dt).min, np.iinfo(dt).max, 8,
                   endpoint=True).astype(dt),
        r.integers(np.iinfo(dt).min, np.iinfo(dt).max, 8,
                   endpoint=True).astype(dt)], {}, EW)
    for dt in INT_WIDTHS
] + [
    ("bitcast_same", "Bitcast", lambda r: [n(r, 4)], {"dtype": "int32"},
     EW),
    ("bitcast_narrow", "bitcast", lambda r: [n(r, 2, 3)],
     {"dtype": "uint8"}, EW),
    ("bitcast_wide", "bitcast", lambda r: [ids(r, 255, 3, 4,
                                               dtype=np.uint8)],
     {"dtype": "float32"}, EW),
    # image
    ("resize_nearest_neighbor", "ResizeNearestNeighbor", lambda r: [
        n(r, 1, 4, 6, 2)], {"size": (7, 3)}, EW),
    ("resize_bicubic", "ResizeBicubic", lambda r: [n(r, 1, 5, 6, 2)],
     {"size": (8, 4)}, RED),
    ("resize_area", "ResizeArea", lambda r: [n(r, 1, 4, 6, 2)],
     {"size": (8, 9)}, RED),
    ("crop_and_resize", "CropAndResize", lambda r: [
        n(r, 2, 6, 7, 3),
        np.array([[0.1, 0.2, 0.8, 0.9], [0.0, 0.0, 1.0, 0.5],
                  [0.3, 0.1, 0.6, 0.7]], np.float32),
        np.array([0, 1, 1], np.int32)], {"crop_size": (4, 5)}, RED),
    ("extract_image_patches", "ExtractImagePatches", lambda r: [
        n(r, 1, 6, 7, 2)], {"ksizes": (2, 3), "strides": (2, 1)}, EW),
    ("extract_image_patches_same", "extract_image_patches", lambda r: [
        n(r, 1, 6, 7, 2)],
     {"ksizes": (3, 3), "strides": (2, 2), "rates": (1, 2),
      "padding": "SAME"}, EW),
    ("rgb_to_grayscale", "RgbToGrayscale", lambda r: [
        u(r, 2, 3, 3, lo=0, hi=1)], {}, EW),
    ("rgb_to_hsv", "RgbToHsv", lambda r: [u(r, 4, 5, 3, lo=0, hi=1)], {},
     RED),
    ("hsv_to_rgb", "HsvToRgb", lambda r: [u(r, 4, 5, 3, lo=0, hi=1)], {},
     RED),
    ("rgb_to_yuv", "RgbToYuv", lambda r: [u(r, 4, 3, lo=0, hi=1)], {}, RED),
    ("yuv_to_rgb", "YuvToRgb", lambda r: [u(r, 4, 3, lo=0, hi=1)], {}, RED),
    ("adjust_contrast", "AdjustContrastV2", lambda r: [
        u(r, 2, 3, 4, 3, lo=0, hi=1), np.float32(1.7)], {}, RED),
    ("adjust_saturation", "AdjustSaturation", lambda r: [
        u(r, 3, 4, 3, lo=0, hi=1), np.float32(0.6)], {}, RED),
    ("adjust_hue", "AdjustHue", lambda r: [
        u(r, 3, 4, 3, lo=0, hi=1), np.float32(0.3)], {}, RED),
    # linalg
    ("matrix_diag", "MatrixDiag", lambda r: [n(r, 2, 3)], {}, EW),
    ("matrix_diag_1d", "matrix_diag", lambda r: [n(r, 4)], {}, EW),
    ("matrix_set_diag", "MatrixSetDiag", lambda r: [n(r, 2, 3, 4),
                                                    n(r, 2, 3)], {}, EW),
    ("cross", "Cross", lambda r: [n(r, 4, 3), n(r, 4, 3)], {}, RED),
    ("logdet", "Logdet", lambda r: [spd(r, 4)], {}, RED),
    ("lu", "Lu", lambda r: [n(r, 4, 4)], {}, RED),
    ("matrix_transpose", "adjoint", lambda r: [n(r, 2, 3, 4)], {}, EW),
    # losses
    ("huber_loss", "HuberLoss", lambda r: [n(r, 4, 3), n(r, 4, 3) * 2],
     {"delta": 0.7}, RED),
    ("huber_loss_weighted", "huber_loss", lambda r: [
        n(r, 4, 3), n(r, 4, 3), u(r, 4, 1, lo=0, hi=1)], {}, RED),
    ("log_loss", "LogLoss", lambda r: [
        (n(r, 4, 3) > 0).astype(np.float32), u(r, 4, 3, lo=0, hi=1)],
     {"reduction": "sum"}, RED),
    ("absolute_difference_loss", "AbsoluteDifference", lambda r: [
        n(r, 4, 3), n(r, 4, 3)], {"reduction": "none"}, EW),
    ("mean_sqerr_loss", "MeanSqerrLoss", lambda r: [n(r, 4, 3), n(r, 4, 3)],
     {}, RED),
    ("hinge_loss", "HingeLoss", lambda r: [
        (n(r, 4, 3) > 0).astype(np.float32), n(r, 4, 3)], {}, RED),
    ("cosine_distance_loss", "CosineDistanceLoss", lambda r: [
        n(r, 4, 3), n(r, 4, 3)], {}, RED),
    ("weighted_cross_entropy_with_logits", "WeightedCrossEntropyWithLogits",
     lambda r: [(n(r, 4, 3) > 0).astype(np.float32), n(r, 4, 3),
                np.float32(2.5)], {}, EW),
    # nn extensions
    ("bias_add", "bias_add", lambda r: [n(r, 2, 3, 4), n(r, 4)], {}, EW),
    ("xw_plus_b", "XwPlusB", lambda r: [n(r, 3, 4), n(r, 4, 5), n(r, 5)], {},
     RED),
    ("relu_layer", "ReluLayer", lambda r: [n(r, 3, 4), n(r, 4, 5), n(r, 5)],
     {}, RED),
    ("embedding_lookup", "EmbeddingLookup", lambda r: [
        n(r, 6, 3), np.array([[0, 5], [2, 2]], np.int32)], {}, EW),
    ("lstm_layer", "LSTMLayer", lambda r: [
        n(r, 2, 5, 3), n(r, 2, 4), n(r, 2, 4), n(r, 7, 16) * 0.3, n(r, 16)],
     {"forget_bias": 1.0}, RED),
    ("gru_layer", "GRULayer", lambda r: [
        n(r, 2, 5, 3), n(r, 2, 4), n(r, 7, 8) * 0.3, n(r, 7, 4) * 0.3,
        n(r, 8), n(r, 4)], {}, RED),
    ("trapz", "trapz", lambda r: [n(r, 3, 5)], {}, RED),
    ("trapz_x", "trapz", lambda r: [n(r, 3, 5),
                                    np.cumsum(u(r, 5, lo=0.1, hi=1))],
     {"axis": 1}, RED),
    # spectral
    ("fft", "FFT", lambda r: [n(r, 3, 8)], {}, RED),
    ("ifft", "IFFT", lambda r: [n(r, 3, 8)], {"n": 6}, RED),
    ("rfft", "RFFT", lambda r: [n(r, 3, 8)], {}, RED),
    ("irfft", "IRFFT", lambda r: [n(r, 3, 5)], {"n": 8}, RED),
    ("fft2", "FFT2D", lambda r: [n(r, 2, 4, 4)], {}, RED),
    ("ifft2", "IFFT2D", lambda r: [n(r, 2, 4, 4)], {}, RED),
    # ctc
    ("ctc_loss", "CTCLoss", lambda r: [
        np.log(np.asarray(jax.nn.softmax(n(r, 2, 8, 5)))).astype(np.float32),
        np.array([[1, 2, 2, 0], [3, 1, 0, 0]], np.int32),
        np.array([8, 6], np.int32), np.array([3, 2], np.int32)], {}, RED),
    # linalg tranche
    ("pinv", "Pinv", lambda r: [n(r, 4, 3)], {}, SPECIAL),
    ("kron", "Kron", lambda r: [n(r, 2, 3), n(r, 2, 2)], {}, EW),
    ("matrix_power", "MatrixPower", lambda r: [n(r, 3, 3) * 0.5],
     {"n": 3}, SPECIAL),
    ("matrix_rank", "MatrixRank", lambda r: [
        (n(r, 4, 2) @ n(r, 2, 5)).astype(np.float32)], {}, EW),
    ("norm", "Norm", lambda r: [n(r, 3, 4)], {}, RED),
    ("norm_fro_axis", "norm", lambda r: [n(r, 3, 4)],
     {"ord": 1, "axis": 1, "keepdims": True}, RED),
    ("outer", "Outer", lambda r: [n(r, 3), n(r, 2, 2)], {}, EW),
    ("triu", "Triu", lambda r: [n(r, 4, 5)], {"k": 1}, EW),
    ("tril", "Tril", lambda r: [n(r, 2, 4, 5)], {"k": -1}, EW),
]


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_op_matches_reference(case):
    check_case(case)


def test_self_adjoint_eig_holds_what_is_defined():
    x = (lambda a: (a + a.T) / 2)(np.random.default_rng(3).standard_normal(
        (5, 5)).astype(np.float32))
    w, v = TR.exec_op("SelfAdjointEigV2", torch.as_tensor(x))
    jw, _ = JR.exec_op("eigh", jnp.asarray(x))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)
    np.testing.assert_allclose((v * w) @ v.T, x, atol=1e-5)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name, args, attrs, mean, var", [
    ("random_gamma", [np.float32(2.5)], {"shape": [20000]}, 2.5, 2.5),
    ("random_gamma", [np.float32(0.4)], {"shape": [20000]}, 0.4, 0.4),
    ("random_poisson", [np.float32(3.0)], {"shape": [20000]}, 3.0, 3.0),
    ("random_exponential", [np.float32(2.0)], {"shape": [20000]}, 0.5, 0.25),
])
def test_random_ops_hold_moments(name, args, attrs, mean, var):
    """Each package's draws against the distribution's moments, and the
    port's draws again from the same seed."""
    t = TR.exec_op(name, _gen(), *[torch.as_tensor(a) for a in args],
                   **attrs).numpy()
    j = np.asarray(JR.exec_op(name, jax.random.key(0),
                              *[jnp.asarray(a) for a in args], **attrs))
    for out in (t, j):
        assert out.shape == (20000,) and out.dtype == np.float32
        assert abs(out.mean() - mean) < 0.05 * max(mean, 1.0)
        assert abs(out.var() - var) < 0.08 * max(var, 1.0)
        assert (out >= 0).all()
    again = TR.exec_op(name, _gen(), *[torch.as_tensor(a) for a in args],
                       **attrs).numpy()
    np.testing.assert_array_equal(again, t)


def test_random_gamma_takes_alpha_shape():
    alpha = np.array([0.5, 1.0, 4.0], np.float32)
    t = TR.exec_op("RandomGamma", _gen(1), torch.as_tensor(alpha))
    j = JR.exec_op("random_gamma", jax.random.key(1), jnp.asarray(alpha))
    assert tuple(t.shape) == np.asarray(j).shape == (3,)


def test_random_shuffle_and_categorical_hold_their_support():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    t = TR.exec_op("RandomShuffle", _gen(2), torch.as_tensor(x)).numpy()
    assert sorted(map(tuple, t)) == sorted(map(tuple, x))
    logits = np.log(np.array([[0.7, 0.2, 0.1], [0.0001, 0.0001, 0.9998]],
                             np.float32))
    t = TR.exec_op("Multinomial", _gen(3), torch.as_tensor(logits),
                   num_samples=4000).numpy()
    assert t.shape == (2, 4000) and t.dtype == np.int32
    assert (t[1] == 2).mean() > 0.99
    # the reference's (B, num_samples) draw shape broadcasts only one row
    j = np.asarray(JR.exec_op("random_categorical", jax.random.key(3),
                              jnp.asarray(logits[:1]), num_samples=4000))
    assert j.shape == (1, 4000) and j.dtype == t.dtype
    for row in (t[0], j[0]):
        np.testing.assert_allclose(np.bincount(row, minlength=3) / 4000,
                                   [0.7, 0.2, 0.1], atol=0.03)
