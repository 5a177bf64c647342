"""The port's op registry (``deeplearning4j_tpu_torch/ops/registry.py`` and
the registry half of ``ops/standard.py``) against the JAX package's, on
the CPU.

One parametrised sweep runs each standard op of both registries on the
same seeded numpy inputs and attributes, by name: values and dtypes agree,
f32 to atol 1e-6 (with rtol 1e-6 for values far from 1) elementwise and
atol 1e-5 for reductions, products, convolutions and the ops built on
them; integers and bools exactly. Ops with free signs or draws (QR, SVD,
the random ops) are held by what is defined: a reconstruction, the
singular values, shapes and moments. Every name and alias the reference's
``ops/standard.py`` registers resolves in both registries to one op, and
``alias`` refuses to rebind a name to another op.
"""
import ast
import zlib
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import registry as JR
from deeplearning4j_tpu_torch.ops import dtypes as TD
from deeplearning4j_tpu_torch.ops import registry as TR

ROOT = Path(__file__).resolve().parent.parent
EW = dict(atol=1e-6, rtol=1e-6)       # elementwise
RED = dict(atol=1e-5, rtol=1e-5)      # reductions, products, convolutions


def _u(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _n(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _spd(rng, n):
    a = _n(rng, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _tri(rng, n):
    return (np.tril(_n(rng, n, n)) + 3 * np.eye(n)).astype(np.float32)


def _ids(rng, hi, *shape):
    return rng.integers(0, hi, shape).astype(np.int32)


# (case id, op name, inputs(rng) -> list, attrs, tolerance)
CASES = [
    ("add", "add", lambda r: [_n(r, 3, 4), _n(r, 4)], {}, EW),
    ("add_int", "Add", lambda r: [_ids(r, 9, 5), _ids(r, 9, 5)], {}, EW),
    ("sub", "sub", lambda r: [_n(r, 3, 4), _n(r, 3, 1)], {}, EW),
    ("mul", "Mul", lambda r: [_n(r, 2, 3), _n(r, 2, 3)], {}, EW),
    ("div", "RealDiv", lambda r: [_n(r, 6), _u(r, 6, lo=0.5, hi=2)], {}, EW),
    ("div_int", "div", lambda r: [_ids(r, 9, 6), _ids(r, 5, 6) + 1], {}, EW),
    ("floordiv", "FloorDiv", lambda r: [_n(r, 8) * 4,
                                        _u(r, 8, lo=0.5, hi=2)], {}, EW),
    ("floordiv_int", "floordiv", lambda r: [_ids(r, 20, 8) - 10,
                                            _ids(r, 4, 8) + 1], {}, EW),
    ("mod", "FloorMod", lambda r: [_ids(r, 20, 8) - 10, _ids(r, 4, 8) + 1],
     {}, EW),
    ("mod_float", "mod", lambda r: [_n(r, 8) * 3, _u(r, 8, lo=0.5, hi=2)],
     {}, EW),
    ("pow", "Pow", lambda r: [_u(r, 6, lo=0.5, hi=2), _u(r, 6)], {}, EW),
    ("squaredsubtract", "SquaredDifference",
     lambda r: [_n(r, 4, 5), _n(r, 4, 1)], {}, EW),
    ("maximum", "Maximum", lambda r: [_n(r, 7), _n(r, 7)], {}, EW),
    ("minimum", "minimum", lambda r: [_n(r, 7), _n(r, 7)], {}, EW),
    ("neg", "Neg", lambda r: [_n(r, 5)], {}, EW),
    ("reciprocal", "Reciprocal", lambda r: [_u(r, 5, lo=0.5, hi=2)], {}, EW),
    ("truncate_div_int", "TruncateDiv",
     lambda r: [_ids(r, 20, 8) - 10, _ids(r, 4, 8) + 1], {}, EW),
    ("truncatediv_float", "truncatediv",
     lambda r: [_n(r, 8) * 3, _u(r, 8, lo=0.5, hi=2)], {}, EW),
    ("truncate_div_float", "truncate_div",
     lambda r: [_n(r, 8), _u(r, 8, lo=0.5, hi=2)], {}, EW),
] + [
    (name, name, lambda r, lo=lo, hi=hi: [_u(r, 3, 4, lo=lo, hi=hi)], {}, EW)
    for name, lo, hi in [
        ("abs", -1, 1), ("exp", -2, 2), ("log", 0.1, 3), ("log1p", -0.5, 2),
        ("sqrt", 0.1, 3), ("rsqrt", 0.1, 3), ("square", -2, 2),
        ("sin", -3, 3), ("cos", -3, 3), ("tan", -1, 1), ("asin", -0.9, 0.9),
        ("acos", -0.9, 0.9), ("atan", -3, 3), ("sinh", -2, 2),
        ("cosh", -2, 2), ("tanh", -3, 3), ("asinh", -3, 3),
        ("acosh", 1.1, 3), ("atanh", -0.9, 0.9), ("erf", -2, 2),
        ("erfc", -2, 2), ("floor", -3, 3), ("ceil", -3, 3),
        ("round", -3, 3), ("sign", -1, 1), ("sigmoid", -4, 4),
        ("relu", -1, 1), ("relu6", -2, 8), ("elu", -2, 2), ("selu", -2, 2),
        ("gelu", -3, 3), ("softplus", -4, 4), ("softsign", -3, 3),
        ("swish", -3, 3), ("mish", -3, 3), ("hard_sigmoid", -4, 4),
        ("hard_tanh", -2, 2), ("cube", -2, 2), ("rationaltanh", -2, 2),
        ("rectifiedtanh", -2, 2)]
] + [
    ("isnan", "IsNan", lambda r: [np.array([1.0, np.nan, -np.inf, 0.5],
                                            np.float32)], {}, EW),
    ("isinf", "IsInf", lambda r: [np.array([1.0, np.nan, -np.inf, np.inf],
                                            np.float32)], {}, EW),
    ("isfinite", "IsFinite", lambda r: [np.array([1.0, np.nan, np.inf],
                                                  np.float32)], {}, EW),
    ("clipbyvalue", "ClipByValue", lambda r: [_n(r, 9)],
     {"clip_value_min": -0.5, "clip_value_max": 0.7}, EW),
    ("clipbyvalue_lohi", "clipbyvalue", lambda r: [_n(r, 9)],
     {"lo": -0.2, "hi": 0.3}, EW),
    ("clipbynorm", "ClipByNorm", lambda r: [_n(r, 3, 3)], {"clipnorm": 1.0},
     RED),
    ("leakyrelu", "LeakyRelu", lambda r: [_n(r, 8)], {"alpha": 0.2}, EW),
    ("prelu", "PRelu", lambda r: [_n(r, 4, 3), _u(r, 3)], {}, EW),
    ("thresholdedrelu", "thresholdedrelu", lambda r: [_n(r, 8) * 2],
     {"theta": 0.5}, EW),
    ("softmax", "Softmax", lambda r: [_n(r, 3, 5)], {}, EW),
    ("softmax_axis0", "softmax", lambda r: [_n(r, 3, 5)], {"axis": 0}, EW),
    ("log_softmax", "LogSoftmax", lambda r: [_n(r, 3, 5)], {}, EW),
    # reductions
    ("sum_all", "reduce_sum", lambda r: [_n(r, 3, 4)], {}, RED),
    ("sum_axes", "Sum", lambda r: [_n(r, 3, 4, 5)],
     {"axis": (0, 2), "keepdims": True}, RED),
    ("sum_bool", "sum", lambda r: [_n(r, 3, 4) > 0], {"axis": 1}, EW),
    ("sum_scalar", "reduce_sum", lambda r: [np.float32(2.5)], {}, EW),
    ("mean_keep_dims", "Mean", lambda r: [_n(r, 3, 4)],
     {"axis": [1], "keep_dims": True}, RED),
    ("mean_int", "mean", lambda r: [_ids(r, 9, 3, 4)], {"axis": 0}, RED),
    ("max", "Max", lambda r: [_n(r, 3, 4)], {"axis": 1}, EW),
    ("min", "reduce_min", lambda r: [_n(r, 3, 4)], {"axis": (0, 1)}, EW),
    ("prod", "Prod", lambda r: [_u(r, 3, 4, 2, lo=0.5, hi=1.5)],
     {"axis": (0, 2)}, RED),
    ("norm1", "reduce_norm1", lambda r: [_n(r, 3, 4)], {"axis": 1}, RED),
    ("norm2", "reduce_norm2", lambda r: [_n(r, 3, 4)], {"axis": 0}, RED),
    ("normmax", "reduce_normmax", lambda r: [_n(r, 3, 4)], {}, EW),
    ("all", "All", lambda r: [_n(r, 3, 4) > -1.5], {"axis": (1,)}, EW),
    ("any", "Any", lambda r: [_n(r, 3, 4) > 1.0], {"axis": 0}, EW),
    ("variance", "reduce_variance", lambda r: [_n(r, 4, 6)],
     {"axis": 1, "bias_corrected": True}, RED),
    ("stdev", "reduce_stdev", lambda r: [_n(r, 4, 6)],
     {"axis": 0, "keepdims": True}, RED),
    ("logsumexp", "reduce_logsumexp", lambda r: [_n(r, 4, 6)], {"axis": 1},
     RED),
    ("argmax", "ArgMax", lambda r: [_n(r, 4, 6)], {"axis": 1}, EW),
    ("argmax_flat", "argmax", lambda r: [_n(r, 4, 6)], {}, EW),
    ("argmin", "ArgMin", lambda r: [_n(r, 4, 6)], {"axis": 0}, EW),
    ("cumsum", "Cumsum", lambda r: [_n(r, 3, 5)], {"axis": 1}, RED),
    ("cumsum_excl_rev", "cumsum", lambda r: [_n(r, 3, 5)],
     {"axis": 1, "exclusive": True, "reverse": True}, RED),
    ("cumprod_excl", "Cumprod", lambda r: [_u(r, 3, 5, lo=0.5, hi=1.5)],
     {"axis": 0, "exclusive": True}, RED),
    # shape
    ("reshape", "Reshape", lambda r: [_n(r, 3, 4)], {"shape": [2, -1]}, EW),
    ("transpose", "Transpose", lambda r: [_n(r, 2, 3, 4)],
     {"perm": [2, 0, 1]}, EW),
    ("transpose_rev", "transpose", lambda r: [_n(r, 2, 3, 4)], {}, EW),
    ("squeeze", "Squeeze", lambda r: [_n(r, 1, 3, 1)], {"axis": [0]}, EW),
    ("squeeze_all", "squeeze", lambda r: [_n(r, 1, 3, 1)], {}, EW),
    ("expand_dims", "ExpandDims", lambda r: [_n(r, 3, 4)], {"axis": -1},
     EW),
    ("concat", "ConcatV2", lambda r: [_n(r, 2, 3), _n(r, 2, 2)],
     {"axis": 1}, EW),
    ("stack", "Pack", lambda r: [_n(r, 2, 3), _n(r, 2, 3)], {"axis": 1},
     EW),
    ("unstack", "Unpack", lambda r: [_n(r, 2, 3)], {"axis": 1, "num": 3},
     EW),
    ("tile", "Tile", lambda r: [_n(r, 2, 3)], {"reps": [2, 1]}, EW),
    ("flip", "flip", lambda r: [_n(r, 2, 3)], {"axis": [0, 1]}, EW),
    ("reverse", "ReverseV2", lambda r: [_n(r, 2, 3)], {"axis": 1}, EW),
    ("slice", "Slice", lambda r: [_n(r, 4, 5)],
     {"begin": [1, 2], "size": [2, -1]}, EW),
    ("slice_clamped", "slice", lambda r: [_n(r, 4, 5)],
     {"begin": [3, 0], "size": [2, 5]}, EW),
    ("strided_slice", "StridedSlice", lambda r: [_n(r, 6, 5)],
     {"begin": [1, None], "end": [5, None], "strides": [2, -1]}, EW),
    ("strided_slice_neg", "strided_slice", lambda r: [_n(r, 6, 5)],
     {"begin": [-1, 4], "end": [None, 0], "strides": [1, -2]}, EW),
    ("gather", "GatherV2", lambda r: [_n(r, 5, 3),
                                      np.array([[0, 4], [-1, 2]], np.int32)],
     {"axis": 0}, EW),
    ("gather_axis1", "gather", lambda r: [_n(r, 2, 5, 3),
                                          np.array([4, 1], np.int32)],
     {"axis": 1}, EW),
    ("split", "Split", lambda r: [_n(r, 4, 6)], {"num_split": 3, "axis": 1},
     EW),
    ("split_v", "SplitV", lambda r: [_n(r, 6, 2)],
     {"size_splits": [1, 3, 2], "axis": 0}, EW),
    ("einsum", "Einsum", lambda r: [_n(r, 2, 3, 4), _n(r, 2, 4, 5)],
     {"equation": "bij,bjk->bik"}, RED),
    ("gather_nd", "GatherNd", lambda r: [_n(r, 4, 5, 2),
                                         np.array([[0, 1], [3, 4]], np.int32)],
     {}, EW),
    ("scatter_update", "ScatterUpdate", lambda r: [
        _n(r, 5, 3), np.array([1, 3], np.int32), _n(r, 2, 3)], {}, EW),
    ("scatter_add", "ScatterAdd", lambda r: [
        _n(r, 5, 3), np.array([1, 1, 4], np.int32), _n(r, 3, 3)], {}, EW),
    ("pad", "Pad", lambda r: [_n(r, 2, 3)], {"paddings": [[1, 0], [2, 1]]},
     EW),
    ("pad_value", "pad", lambda r: [_n(r, 2, 3)],
     {"paddings": [[1, 1], [0, 2]], "constant_values": 1.5}, EW),
    ("pad_reflect", "pad", lambda r: [_n(r, 3, 4)],
     {"paddings": [[2, 1], [3, 2]], "mode": "REFLECT"}, EW),
    ("pad_symmetric", "PadV2", lambda r: [_n(r, 3, 4)],
     {"paddings": [[2, 3], [1, 4]], "mode": "SYMMETRIC"}, EW),
    ("shape_of", "Shape", lambda r: [_n(r, 2, 5, 3)], {}, EW),
    ("size", "Size", lambda r: [_n(r, 2, 5)], {}, EW),
    ("rank", "Rank", lambda r: [_n(r, 2, 5)], {}, EW),
    ("cast_int", "Cast", lambda r: [_n(r, 6) * 3], {"dtype": "int32"}, EW),
    ("cast_f64", "cast", lambda r: [_ids(r, 9, 6)], {"dtype": "float64"},
     EW),
    ("cast_bool", "cast", lambda r: [_ids(r, 3, 6)], {"dtype": "bool"}, EW),
    ("identity", "Identity", lambda r: [_n(r, 3)], {}, EW),
    ("fill", "Fill", lambda r: [np.array([2, 3], np.int32),
                                np.float32(1.5)], {}, EW),
    ("zeros_like", "ZerosLike", lambda r: [_n(r, 2, 2)], {}, EW),
    ("ones_like", "OnesLike", lambda r: [_ids(r, 5, 2, 2)], {}, EW),
    ("linspace", "LinSpace", lambda r: [np.float32(-1.0), np.float32(2.0)],
     {"num": 7}, EW),
    ("range_int", "Range", lambda r: [np.int32(1), np.int32(11),
                                      np.int32(3)], {}, EW),
    ("range_float", "range", lambda r: [np.float32(0.5), np.float32(3.0),
                                        np.float32(0.5)], {}, EW),
    ("one_hot", "OneHot", lambda r: [np.array([0, 2, 5, 1], np.int32)],
     {"depth": 4, "on_value": 2.0, "off_value": -1.0}, EW),
    ("one_hot_axis0", "one_hot", lambda r: [np.array([[0, 2], [3, 1]],
                                                      np.int32)],
     {"depth": 4, "axis": 0, "dtype": "int32"}, EW),
    ("where", "SelectV2", lambda r: [_n(r, 3, 4) > 0, _n(r, 3, 4),
                                     _n(r, 4)], {}, EW),
    ("where_coords", "where", lambda r: [_n(r, 3, 4) > 0], {}, EW),
    ("broadcast_to", "BroadcastTo", lambda r: [_n(r, 1, 3)],
     {"shape": [4, 3]}, EW),
    ("space_to_depth", "SpaceToDepth", lambda r: [_n(r, 2, 4, 6, 3)],
     {"block_size": 2}, EW),
    ("depth_to_space", "DepthToSpace", lambda r: [_n(r, 2, 2, 3, 8)],
     {"block_size": 2}, EW),
] + [
    (name, name, lambda r: [_ids(r, 4, 9), _ids(r, 4, 9)], {}, EW)
    for name in ("equals", "not_equals", "greater", "greater_equal", "less",
                 "less_equal")
] + [
    (name, name, lambda r: [_n(r, 9) > 0, _n(r, 9) > 0], {}, EW)
    for name in ("boolean_and", "boolean_or", "boolean_xor")
] + [
    ("boolean_not", "LogicalNot", lambda r: [_n(r, 9) > 0], {}, EW),
    # linalg
    ("matmul", "MatMul", lambda r: [_n(r, 4, 3), _n(r, 3, 5)], {}, RED),
    ("matmul_t", "MatMul", lambda r: [_n(r, 2, 3, 4), _n(r, 2, 5, 4)],
     {"transpose_b": True}, RED),
    ("matmul_transA", "mmul", lambda r: [_n(r, 3, 4), _n(r, 3, 5)],
     {"transA": 1}, RED),
    ("matmul_vec", "matmul", lambda r: [_n(r, 4), _n(r, 4, 2)], {}, RED),
    ("batched_gemm", "BatchMatMulV2", lambda r: [_n(r, 2, 3, 4),
                                                 _n(r, 2, 4, 5)], {}, RED),
    ("tensordot", "tensordot", lambda r: [_n(r, 3, 4), _n(r, 4, 2)],
     {"axes": 1}, RED),
    ("tensordot_pairs", "tensormmul", lambda r: [_n(r, 3, 4, 2),
                                                 _n(r, 2, 4)],
     {"axes": [[1, 2], [1, 0]]}, RED),
    ("diag", "Diag", lambda r: [_n(r, 4)], {}, EW),
    ("diag_part", "DiagPart", lambda r: [_n(r, 4, 4)], {}, EW),
    ("matrix_inverse", "MatrixInverse", lambda r: [_spd(r, 4)], {}, RED),
    ("matrix_determinant", "MatrixDeterminant", lambda r: [_spd(r, 3) / 3],
     {}, RED),
    ("cholesky", "Cholesky", lambda r: [_spd(r, 4)], {}, RED),
    ("trace", "Trace", lambda r: [_n(r, 4, 4)], {}, RED),
    ("lstsq", "lstsq", lambda r: [_n(r, 6, 3), _n(r, 6, 2)], {},
     dict(atol=1e-4, rtol=1e-4)),
    ("triangular_solve", "triangular_solve", lambda r: [_tri(r, 4),
                                                        _n(r, 4, 2)],
     {"lower": True}, RED),
    ("solve", "MatrixSolve", lambda r: [_spd(r, 4), _n(r, 4, 2)], {}, RED),
    ("matrix_band_part", "MatrixBandPart", lambda r: [_n(r, 5, 5)],
     {"lower": 1, "upper": -1}, EW),
    # convolutions and pooling (NHWC / HWIO)
    ("conv1d", "Conv1D", lambda r: [_n(r, 2, 9, 3), _n(r, 3, 3, 4)],
     {"stride": 2, "padding": "SAME"}, RED),
    ("conv2d", "Conv2D", lambda r: [_n(r, 2, 7, 7, 3), _n(r, 3, 3, 3, 4),
                                    _n(r, 4)],
     {"strides": (2, 2), "padding": "SAME"}, RED),
    ("conv2d_dilated", "conv2d", lambda r: [_n(r, 1, 9, 9, 2),
                                            _n(r, 3, 3, 2, 3)],
     {"padding": "VALID", "dilation": (2, 2)}, RED),
    ("conv2d_groups", "conv2d", lambda r: [_n(r, 1, 6, 6, 4),
                                           _n(r, 3, 3, 2, 6)],
     {"padding": "SAME", "groups": 2}, RED),
    ("conv2d_nchw", "conv2d_nchw", lambda r: [_n(r, 2, 3, 7, 7),
                                              _n(r, 4, 3, 3, 3), _n(r, 4)],
     {"strides": (2, 2), "padding": ((1, 0), (1, 1))}, RED),
    ("maxpool2d_nchw", "maxpool2d_nchw", lambda r: [_n(r, 1, 2, 7, 7)],
     {"kernel": (3, 3), "strides": (2, 2), "padding": ((1, 1), (1, 1))}, EW),
    ("avgpool2d_nchw", "avgpool2d_nchw", lambda r: [_n(r, 1, 2, 7, 7)],
     {"kernel": (3, 3), "strides": (2, 2), "padding": ((1, 1), (1, 1))},
     RED),
    ("avgpool2d_nchw_incl", "avgpool2d_nchw", lambda r: [_n(r, 1, 2, 6, 6)],
     {"kernel": (2, 2), "strides": (2, 2), "padding": ((0, 1), (0, 1)),
      "count_include_pad": True}, RED),
    ("global_avgpool_nchw", "global_avgpool_nchw",
     lambda r: [_n(r, 2, 3, 4, 4)], {}, RED),
    ("batchnorm_nchw", "batchnorm_nchw", lambda r: [
        _n(r, 2, 3, 4, 4), _n(r, 3), _n(r, 3), _n(r, 3),
        _u(r, 3, lo=0.5, hi=2)], {"epsilon": 1e-3}, RED),
    ("conv3d", "Conv3D", lambda r: [_n(r, 1, 5, 5, 5, 2),
                                    _n(r, 3, 3, 3, 2, 3)],
     {"strides": (2, 2, 2), "padding": "SAME"}, RED),
    ("depthwise_conv2d", "DepthwiseConv2dNative",
     lambda r: [_n(r, 1, 6, 6, 3), _n(r, 3, 3, 3, 2)],
     {"strides": (1, 1), "padding": "SAME"}, RED),
    ("deconv2d", "Conv2DTranspose", lambda r: [_n(r, 1, 4, 4, 3),
                                               _n(r, 3, 3, 3, 2)],
     {"strides": (2, 2), "padding": "SAME"}, RED),
    ("deconv2d_valid_tk", "deconv2d", lambda r: [_n(r, 1, 4, 4, 2),
                                                 _n(r, 3, 3, 3, 2), _n(r, 3)],
     {"strides": (2, 2), "padding": "VALID", "transpose_kernel": True}, RED),
    ("maxpool2d", "MaxPool", lambda r: [_n(r, 2, 7, 7, 3)],
     {"kernel": (3, 3), "strides": (2, 2), "padding": "SAME"}, EW),
    ("avgpool2d", "AvgPool", lambda r: [_n(r, 2, 7, 7, 3)],
     {"kernel": (3, 3), "strides": (2, 2), "padding": "SAME"}, RED),
    ("pnormpool2d", "pnormpool2d", lambda r: [_n(r, 1, 6, 6, 2)],
     {"kernel": (2, 2), "pnorm": 3}, RED),
    ("maxpool3d", "MaxPool3D", lambda r: [_n(r, 1, 4, 4, 4, 2)], {}, EW),
    ("avgpool3d", "AvgPool3D", lambda r: [_n(r, 1, 5, 5, 5, 2)],
     {"kernel": (3, 3, 3), "strides": (2, 2, 2), "padding": "SAME"}, RED),
    ("global_avgpool2d", "global_avgpool2d", lambda r: [_n(r, 2, 4, 4, 3)],
     {}, RED),
    ("upsampling2d", "upsampling2d", lambda r: [_n(r, 1, 3, 2, 2)],
     {"size": 2}, EW),
    ("resize_bilinear", "ResizeBilinear", lambda r: [_n(r, 1, 4, 6, 2)],
     {"size": (7, 3)}, RED),
    ("im2col", "im2col", lambda r: [_n(r, 1, 5, 5, 2)],
     {"kernel": (3, 3), "strides": (2, 2), "padding": "SAME"}, EW),
    # normalization
    ("batchnorm", "FusedBatchNormV3", lambda r: [
        _n(r, 2, 3, 4), _n(r, 4), _u(r, 4, lo=0.5, hi=2), _n(r, 4),
        _n(r, 4)], {"epsilon": 1e-3}, RED),
    ("batchnorm_axis1", "batchnorm", lambda r: [
        _n(r, 2, 3, 4), _n(r, 3), _u(r, 3, lo=0.5, hi=2)], {"axis": 1}, RED),
    ("layer_norm", "LayerNorm", lambda r: [_n(r, 3, 8), _n(r, 8), _n(r, 8)],
     {}, RED),
    ("lrn", "LRN", lambda r: [_n(r, 1, 2, 2, 7)],
     {"depth_radius": 2, "bias": 1.0, "alpha": 0.5, "beta": 0.75}, RED),
    ("standardize", "standardize", lambda r: [_n(r, 3, 8)], {}, RED),
    ("l2_normalize", "L2Normalize", lambda r: [_n(r, 3, 8)], {"axis": 1},
     RED),
    # losses
    ("softmax_cross_entropy", "softmax_cross_entropy", lambda r: [
        _n(r, 4, 5), np.eye(5, dtype=np.float32)[[0, 3, 1, 4]]], {}, RED),
    ("sparse_softmax_cross_entropy", "SparseSoftmaxCrossEntropyWithLogits",
     lambda r: [_n(r, 4, 5), np.array([0, 3, 1, 4], np.int32)], {}, RED),
    ("sigmoid_cross_entropy", "sigmoid_cross_entropy",
     lambda r: [_n(r, 4, 5), (_n(r, 4, 5) > 0).astype(np.float32)], {}, EW),
    # recurrent cells
    ("lstm_cell", "lstm_cell", lambda r: [
        _n(r, 2, 3), _n(r, 2, 4), _n(r, 2, 4), _n(r, 7, 16) * 0.3,
        _n(r, 16)], {"forget_bias": 1.0}, RED),
    ("gru_cell", "GRUCell", lambda r: [
        _n(r, 2, 3), _n(r, 2, 4), _n(r, 7, 8) * 0.3, _n(r, 7, 4) * 0.3,
        _n(r, 8), _n(r, 4)], {}, RED),
    ("sru_cell", "sru_cell", lambda r: [
        _n(r, 2, 4), _n(r, 2, 4), _n(r, 4, 12) * 0.3, _n(r, 8)], {}, RED),
    # attention (the CPU runs the kernels' plain versions)
    ("attention", "dot_product_attention", lambda r: [
        _n(r, 2, 2, 5, 8), _n(r, 2, 2, 6, 8), _n(r, 2, 2, 6, 8)], {}, RED),
    ("attention_key_mask", "MultiHeadDotProductAttention", lambda r: [
        _n(r, 2, 2, 6, 8), _n(r, 2, 2, 6, 8), _n(r, 2, 2, 6, 8),
        np.arange(6)[None, None, None, :] < np.array([3, 6])[:, None, None,
                                                           None]],
     {"scaled": False}, RED),
    ("attention_query_mask", "dot_product_attention", lambda r: [
        _n(r, 1, 2, 4, 6), _n(r, 1, 2, 4, 6), _n(r, 1, 2, 4, 6),
        np.tril(np.ones((4, 4), bool))], {}, RED),
    # image / misc
    ("non_max_suppression", "NonMaxSuppressionV3", lambda r: [
        np.array([[0, 0, 1, 1], [0, 0.1, 1, 1.1], [0, 2, 1, 3],
                  [0.05, 0, 1, 1], [5, 5, 6, 6]], np.float32),
        np.array([0.9, 0.8, 0.7, 0.95, 0.1], np.float32)],
     {"max_output_size": 4, "iou_threshold": 0.5, "score_threshold": 0.05},
     EW),
    ("confusion_matrix", "ConfusionMatrix", lambda r: [
        _ids(r, 4, 20), _ids(r, 4, 20)], {"num_classes": 4}, EW),
    ("top_k", "TopKV2", lambda r: [_n(r, 3, 7)], {"k": 3}, EW),
    ("in_top_k", "InTopKV2", lambda r: [_n(r, 4, 7),
                                        np.array([0, 3, 6, 2], np.int32)],
     {"k": 2}, EW),
    ("segment_sum", "SegmentSum", lambda r: [
        _n(r, 6, 3), np.array([0, 0, 1, 2, 2, 2], np.int32)], {}, RED),
    ("segment_sum_n", "segment_sum", lambda r: [
        _n(r, 4, 2), np.array([0, 1, 1, 3], np.int32)],
     {"num_segments": 5}, RED),
    ("sequence_mask", "SequenceMask", lambda r: [
        np.array([1, 3, 0, 4], np.int32)], {"maxlen": 5}, EW),
    ("reverse_sequence", "ReverseSequence", lambda r: [
        _n(r, 3, 5, 2), np.array([2, 5, 0], np.int32)], {}, EW),
    ("reverse_sequence_axes", "reverse_sequence", lambda r: [
        _n(r, 5, 3), np.array([3, 1, 4], np.int32)],
     {"seq_axis": 0, "batch_axis": 1}, EW),
    ("encode_threshold", "encode_threshold", lambda r: [_n(r, 4, 3) * 1e-3],
     {"threshold": 1e-3}, EW),
    ("decode_threshold", "decode_threshold", lambda r: [
        (r.integers(-1, 2, 12)).astype(np.int8)],
     {"threshold": 0.5, "shape": [3, 4]}, EW),
]


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _jax_np(x):
    return np.asarray(x)


def _torch_np(x):
    return x.detach().cpu().numpy()


def _run(name, inputs, attrs):
    j = JR.exec_op(name, *[jnp.asarray(x) for x in inputs], **attrs)
    t = TR.exec_op(name, *[TD.as_tensor(x) for x in inputs], **attrs)
    return _flat(j), _flat(t)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(case):
    cid, name, make, attrs, tol = case
    inputs = make(np.random.default_rng(zlib.crc32(cid.encode())))
    j_out, t_out = _run(name, inputs, attrs)
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        a, b = _jax_np(a), _torch_np(b)
        assert a.shape == b.shape, (cid, a.shape, b.shape)
        assert np.dtype(a.dtype).name == TD.name_of(
            TD.to_torch(b.dtype)), (cid, a.dtype, b.dtype)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, equal_nan=True, **tol)
        else:
            np.testing.assert_array_equal(b, a)


def test_qr_svd_hold_what_is_defined():
    rng = np.random.default_rng(1)
    x = _n(rng, 5, 3)
    q, r = TR.exec_op("Qr", torch.as_tensor(x))
    np.testing.assert_allclose((q @ r).numpy(), x, atol=1e-5)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(3), atol=1e-5)
    jq, jr = JR.exec_op("qr", jnp.asarray(x))
    np.testing.assert_allclose(np.abs(r.numpy()), np.abs(np.asarray(jr)),
                               atol=1e-5)
    u, s, vh = TR.exec_op("Svd", torch.as_tensor(x))
    ju, js, jvh = JR.exec_op("svd", jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose((u * s) @ vh, x, atol=1e-5)
    assert tuple(u.shape) == np.asarray(ju).shape
    assert tuple(vh.shape) == np.asarray(jvh).shape


@pytest.mark.parametrize("name, attrs, shape", [
    ("random_normal", {"shape": [4000], "mean": 1.0, "stddev": 2.0},
     (4000,)),
    ("random_uniform", {"shape": [50, 80], "minval": -1.0, "maxval": 3.0},
     (50, 80)),
    ("random_bernoulli", {"shape": [4000], "p": 0.3}, (4000,)),
])
def test_random_ops_hold_shapes_and_moments(name, attrs, shape):
    j = np.asarray(JR.exec_op(name, jax.random.key(0), **attrs))
    t = TR.exec_op(name, torch.Generator().manual_seed(0), **attrs).numpy()
    assert j.shape == t.shape == shape
    assert j.dtype == t.dtype == np.float32
    np.testing.assert_allclose(t.mean(), j.mean(), atol=0.1)
    np.testing.assert_allclose(t.std(), j.std(), rtol=0.1)


@pytest.mark.parametrize("name, attr, keep", [
    ("dropout", {"rate": 0.25}, 0.75), ("dropout_inverted", {"p": 0.6}, 0.6)])
def test_dropout_ops_scale_kept_entries(name, attr, keep):
    x = np.full((100, 100), 2.0, np.float32)
    t = TR.exec_op(name, torch.as_tensor(x), torch.Generator().manual_seed(3),
                   **attr).numpy()
    j = np.asarray(JR.exec_op(name, jnp.asarray(x), jax.random.key(3),
                              **attr))
    for out in (t, j):
        kept = out != 0
        np.testing.assert_allclose(out[kept], 2.0 / keep, rtol=1e-6)
        assert abs(kept.mean() - keep) < 0.03


def _reference_standard_names():
    """Every name and alias the reference's ops/standard.py registers,
    read from its source."""
    tree = ast.parse((ROOT / "deeplearning4j_tpu/ops/standard.py")
                     .read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "register" and node.args and isinstance(
                    node.args[0], ast.Constant):
            names.add(node.args[0].value)
            for kw in node.keywords:
                if kw.arg == "aliases":
                    names.update(e.value for e in kw.value.elts)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.List):
            for elt in node.iter.elts:
                if isinstance(elt, ast.Tuple) and isinstance(
                        elt.elts[0], ast.Constant):
                    names.add(elt.elts[0].value)
                    names.update(e.value for e in elt.elts[2].elts)
    return names


def test_every_reference_standard_name_resolves_alike():
    """Each name resolves to the op it means in the reference's registry
    (with its later modules loaded): the names its later modules rebind
    (LSTMBlockCell, ResizeNearestNeighbor, SoftmaxCrossEntropyWithLogits)
    to the later ops in both."""
    names = _reference_standard_names()
    assert len(names) > 300
    for n in sorted(names):
        assert TR.has(n), n
        assert TR.get(n).name == JR.get(n).name, n
        assert TR.get(n).num_outputs == JR.get(n).num_outputs, n
    for n, later in [("LSTMBlockCell", "lstm_block_cell"),
                     ("ResizeNearestNeighbor", "resize_nearest_neighbor"),
                     ("SoftmaxCrossEntropyWithLogits",
                      "softmax_cross_entropy_with_logits")]:
        assert TR.get(n).name == JR.get(n).name == later
    swept = {c[1] for c in CASES}
    canon = {TR.get(n).name for n in names} & {
        TR.get(n).name for n in names if TR.get(n).name in _standard_ops()}
    untested = canon - {TR.get(n).name for n in swept} - {
        "qr", "svd", "random_normal", "random_uniform", "random_bernoulli",
        "dropout", "dropout_inverted"}
    assert not untested, sorted(untested)


def _standard_ops():
    """The canonical names ``ops/standard.py``'s own registrations give."""
    tree = ast.parse((ROOT / "deeplearning4j_tpu/ops/standard.py")
                     .read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "register" and node.args and isinstance(
                    node.args[0], ast.Constant):
            out.add(node.args[0].value)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.List):
            for elt in node.iter.elts:
                if isinstance(elt, ast.Tuple) and isinstance(
                        elt.elts[0], ast.Constant):
                    out.add(elt.elts[0].value)
    return out


def test_alias_collision_rule():
    TR.alias("relu", "relu_alias_for_test")
    try:
        assert TR.get("relu_alias_for_test") is TR.get("relu")
        TR.alias("relu", "relu_alias_for_test")        # same op: fine
        with pytest.raises(ValueError, match="already bound"):
            TR.alias("sigmoid", "relu_alias_for_test")
    finally:
        del TR._REGISTRY["relu_alias_for_test"]
    with pytest.raises(KeyError, match="Unknown op"):
        TR.get("no_such_op")


def test_infer_shape_matches_eval_shape():
    for name, shapes, attrs in [
            ("matmul", [(4, 3), (3, 5)], {}),
            ("reduce_sum", [(2, 3, 4)], {"axis": (0, 2)}),
            ("conv2d", [(2, 7, 7, 3), (3, 3, 3, 4)], {"strides": (2, 2)}),
            ("argmax", [(4, 6)], {"axis": 1}),
            ("less", [(3,), (3,)], {})]:
        ins = [np.zeros(s, np.float32) for s in shapes]
        j = jax.eval_shape(lambda *a: JR.get(name)(*a, **attrs), *ins)
        t = TR.infer_shape(name, *[torch.as_tensor(x) for x in ins],
                           **attrs)
        assert t.device.type == "meta"
        assert tuple(t.shape) == j.shape
        assert TD.name_of(t.dtype) == np.dtype(j.dtype).name


def test_platform_override_and_toggle():
    calls = []
    TR.register("op_with_override_for_test", lambda x: x + 1)
    try:
        TR.register_platform("op_with_override_for_test",
                             lambda x: calls.append(1) or x + 1)
        x = torch.zeros(2)
        TR.exec_op("op_with_override_for_test", x)
        assert calls == [1]
        TR.set_platform_overrides(False)
        TR.exec_op("op_with_override_for_test", x)
        assert calls == [1]
    finally:
        TR.set_platform_overrides(True)
        del TR._REGISTRY["op_with_override_for_test"]
