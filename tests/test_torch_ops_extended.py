"""The port's ``ops/extended.py`` against the JAX package's, on the CPU:
its elementwise tail, special functions, absolute-value reductions and
shape and index sections (``test_torch_ops_extended_tail`` sweeps the
rest). One parametrised sweep runs each op in both registries on the
same seeded numpy inputs (``_torch_ops_parity``, whose docstring states
the tolerances).
"""
import numpy as np
import pytest

from _torch_ops_parity import (EW, RED, SPECIAL, case_ids, check_case, ids,
                               n, u)

CASES = [
    (nm, nm, lambda r, lo=lo, hi=hi: [u(r, 3, 4, lo=lo, hi=hi)], {}, tol)
    for nm, lo, hi, tol in [
        ("expm1", -2, 2, EW), ("log2", 0.1, 4, EW), ("log10", 0.1, 4, EW),
        ("rint", -4, 4, EW), ("trunc", -4, 4, EW), ("lgamma", 0.2, 5, RED),
        ("digamma", 0.2, 5, RED), ("erfinv", -0.9, 0.9, RED),
        ("sigmoid_derivative", -4, 4, EW), ("tanh_derivative", -3, 3, EW)]
] + [
    ("rint_halves", "Rint", lambda r: [np.array([-2.5, -1.5, -0.5, 0.5, 1.5,
                                                 2.5], np.float32)], {}, EW),
    ("log2_int", "Log2", lambda r: [ids(r, 9, 5) + 1], {}, EW),
    ("atan2", "Atan2", lambda r: [n(r, 6), n(r, 6)], {}, EW),
    ("hypot", "hypot", lambda r: [n(r, 6), n(r, 6)], {}, EW),
    ("rsub", "RSub", lambda r: [n(r, 3, 2), n(r, 2)], {}, EW),
    ("rdiv", "RDiv", lambda r: [u(r, 5, lo=0.5, hi=2), n(r, 5)], {}, EW),
    ("divide_no_nan", "DivNoNan", lambda r: [
        n(r, 6), np.array([1, 0, 2, 0, -1, 3], np.float32)], {}, EW),
    ("igamma", "Igamma", lambda r: [u(r, 6, lo=0.5, hi=3),
                                    u(r, 6, lo=0.1, hi=4)], {}, RED),
    ("igammac", "Igammac", lambda r: [u(r, 6, lo=0.5, hi=3),
                                      u(r, 6, lo=0.1, hi=4)], {}, RED),
    ("betainc", "Betainc", lambda r: [
        u(r, 8, lo=0.5, hi=5), u(r, 8, lo=0.5, hi=5),
        np.array([0.0, 0.05, 0.2, 0.4, 0.5, 0.7, 0.95, 1.0], np.float32)],
     {}, SPECIAL),
    ("polygamma", "Polygamma", lambda r: [
        np.array([0, 1, 2, 3, 1, 0], np.int32), u(r, 6, lo=0.5, hi=4)], {},
     SPECIAL),
    ("isclose", "ApproxEquals", lambda r: [
        np.array([1.0, 2.0, 3.0, np.nan], np.float32),
        np.array([1.0, 2.001, 3.0 + 1e-6, np.nan], np.float32)],
     {"rtol": 1e-5, "atol": 1e-8}, EW),
    ("is_non_decreasing", "IsNonDecreasing", lambda r: [
        np.array([[1, 2], [2, 5]], np.float32)], {}, EW),
    ("is_strictly_increasing", "IsStrictlyIncreasing", lambda r: [
        np.array([1, 2, 2, 5], np.float32)], {}, EW),
    # absolute-value reductions
    ("reduce_amax", "amax", lambda r: [n(r, 3, 4)], {"axis": 1}, EW),
    ("reduce_amin", "reduce_amin", lambda r: [n(r, 3, 4)],
     {"axis": 0, "keepdims": True}, EW),
    ("reduce_amean", "amean", lambda r: [n(r, 3, 4)], {}, RED),
    ("reduce_asum", "asum", lambda r: [n(r, 3, 4)], {"axis": (0, 1)}, RED),
    ("count_nonzero", "CountNonZero", lambda r: [
        ids(r, 3, 4, 5)], {"axis": 1, "keepdims": True}, EW),
    ("count_zero", "CountZero", lambda r: [ids(r, 3, 4, 5)], {}, EW),
    ("zero_fraction", "ZeroFraction", lambda r: [ids(r, 3, 4, 5)], {}, EW),
    ("argamax", "absargmax", lambda r: [n(r, 4, 5)], {"axis": 1}, EW),
    ("argamin", "absargmin", lambda r: [n(r, 4, 5)], {}, EW),
    ("entropy", "Entropy", lambda r: [
        np.array([[0.2, 0.8, 0.0], [0.5, 0.25, 0.25]], np.float32)],
     {"axis": 1}, RED),
    ("log_entropy", "LogEntropy", lambda r: [
        np.array([0.2, 0.3, 0.5], np.float32)], {}, RED),
    ("shannon_entropy", "ShannonEntropy", lambda r: [
        np.array([0.2, 0.3, 0.5, 0.0], np.float32)], {}, RED),
    ("moments", "Moments", lambda r: [n(r, 4, 6) + 2], {"axes": [0]}, RED),
    ("moments_int", "moments", lambda r: [ids(r, 3, 4, 6)],
     {"axes": [0, 1], "keepdims": True}, RED),
    ("normalize_moments", "NormalizeMoments", lambda r: [
        np.float32(8.0), n(r, 3) * 8, u(r, 3, lo=8, hi=20)],
     {"shift": 0.5}, RED),
    ("reduce_dot", "dot", lambda r: [n(r, 3, 4), n(r, 3, 4)], {"axis": 1},
     RED),
    ("cosine_similarity", "CosineSimilarity", lambda r: [
        n(r, 3, 4), n(r, 3, 4)], {}, RED),
    ("cosine_distance", "CosineDistance", lambda r: [
        n(r, 3, 4), n(r, 3, 4)], {"axis": 0}, RED),
    ("euclidean_distance", "EuclideanDistance", lambda r: [
        n(r, 3, 4), n(r, 3, 4)], {}, RED),
    ("manhattan_distance", "ManhattanDistance", lambda r: [
        n(r, 3, 4), n(r, 3, 4)], {}, RED),
    ("hamming_distance", "HammingDistance", lambda r: [
        ids(r, 2, 3, 4), ids(r, 2, 3, 4)], {"axis": 1}, EW),
    ("jaccard_distance", "JaccardDistance", lambda r: [
        u(r, 3, 4, lo=0, hi=1), u(r, 3, 4, lo=0, hi=1)], {}, RED),
    # shape / index
    ("eye", "Eye", lambda r: [], {"n": 3, "m": 4}, EW),
    ("eye_int", "eye", lambda r: [], {"n": 3, "dtype": "int32"}, EW),
    ("repeat", "Repeat", lambda r: [n(r, 2, 3)],
     {"repeats": 2, "axis": 1}, EW),
    ("repeat_flat", "repeat", lambda r: [n(r, 2, 3)], {"repeats": 3}, EW),
    ("roll", "Roll", lambda r: [n(r, 3, 4)], {"shift": 2, "axis": 1}, EW),
    ("roll_flat", "roll", lambda r: [n(r, 3, 4)], {"shift": -5}, EW),
    ("rot90", "rot90", lambda r: [n(r, 3, 4, 2)], {"k": 3}, EW),
    ("invert_permutation", "InvertPermutation", lambda r: [
        np.array([3, 0, 4, 1, 2], np.int32)], {}, EW),
    ("meshgrid", "Meshgrid", lambda r: [n(r, 3), n(r, 2)], {}, EW),
    ("meshgrid_ij", "meshgrid", lambda r: [n(r, 3), n(r, 2)],
     {"indexing": "ij"}, EW),
    ("size_at", "SizeAt", lambda r: [n(r, 3, 5)], {"dim": 1}, EW),
    ("searchsorted", "SearchSorted", lambda r: [
        np.array([0.0, 1.0, 1.0, 3.0], np.float32),
        np.array([-1.0, 1.0, 2.0, 5.0], np.float32)], {}, EW),
    ("searchsorted_right", "searchsorted", lambda r: [
        np.array([0.0, 1.0, 1.0, 3.0], np.float32),
        np.array([-1.0, 1.0, 2.0, 5.0], np.float32)], {"side": "right"}, EW),
    ("bincount", "Bincount", lambda r: [ids(r, 6, 20)], {"minlength": 8},
     EW),
    ("bincount_weights", "bincount", lambda r: [ids(r, 6, 20), n(r, 20)],
     {"length": 4}, RED),
    ("histogram_fixed_width", "HistogramFixedWidth", lambda r: [
        n(r, 30) * 2, np.array([-2.0, 2.0], np.float32)], {"nbins": 6}, EW),
    ("unique", "Unique", lambda r: [ids(r, 5, 12)], {}, EW),
    ("unique_size", "unique", lambda r: [ids(r, 5, 12)], {"size": 7}, EW),
    ("unique_with_counts", "UniqueWithCounts", lambda r: [ids(r, 5, 3, 4)],
     {}, EW),
    ("listdiff", "ListDiff", lambda r: [
        np.array([1, 2, 3, 4, 5, 2], np.int32), np.array([2, 5], np.int32)],
     {}, EW),
    ("dynamic_partition", "DynamicPartition", lambda r: [
        n(r, 6, 2), np.array([0, 2, 1, 0, 2, 2], np.int32)],
     {"num_partitions": 3}, EW),
    ("dynamic_stitch", "DynamicStitch", lambda r: [
        [np.array([0, 2], np.int32), np.array([1, 3, 4], np.int32)],
        [n(r, 2, 3), n(r, 3, 3)]], {}, EW),
]


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_op_matches_reference(case):
    check_case(case)
