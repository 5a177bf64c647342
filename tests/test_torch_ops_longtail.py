"""The port's ``ops/longtail.py`` against the JAX package's, on the CPU:
its reshuffles, merge ops, unsorted segments, quantization, losses, misc
math, colour and image sections (``test_torch_ops_longtail_seq`` sweeps
the rest). One parametrised sweep runs each op in both registries on the
same seeded numpy inputs (``_torch_ops_parity`` states the tolerances).
``random_crop`` draws its starts from another generator than the
reference's key, so it is held by what a crop is.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _torch_ops_parity import (EW, RED, SPECIAL, case_ids, check_case, ids,
                               n, u)
from deeplearning4j_tpu.ops import registry as JR
from deeplearning4j_tpu_torch.ops import registry as TR


CASES = [
    ("space_to_batch", "SpaceToBatch", lambda r: [n(r, 1, 4, 6, 2)],
     {"block_size": 2, "paddings": ((0, 0), (1, 1))}, EW),
    ("batch_to_space", "BatchToSpace", lambda r: [n(r, 4, 2, 3, 2)],
     {"block_size": 2, "crops": ((0, 1), (1, 0))}, EW),
    ("space_to_batch_nd", "SpaceToBatchND", lambda r: [n(r, 2, 4, 6, 3)],
     {"block_shape": [2, 3], "paddings": [[0, 0], [0, 0]]}, EW),
    ("batch_to_space_nd", "BatchToSpaceND", lambda r: [n(r, 6, 2, 2, 1)],
     {"block_shape": [3, 2], "crops": [[1, 0], [0, 1]]}, EW),
    ("mirror_pad", "MirrorPad", lambda r: [n(r, 3, 4)],
     {"paddings": [[1, 2], [2, 1]]}, EW),
    ("mirror_pad_sym", "mirror_pad", lambda r: [n(r, 3, 4)],
     {"paddings": [[2, 1], [0, 3]], "mode": "SYMMETRIC"}, EW),
    ("col2im", "col2im", lambda r: [n(r, 1, 3, 3, 2 * 2 * 2)],
     {"kernel": (2, 2), "out_hw": (6, 6), "strides": (2, 2)}, RED),
    ("col2im_same", "col2im", lambda r: [n(r, 1, 3, 3, 3 * 3 * 2)],
     {"kernel": (3, 3), "out_hw": (5, 5), "strides": (2, 2),
      "padding": "SAME"}, RED),
    ("dilation2d", "Dilation2D", lambda r: [n(r, 1, 6, 7, 2), n(r, 3, 2, 2)],
     {"strides": (1, 2), "rates": (2, 1)}, EW),
    ("dilation2d_valid", "dilation2d", lambda r: [n(r, 1, 6, 7, 2),
                                                  n(r, 2, 3, 2)],
     {"padding": "VALID"}, EW),
    ("maxpool_with_argmax", "MaxPoolWithArgmax", lambda r: [
        n(r, 2, 5, 6, 3)], {"kernel": (2, 2)}, EW),
    ("maxpool_with_argmax_same", "max_pool_with_argmax", lambda r: [
        n(r, 1, 5, 5, 2)], {"kernel": (3, 3), "strides": (2, 2),
                            "padding": "SAME"}, EW),
    ("upsampling3d", "Upsampling3D", lambda r: [n(r, 1, 2, 2, 3, 2)],
     {"scale": 2}, EW),
    ("deconv3d", "DeConv3D", lambda r: [n(r, 1, 3, 3, 3, 2),
                                        n(r, 2, 2, 2, 2, 3)],
     {"strides": (2, 2, 2)}, RED),
    ("deconv3d_valid", "Conv3DTranspose", lambda r: [
        n(r, 1, 3, 3, 3, 2), n(r, 3, 3, 3, 2, 2), n(r, 2)],
     {"strides": (2, 1, 2), "padding": "VALID"}, RED),
    ("sconv2d", "SeparableConv2D", lambda r: [
        n(r, 1, 6, 6, 3), n(r, 3, 3, 3, 2), n(r, 1, 1, 6, 4), n(r, 4)],
     {"strides": (2, 2)}, RED),
    ("pointwise_conv2d", "PointwiseConv2D", lambda r: [
        n(r, 1, 4, 4, 3), n(r, 1, 1, 3, 5)], {}, RED),
    ("mergeadd", "MergeAdd", lambda r: [n(r, 3), n(r, 3), n(r, 3)], {}, EW),
    ("mergeavg", "MergeAvg", lambda r: [n(r, 3), n(r, 3)], {}, EW),
    ("mergemax", "MergeMax", lambda r: [n(r, 3), n(r, 3), n(r, 3)], {}, EW),
    ("mergemaxindex", "MergeMaxIndex", lambda r: [n(r, 4), n(r, 4)], {},
     EW),
    ("unsorted_segment_sum", "UnsortedSegmentSum", lambda r: [
        n(r, 6, 2), np.array([2, 0, 2, 1, 2, 0], np.int32)],
     {"num_segments": 4}, RED),
    ("unsorted_segment_max", "UnsortedSegmentMax", lambda r: [
        n(r, 6, 2), np.array([2, 0, 2, 1, 2, 0], np.int32)],
     {"num_segments": 4}, EW),
    ("unsorted_segment_min", "UnsortedSegmentMin", lambda r: [
        ids(r, 50, 6), np.array([2, 0, 2, 1, 2, 0], np.int32)],
     {"num_segments": 4}, EW),
    ("unsorted_segment_prod", "UnsortedSegmentProd", lambda r: [
        n(r, 6), np.array([2, 0, 2, 1, 2, 0], np.int32)],
     {"num_segments": 4}, RED),
    ("unsorted_segment_mean", "UnsortedSegmentMean", lambda r: [
        n(r, 6, 2), np.array([2, 0, 2, 1, 2, 0], np.int32)],
     {"num_segments": 4}, RED),
    ("fake_quant_args", "FakeQuantWithMinMaxArgs", lambda r: [n(r, 12) * 3],
     {"min": -2.5, "max": 3.0, "num_bits": 4}, EW),
    ("fake_quant_vars", "FakeQuantWithMinMaxVarsPerChannel", lambda r: [
        n(r, 4, 3) * 3, np.array([-1.0, -2.0, -6.0], np.float32),
        np.array([1.0, 3.0, 6.0], np.float32)], {"narrow_range": True}, EW),
    ("compare_and_bitpack", "CompareAndBitpack", lambda r: [n(r, 3, 16)],
     {"threshold": 0.1}, EW),
    ("l2_loss", "L2Loss", lambda r: [n(r, 3, 4)], {}, RED),
    ("log_poisson_loss", "LogPoissonLoss", lambda r: [
        n(r, 6), u(r, 6, lo=0, hi=4)], {"full": True}, RED),
    ("mean_pairwssqerr_loss", "MeanPairwsSqErrLoss", lambda r: [
        n(r, 3, 4), n(r, 3, 4)], {}, RED),
    ("log_sigmoid", "LogSigmoid", lambda r: [n(r, 6) * 3], {}, EW),
    ("crelu", "CRelu", lambda r: [n(r, 2, 3)], {}, EW),
    ("axpy", "Axpy", lambda r: [n(r, 4), n(r, 4)], {"a": 2.5}, EW),
    ("assign", "Assign", lambda r: [n(r, 2, 3), n(r, 3)], {}, EW),
    ("zeta", "Zeta", lambda r: [u(r, 6, lo=1.5, hi=5), u(r, 6, lo=0.5, hi=3)],
     {}, SPECIAL),
    ("percentile", "Percentile", lambda r: [n(r, 5, 7)],
     {"q": 30.0, "axis": 1}, RED),
    ("percentile_lower", "percentile", lambda r: [n(r, 20)],
     {"q": 75.0, "interpolation": "lower"}, EW),
    ("nth_element", "NthElement", lambda r: [n(r, 3, 6)], {"n": 2}, EW),
    ("nth_element_rev", "nth_element", lambda r: [n(r, 3, 6)],
     {"n": 1, "reverse": True}, EW),
    ("clip_by_global_norm", "ClipByGlobalNorm", lambda r: [
        n(r, 3, 4), n(r, 5)], {"clip_norm": 1.5}, RED),
    ("clip_by_avg_norm", "ClipByAvgNorm", lambda r: [n(r, 3, 4)],
     {"clip_norm": 0.1}, RED),
    ("choose", "Choose", lambda r: [n(r, 3, 4)], {"scalar": 0.2, "mode": 1},
     EW),
    ("rgb_to_yiq", "RgbToYiq", lambda r: [u(r, 2, 3, 3, lo=0, hi=1)], {},
     RED),
    ("yiq_to_rgb", "YiqToRgb", lambda r: [u(r, 2, 3, 3, lo=0, hi=1)], {},
     RED),
    ("draw_bounding_boxes", "DrawBoundingBoxes", lambda r: [
        n(r, 2, 8, 9, 3),
        np.array([[[0.1, 0.2, 0.6, 0.7], [0.0, 0.0, 1.0, 1.0]],
                  [[0.3, 0.3, 0.5, 0.9], [0.2, 0.1, 0.4, 0.3]]], np.float32),
        u(r, 2, 3)], {}, EW),
    ("non_max_suppression_overlaps", "NonMaxSuppressionWithOverlaps",
     lambda r: [u(r, 6, 6, lo=0, hi=1),
                np.array([0.9, 0.1, 0.8, 0.7, 0.3, 0.95], np.float32)],
     {"max_output_size": 4, "overlap_threshold": 0.5,
      "score_threshold": 0.2}, EW),

]


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_op_matches_reference(case):
    check_case(case)


def test_random_crop_is_a_window_of_its_input():
    x = np.arange(60, dtype=np.float32).reshape(6, 10)
    t = TR.exec_op("RandomCrop", torch.as_tensor(x), size=(3, 4),
                   seed=7).numpy()
    j = np.asarray(JR.exec_op("random_crop", jnp.asarray(x), size=(3, 4),
                              seed=7))
    for out in (t, j):
        assert out.shape == (3, 4)
        r0, c0 = divmod(int(out[0, 0]), 10)
        np.testing.assert_array_equal(out, x[r0:r0 + 3, c0:c0 + 4])
    again = TR.exec_op("random_crop", torch.as_tensor(x), size=(3, 4),
                       seed=7).numpy()
    np.testing.assert_array_equal(again, t)
