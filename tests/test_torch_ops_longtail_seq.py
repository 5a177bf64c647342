"""The port's ``ops/longtail.py`` against the JAX package's, on the CPU:
its RNN runners, fused NLP steps, the fused attention op, its stragglers
and its ONNX-layout recurrent, conv and normalisation ops
(``_torch_ops_parity`` states the tolerances).
``multi_head_dot_product_attention`` is swept over its routes:
unmasked, key-masked, causal, and causal with a key mask (which
``attention_route`` sends to the plain version), and a query mask (plain
as well), and its gradients held against ``jax.grad``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _torch_ops_parity import (EW, RED, case_ids, check_case, ids, n, u)
from deeplearning4j_tpu.ops import registry as JR
from deeplearning4j_tpu_torch.ops import registry as TR
from deeplearning4j_tpu_torch.ops import standard as TS


def _mha(r, t_q=5, t_k=6, d=8, h=2, dh=8):
    return [n(r, 2, t_q, d), n(r, 2, t_k, d), n(r, 2, t_k, d),
            n(r, d, h, dh) * 0.3, n(r, d, h, dh) * 0.3, n(r, d, h, dh) * 0.3,
            n(r, h, dh, d) * 0.3]


def _key_mask(keep, t_k):
    return (np.arange(t_k)[None, :] < np.asarray(keep)[:, None])[
        :, None, None, :]


CASES = [
    ("static_rnn", "StaticRNN", lambda r: [
        n(r, 2, 4, 3), n(r, 2, 5), n(r, 2, 5), n(r, 8, 20) * 0.3, n(r, 20)],
     {"forget_bias": 0.5}, RED),
    ("static_rnn_gru", "dynamic_rnn", lambda r: [
        n(r, 2, 4, 3), n(r, 2, 5), n(r, 2, 5),
        [n(r, 8, 10) * 0.3, n(r, 8, 5) * 0.3], [n(r, 10), n(r, 5)]],
     {"cell": "gru"}, RED),
    ("static_bidirectional_rnn", "StaticBidirectionalRNN", lambda r: [
        n(r, 2, 4, 3), n(r, 2, 5), n(r, 2, 5), n(r, 8, 20) * 0.3, n(r, 20),
        n(r, 2, 5), n(r, 2, 5), n(r, 8, 20) * 0.3, n(r, 20)], {}, RED),
    ("lstm_block", "LSTMBlock", lambda r: [
        n(r, 2, 4, 3), n(r, 2, 5), n(r, 2, 5), n(r, 8, 20) * 0.3, n(r, 20)],
     {}, RED),
    ("sru", "SRU", lambda r: [n(r, 2, 5, 4), n(r, 2, 4),
                              n(r, 4, 12) * 0.4, n(r, 8)], {}, RED),
    ("sru_bi", "SRUBi", lambda r: [n(r, 2, 5, 4), n(r, 2, 4),
                                   n(r, 4, 12) * 0.4, n(r, 8), n(r, 2, 4),
                                   n(r, 4, 12) * 0.4, n(r, 8)], {}, RED),
    ("skipgram", "SkipGram", lambda r: [
        n(r, 10, 4) * 0.1, n(r, 10, 4) * 0.1, np.array([1, 3, 1], np.int32),
        np.array([2, 4, 5], np.int32), ids(r, 10, 3, 2)], {"lr": 0.5}, RED),
    ("cbow", "CBOW", lambda r: [
        n(r, 10, 4) * 0.1, n(r, 10, 4) * 0.1, ids(r, 10, 3, 2),
        np.array([2, 4, 5], np.int32), ids(r, 10, 3, 2)], {"lr": 0.5}, RED),
    # the fused attention op over its routes
    ("mha", "multi_head_dot_product_attention", _mha, {}, RED),
    ("mha_key_mask", "MultiHeadDotProductAttentionOp",
     lambda r: _mha(r) + [_key_mask([2, 6], 6)], {}, RED),
    ("mha_all_masked", "multi_head_dot_product_attention",
     lambda r: _mha(r) + [_key_mask([0, 4], 6)], {}, RED),
    ("mha_causal", "multi_head_dot_product_attention",
     lambda r: _mha(r, t_q=6), {"causal": True}, RED),
    ("mha_causal_short_q", "multi_head_dot_product_attention",
     lambda r: _mha(r, t_q=4), {"causal": True}, RED),
    ("mha_causal_key_mask", "multi_head_dot_product_attention",
     lambda r: _mha(r, t_q=6) + [_key_mask([3, 6], 6)], {"causal": True},
     RED),
    ("mha_causal_first_key_masked", "multi_head_dot_product_attention",
     lambda r: _mha(r, t_q=6) + [
         np.arange(6)[None, None, None, :] >= np.array([0, 2])[
             :, None, None, None]], {"causal": True}, RED),
    ("mha_query_mask", "multi_head_dot_product_attention",
     lambda r: _mha(r, t_q=6) + [np.tril(np.ones((6, 6), bool))], {}, RED),
    ("maxout", "Maxout", lambda r: [n(r, 3, 8)], {"channels": 4}, EW),
    ("stop_gradient", "StopGradient", lambda r: [n(r, 3, 4)], {}, EW),
    ("tri", "Tri", lambda r: [], {"rows": 3, "cols": 5, "diag": 1}, EW),
    ("sufficient_statistics", "SufficientStatistics", lambda r: [
        n(r, 3, 4, 5)], {"axes": [0, 2]}, RED),
    ("fused_batch_norm", "fused_batch_norm", lambda r: [
        n(r, 2, 3, 3, 4) + 1, u(r, 4, lo=0.5, hi=2), n(r, 4)], {}, RED),
    ("fused_batch_norm_infer", "fused_batch_norm", lambda r: [
        n(r, 2, 3, 3, 4), u(r, 4, lo=0.5, hi=2), n(r, 4), n(r, 4),
        u(r, 4, lo=0.5, hi=2)], {"is_training": False}, RED),
    ("histogram", "Histogram", lambda r: [n(r, 40)], {"num_bins": 7}, EW),
    ("boolean_mask", "BooleanMask", lambda r: [
        n(r, 5, 3), np.array([True, False, True, True, False])], {}, EW),
    ("sparse_to_dense", "SparseToDense", lambda r: [
        np.array([[0, 1], [2, 3]], np.int32), n(r, 2)],
     {"dense_shape": [3, 4], "default_value": -1.0}, EW),
    ("sparse_dense_matmul", "SparseTensorDenseMatMul", lambda r: [
        np.array([[0, 1], [2, 3], [0, 0]], np.int32), n(r, 3),
        np.array([3, 4], np.int32), n(r, 4, 2)], {}, RED),
    ("log_matrix_determinant", "LogMatrixDeterminant", lambda r: [
        n(r, 2, 3, 3)], {}, RED),
    ("reduce_sqnorm", "SquaredNorm", lambda r: [n(r, 3, 4)],
     {"axis": 1, "keepdims": True}, RED),
    ("matrix_diag_part", "MatrixDiagPartV3Op", lambda r: [n(r, 2, 3, 4)], {},
     EW),
    ("onnx_lstm", "OnnxLSTM", lambda r: [
        n(r, 4, 2, 3), n(r, 1, 20, 3) * 0.3, n(r, 1, 20, 5) * 0.3,
        n(r, 1, 40) * 0.1, n(r, 1, 2, 5), n(r, 1, 2, 5)], {}, RED),
    ("onnx_lstm_bidir", "onnx_lstm", lambda r: [
        n(r, 4, 2, 3), n(r, 2, 20, 3) * 0.3, n(r, 2, 20, 5) * 0.3], {}, RED),
    ("onnx_lstm_reverse", "onnx_lstm", lambda r: [
        n(r, 4, 2, 3), n(r, 1, 20, 3) * 0.3, n(r, 1, 20, 5) * 0.3],
     {"direction": "reverse"}, RED),
    ("onnx_gru", "OnnxGRU", lambda r: [
        n(r, 4, 2, 3), n(r, 2, 15, 3) * 0.3, n(r, 2, 15, 5) * 0.3,
        n(r, 2, 30) * 0.1], {}, RED),
    ("onnx_gru_lbr", "onnx_gru", lambda r: [
        n(r, 4, 2, 3), n(r, 1, 15, 3) * 0.3, n(r, 1, 15, 5) * 0.3],
     {"linear_before_reset": 1}, RED),
    ("onnx_rnn", "OnnxRNN", lambda r: [
        n(r, 4, 2, 3), n(r, 2, 5, 3) * 0.3, n(r, 2, 5, 5) * 0.3,
        n(r, 2, 10) * 0.1, n(r, 2, 2, 5)], {}, RED),
    ("deconv2d_nchw", "ConvTransposeNCHW", lambda r: [
        n(r, 1, 3, 4, 4), n(r, 3, 2, 3, 3), n(r, 2)],
     {"strides": (2, 2), "padding": ((1, 0), (0, 1))}, RED),
    ("scatter_elements", "ScatterElements", lambda r: [
        n(r, 3, 4), np.array([[1, 0, 2, 3], [0, 2, 1, 1]], np.int32),
        n(r, 2, 4)], {"axis": 1}, EW),
    ("scatter_elements_add", "scatter_elements", lambda r: [
        n(r, 3, 4), np.array([[1, 1, 2, 0], [0, 2, 1, 1]], np.int32),
        n(r, 2, 4)], {"axis": 0, "reduction": "add"}, EW),
    ("scatter_elements_max", "scatter_elements", lambda r: [
        n(r, 3, 4), np.array([[1, 1, 2, 0], [1, 2, 1, 1]], np.int32),
        n(r, 2, 4)], {"axis": 0, "reduction": "max"}, EW),
    ("trilu", "Trilu", lambda r: [n(r, 4, 5)], {"k": 1, "upper": False}, EW),
    ("hardmax", "Hardmax", lambda r: [n(r, 3, 5)], {"axis": 0}, EW),
    ("global_maxpool_nchw", "GlobalMaxPoolNCHW", lambda r: [
        n(r, 2, 3, 4, 5)], {}, EW),
    ("shrink", "Shrink", lambda r: [n(r, 8)], {"bias": 0.2, "lambd": 0.4},
     EW),
    ("celu", "Celu", lambda r: [n(r, 8)], {"alpha": 0.7}, EW),
    ("group_norm", "GroupNormalization", lambda r: [
        n(r, 2, 6, 3, 3) + 1, n(r, 6), n(r, 6)], {"num_groups": 3}, RED),
    ("reduce_logsumexp_axes", "ReduceLogSumExpOp", lambda r: [n(r, 3, 4)],
     {"axis": (1,), "keepdims": True}, RED),
    ("truncatemod", "TruncateMod", lambda r: [n(r, 6) * 4,
                                              u(r, 6, lo=0.5, hi=2)], {}, EW),
    ("truncatemod_int", "fmod_op", lambda r: [ids(r, 20, 6) - 10,
                                              ids(r, 4, 6) + 1], {}, EW),
]


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_op_matches_reference(case):
    check_case(case)


@pytest.mark.parametrize("mask, causal, route", [
    (None, False, "kernel"), ("key", False, "kernel"), (None, True, "kernel"),
    ("key", True, "plain"), ("query", False, "plain")])
def test_fused_attention_takes_the_stated_route(mask, causal, route):
    q = torch.zeros(2, 2, 6, 8)
    m = {None: None, "key": torch.ones(2, 1, 1, 6, dtype=torch.bool),
         "query": torch.ones(6, 6, dtype=torch.bool)}[mask]
    assert TS.attention_route(q, q, q, m, causal) == route


def test_mha_gradients_match_the_reference():
    """Autograd through the routed op (K2's plain version on the CPU)
    against ``jax.grad`` of the reference, with a key mask."""
    import jax
    rng = np.random.default_rng(5)
    ins = _mha(rng) + [_key_mask([3, 6], 6)]
    cot = n(rng, 2, 5, 8)

    def jf(*a):
        return jnp.sum(JR.exec_op("multi_head_dot_product_attention", *a,
                                  ins[-1]) * cot)

    jg = jax.grad(jf, argnums=tuple(range(7)))(*map(jnp.asarray, ins[:7]))
    ts = [torch.tensor(a, requires_grad=True) for a in ins[:7]]
    out = TR.exec_op("multi_head_dot_product_attention", *ts,
                     torch.as_tensor(ins[-1]))
    tg = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), ts)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **RED)
