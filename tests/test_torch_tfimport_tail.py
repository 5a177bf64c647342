"""The TF mapping rules whose registry ops came with the port's long-tail
op modules (``ops/extended.py``, ``longtail``, ``tranche4``-``tranche6``):
twins of ``tests/test_tf_import_corpus.py``'s cases for those rules, on
the CPU. Each corpus graph is imported by the port from TF's bytes and by
the JAX package from TF's proto; the port is held to TF at the corpus's
atol 1e-5 and to the JAX import at 1e-5, both at 1e-4 for the iterative
special functions (``_torch_ops_parity``'s SPECIAL rows). TF's import is
most of this file's time.
"""
import numpy as np
import pytest
import torch

TAIL_RULES = [
    "AdjustHue", "AdjustSaturation", "Atan2", "BatchToSpaceND", "Betainc",
    "Bitcast", "BitwiseAnd", "BitwiseOr", "BitwiseXor", "CropAndResize",
    "Cross", "DenseBincount", "Digamma", "Dilation2D", "DivNoNan", "Erfinv",
    "Expm1", "ExtractImagePatches", "FakeQuantWithMinMaxArgs",
    "FakeQuantWithMinMaxVars", "HistogramFixedWidth", "Igamma", "Igammac",
    "Invert", "InvertPermutation", "L2Loss", "LeftShift", "Lgamma",
    "LogMatrixDeterminant", "MatrixDiag", "MatrixDiagPartV3", "MatrixDiagV3",
    "MatrixSetDiag", "MatrixSetDiagV3", "MirrorPad", "Mod", "Polygamma",
    "ResizeNearestNeighbor", "RightShift", "Rint", "ScatterNd", "SegmentMax",
    "SegmentMean", "SegmentMin", "SegmentProd", "SpaceToBatchND",
    "SparseToDense", "TensorScatterAdd", "TensorScatterSub",
    "TensorScatterUpdate", "UnsortedSegmentMax", "UnsortedSegmentMin",
    "UnsortedSegmentProd", "UnsortedSegmentSum", "Zeta"]

# the iterative special functions
SPECIAL = {"Betainc", "Igamma", "Igammac", "Polygamma", "Zeta", "Digamma",
           "Lgamma", "Erfinv"}


def check_tail_rule(corpus, op):
    from deeplearning4j_tpu_torch.modelimport.tfimport import TFGraphMapper
    tf = corpus.tf
    fn, feeds = corpus.CORPUS[op]
    gd, frozen = corpus._graph_def(fn, feeds)
    expected = frozen(**{k: tf.constant(v) for k, v in feeds.items()})
    expected = [np.asarray(t) for t in (
        expected if isinstance(expected, (list, tuple)) else [expected])]
    outs = [o.name for o in frozen.graph.get_operations()
            if o.type == "Identity"][-len(expected):]
    tsd = TFGraphMapper.import_graph(gd.SerializeToString(), device="cpu")
    jsd = corpus.TFGraphMapper.import_graph(gd)
    got = tsd.output(feeds, outs)
    ref = jsd.output(feeds, outs)
    atol = 1e-4 if op in SPECIAL else 1e-5
    for name, exp in zip(outs, expected):
        g = got[name]
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else \
            np.asarray(g)
        assert g.shape == exp.shape, (name, g.shape, exp.shape)
        np.testing.assert_allclose(g, exp, atol=atol, equal_nan=True,
                                   err_msg=name)
        np.testing.assert_allclose(g, np.asarray(ref[name]), atol=atol,
                                   equal_nan=True, err_msg=name)
    assert [o.op_name for o in tsd.ops()] == [o.op_name for o in jsd.ops()]


@pytest.fixture(scope="module")
def corpus():
    pytest.importorskip("tensorflow")
    import test_tf_import_corpus as C
    return C


@pytest.mark.parametrize("op", TAIL_RULES)
def test_tail_rule_matches_tf_and_the_reference(corpus, op):
    check_tail_rule(corpus, op)
