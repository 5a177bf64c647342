"""The port's whole op registry against the JAX package's, on the CPU.

Every one of the reference's names (canonical ops and aliases, after all
six of its op modules have registered in their order) is held by the
port and resolves to the op of the same canonical name, with the same
output count; every op the reference writes itself takes the same
attribute names (the ops that draw take one more, ``generator``, which
the graph engine hands them); and every canonical op has a parity case in
one of the ``test_torch_op*`` sweeps or is named below with the test that
holds it instead.
"""
import inspect

import pytest

import deeplearning4j_tpu.ops  # noqa: F401 (all six modules)
from deeplearning4j_tpu.ops import registry as JR
from deeplearning4j_tpu_torch.ops import registry as TR

import test_torch_op_registry as std_sweep
import test_torch_ops_extended as ext_sweep
import test_torch_ops_extended_tail as ext_tail_sweep
import test_torch_ops_longtail as lt_sweep
import test_torch_ops_longtail_seq as lt_seq_sweep
import test_torch_ops_tranche4 as t4_sweep
import test_torch_ops_tranche4_bp as t4_bp_sweep
import test_torch_ops_tranche5_6 as t56_sweep

REF_NAMES = sorted(JR._REGISTRY)

# canonical ops held by a test other than the parity sweeps, and why
HELD_ELSEWHERE = {
    "qr": "free signs: test_torch_op_registry reconstruction",
    "svd": "free signs: test_torch_op_registry singular values",
    "self_adjoint_eig": "free signs: test_torch_ops_extended_tail "
                        "eigenvalues",
    "random_normal": "draws: test_torch_op_registry moments",
    "random_uniform": "draws: test_torch_op_registry moments",
    "random_bernoulli": "draws: test_torch_op_registry moments",
    "dropout": "draws: test_torch_op_registry kept-entry scale",
    "dropout_inverted": "draws: test_torch_op_registry kept-entry scale",
    "random_gamma": "draws: test_torch_ops_extended_tail moments",
    "random_poisson": "draws: test_torch_ops_extended_tail moments",
    "random_exponential": "draws: test_torch_ops_extended_tail moments",
    "random_shuffle": "draws: test_torch_ops_extended_tail support",
    "random_categorical": "draws: test_torch_ops_extended_tail frequencies",
    "random_crop": "draws: test_torch_ops_longtail window",
    "random_multinomial": "draws: test_torch_ops_tranche4 frequencies",
    "bernoulli_sample": "draws: test_torch_ops_tranche4 frequencies",
    "normal": "draws: test_torch_ops_tranche5_6 moments",
    "uniform": "draws: test_torch_ops_tranche5_6 moments",
    "truncatednormal": "draws: test_torch_ops_tranche5_6 moments",
    "lognormal": "draws: test_torch_ops_tranche5_6 moments",
    "binomial": "draws: test_torch_ops_tranche5_6 moments",
    "exponential_distribution": "draws: test_torch_ops_tranche5_6 moments",
    "random_normal_gen": "draws: test_torch_ops_tranche5_6 moments",
    "random_uniform_gen": "draws: test_torch_ops_tranche5_6 moments",
    "set_seed": "global state: test_torch_ops_tranche5_6 round trip",
    "get_seed": "global state: test_torch_ops_tranche5_6 round trip",
}


def _all_cases():
    return (std_sweep.CASES + ext_sweep.CASES + ext_tail_sweep.CASES
            + lt_sweep.CASES + lt_seq_sweep.CASES + t4_sweep.CASES
            + t4_bp_sweep.CASES + t56_sweep.CASES)


def test_registries_hold_the_same_names():
    assert len(JR.names()) == len(TR.names())
    assert set(TR._REGISTRY) == set(JR._REGISTRY)


@pytest.mark.parametrize("name", REF_NAMES)
def test_name_binds_as_in_the_reference(name):
    assert TR.has(name), name
    j, t = JR.get(name), TR.get(name)
    assert t.name == j.name, (name, j.name, t.name)
    assert t.num_outputs == j.num_outputs, name


def _params(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


def _own(fn):
    return getattr(fn, "__module__", "").startswith("deeplearning4j_tpu.ops")


def test_ops_take_the_reference_attribute_names():
    """For each op the reference writes itself: the same positional
    inputs, and every attribute (a parameter with a default) by name.
    The reference's ops that wrap a library function take that
    function's signature and are held by their parity cases."""
    bad = []
    for name in JR.names():
        jp, tp = _params(JR.get(name).fn), _params(TR.get(name).fn)
        if not _own(JR.get(name).fn) or jp is None:
            continue
        if tp is None:
            bad.append((name, "port signature not introspectable"))
            continue
        required = [p.name for p in jp.values()
                    if p.default is p.empty and p.kind in (
                        p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        t_required = [p.name for p in tp.values()
                      if p.default is p.empty and p.kind in (
                          p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        attrs = {p.name for p in jp.values() if p.default is not p.empty
                 or p.kind == p.KEYWORD_ONLY}
        missing = attrs - set(tp)
        if len(required) != len(t_required) or missing:
            bad.append((name, required, t_required, sorted(missing)))
        extra = {p.name for p in tp.values() if p.default is not p.empty
                 and p.name not in jp} - {"generator"}
        if extra and name not in ("pad", "reduce_all", "reduce_any",
                                  "transpose"):
            bad.append((name, "extra attributes", sorted(extra)))
    assert not bad, bad


def test_every_canonical_op_has_a_parity_case():
    covered = {TR.get(c[1]).name for c in _all_cases()}
    missing = set(JR.names()) - covered - set(HELD_ELSEWHERE)
    assert not missing, sorted(missing)
    assert set(HELD_ELSEWHERE) <= set(JR.names())
