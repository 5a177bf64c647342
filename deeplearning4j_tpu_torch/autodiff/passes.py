"""Graph passes applied when a walk is built (the GraphOptimizer analog).

Counterpart of ``deeplearning4j_tpu/autodiff/passes.py``. The passes run
on a shallow copy of the op list when ``SameDiff._emit`` builds a walk;
the stored graph is never changed, so save/load round-trips it as built.

The one pass rewrites the two-pass variance motif every frozen TF graph
carries for LayerNorm (``tf.nn.moments``)::

    m  = Mean(x, axes, keepdims)
    sd = SquaredDifference(x, StopGradient(m))   # StopGradient -> Identity
    v  = Mean(sd, axes, keepdims)

into ``one_pass_variance(x, m)`` = ``max(E[x^2] - m^2, 0)``, which reads
``x`` with no dependence on ``m``'s pass. The gradient is the same
(``d/dx E[(x-c)^2] = 2(x-c)/N`` with ``c = sg(E[x])`` equals ``d/dx
(E[x^2] - E[x]^2) = 2(x-E[x])/N``); the f32 rounding is not, so the
parity tests run with the pass on and off. ``DL4J_TPU_GRAPH_OPT=0``
turns it off, the switch the reference reads.
"""
from __future__ import annotations

import os
from typing import List, Tuple

from deeplearning4j_tpu_torch.ops import registry as op_registry
from deeplearning4j_tpu_torch.ops.moments import one_pass_variance as _opv
from deeplearning4j_tpu_torch.ops.registry import register


@register("one_pass_variance")
def one_pass_variance(x, mean, axis=None, keepdims=False, keep_dims=None):
    """Variance given the already-computed mean over the same reduction,
    emitted only by the pass. Takes the ``keep_dims`` spelling too, as
    the rewritten Mean node's attrs are copied verbatim; cast back to
    ``x``'s dtype, which the replaced Mean produced."""
    if axis is None:
        dims = tuple(range(x.dim()))
    elif isinstance(axis, (list, tuple)):
        dims = tuple(int(a) for a in axis)
    else:
        dims = (int(axis),)
    kd = keepdims if keep_dims is None else keep_dims
    return _opv(x, mean, dims, bool(kd)).to(x.dtype)


def _canon(name: str) -> str:
    return op_registry.get(name).name if op_registry.has(name) else name


def _norm_axis(a):
    if isinstance(a, (list, tuple)):
        return tuple(int(x) for x in a)
    return a if a is None else (int(a),)


def _keepdims(attrs: dict) -> bool:
    return bool(attrs.get("keepdims", attrs.get("keep_dims", False)))


def _same_reduction(a1: dict, a2: dict) -> bool:
    return (_norm_axis(a1.get("axis")) == _norm_axis(a2.get("axis"))
            and _keepdims(a1) == _keepdims(a2))


def fuse_two_pass_moments(ops: List) -> Tuple[List, int]:
    """Return ``(new_ops, n_rewritten)``: every matched variance-Mean node
    replaced (by a copy; the input list is untouched) by a
    ``one_pass_variance`` node reading the raw activation and the live
    mean. The orphaned SquaredDifference (and StopGradient identity) stay;
    ``SameDiff._needed_ops`` prunes them when nothing else reads them."""
    from deeplearning4j_tpu_torch.autodiff.samediff import OpNode

    prod = {}
    for op in ops:
        for o in op.outputs:
            prod[o] = op

    def resolve(name: str, through_sg: bool = False) -> str:
        # a stop_gradient is read through on the mean side only (where the
        # transform is proven gradient-equivalent); identity anywhere
        ok = ("identity", "stop_gradient") if through_sg else ("identity",)
        seen = set()
        while name in prod and name not in seen:
            seen.add(name)
            p = prod[name]
            if _canon(p.op_name) in ok and len(p.inputs) == 1:
                name = p.inputs[0]
                continue
            break
        return name

    out, n = [], 0
    for op in ops:
        new_op = op
        if (_canon(op.op_name) == "reduce_mean" and len(op.inputs) == 1
                and len(op.outputs) == 1):
            sq = prod.get(op.inputs[0])
            if (sq is not None and _canon(sq.op_name) == "squaredsubtract"
                    and len(sq.inputs) == 2):
                raw = list(sq.inputs)
                for xi, mi in ((0, 1), (1, 0)):
                    x_name = resolve(raw[xi])
                    m_name = resolve(raw[mi], through_sg=True)
                    m_op = prod.get(m_name)
                    if (m_op is not None
                            and _canon(m_op.op_name) == "reduce_mean"
                            and len(m_op.inputs) == 1
                            and len(m_op.outputs) == 1
                            and resolve(m_op.inputs[0]) == x_name
                            and _same_reduction(m_op.attrs, op.attrs)):
                        new_op = OpNode(op.name, "one_pass_variance",
                                        [x_name, m_op.outputs[0]],
                                        list(op.outputs), dict(op.attrs))
                        n += 1
                        break
        out.append(new_op)
    return out, n


def graph_opt_enabled() -> bool:
    """Live value of the ``DL4J_TPU_GRAPH_OPT`` switch. Callers that cache
    built walks fold it into their cache key."""
    return os.environ.get("DL4J_TPU_GRAPH_OPT", "1") != "0"


def optimize_for_emission(ops: List) -> List:
    """All enabled passes, in order (off with ``DL4J_TPU_GRAPH_OPT=0``)."""
    if not graph_opt_enabled():
        return ops
    ops, _ = fuse_two_pass_moments(ops)
    return ops
