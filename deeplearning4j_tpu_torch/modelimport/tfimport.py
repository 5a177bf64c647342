"""TensorFlow GraphDef import into the port's graph engine: counterpart of
``deeplearning4j_tpu/modelimport/tfimport.py`` (ref: ``samediff-import-
tensorflow``'s ``OpMappingRegistry``/``ImportGraph`` and
``TFGraphMapper``).

A per-op mapping-rule registry walks the GraphDef topologically, turning
each node into registry ops of a :class:`SameDiff`; structural inputs
(axes, shapes, perms, paddings) are constant-folded at import time. The
rules are the reference's, every one registered, and every registry op
they emit is the port's (the port's registry holds the reference's);
a rule whose op were missing would raise :class:`TFImportError` naming
it, never emit zeros or skip the node.

The GraphDef is read by the port's own wire codec (``tf_proto.py``): no
TF, no protobuf. A graph skeleton (``tf_skeleton.py``: the structure with
its large weights stripped) must be filled before import; its Const
nodes carry a mark that this importer refuses, so an unfilled weight
never imports as zeros.
"""
from __future__ import annotations

import re

from typing import Callable, Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, SDVariable
from deeplearning4j_tpu_torch.modelimport import tf_proto
from deeplearning4j_tpu_torch.modelimport.tf_skeleton import SKELETON_ATTR
from deeplearning4j_tpu_torch.ops import dtypes as _dt
from deeplearning4j_tpu_torch.ops import registry as _op_registry

_RULES: Dict[str, Callable] = {}


def mapping_rule(*op_types):
    """ref: OpMappingRegistry rule registration."""
    def deco(fn):
        for t in op_types:
            _RULES[t] = fn
        return fn
    return deco


class TFImportError(ValueError):
    pass


# ------------------------------------------------------------------ attrs
def _parse_attrs(node) -> dict:
    out = {}
    for k, v in node.attr.items():
        field = v.WhichOneof("value")
        if field == "b":
            out[k] = v.b
        elif field == "i":
            out[k] = int(v.i)
        elif field == "f":
            out[k] = float(v.f)
        elif field == "s":
            out[k] = v.s.decode("utf-8", "ignore")
        elif field == "type":
            out[k] = int(v.type)
        elif field == "shape":
            out[k] = [d.size for d in v.shape.dim]
        elif field == "list":
            lv = v.list
            if lv.i:
                out[k] = [int(x) for x in lv.i]
            elif lv.f:
                out[k] = [float(x) for x in lv.f]
            elif lv.s:
                out[k] = [x.decode() for x in lv.s]
            elif lv.b:
                out[k] = list(lv.b)
            else:
                out[k] = []
        elif field == "tensor":
            out[k] = v.tensor
        elif field == "func":
            out[k] = v.func.name
    return out


_TF_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
              5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
              19: np.float16}


class _BFloat16:
    """DT_BFLOAT16 where numpy has no such dtype: a name the port's dtype
    helpers read."""
    name = "bfloat16"

    def __str__(self):
        return self.name


def _dtype_of(enum: int):
    if enum == 14:
        return _BFloat16()
    if enum in _TF_DTYPES:
        return np.dtype(_TF_DTYPES[enum])
    raise TFImportError(f"Unsupported TF dtype enum {enum}")


def _np_dtype(var) -> np.dtype:
    """A graph variable's dtype as numpy's."""
    return _dt.to_numpy_dtype(var.dtype)


def _tensor_to_ndarray(tensor_proto) -> np.ndarray:
    """TensorProto → numpy without the TF runtime."""
    dtype = _dtype_of(int(tensor_proto.dtype))
    if isinstance(dtype, _BFloat16):
        raise TFImportError("bfloat16 TF constants are not supported by "
                            "the port's importer")
    shape = [d.size for d in tensor_proto.tensor_shape.dim]
    if tensor_proto.tensor_content:
        return np.frombuffer(tensor_proto.tensor_content,
                             dtype=dtype).reshape(shape).copy()
    for field in ("float_val", "double_val", "int_val", "int64_val",
                  "bool_val", "half_val"):
        vals = list(getattr(tensor_proto, field, []))
        if vals:
            arr = np.asarray(vals, dtype=dtype)
            n = int(np.prod(shape)) if shape else 1
            if arr.size == 1 and n > 1:
                arr = np.full(shape, arr[0], dtype=dtype)
            return arr.reshape(shape)
    return np.zeros(shape, dtype=dtype)


# ------------------------------------------------------------------ mapper
class _ImportCtx:
    def __init__(self, sd: SameDiff, library: Optional[dict] = None):
        self.sd = sd
        self.vars: Dict[str, SDVariable] = {}     # tf tensor name -> SDVariable
        self.consts: Dict[str, np.ndarray] = {}   # tf node name -> numpy
        self.node_defs: Dict[str, object] = {}    # tf node name -> NodeDef
        self.library: Dict[str, object] = library or {}  # FunctionDefs by name

    def const_value(self, ref: str) -> np.ndarray:
        key = _fq(ref)
        name, idx = key.rsplit(":", 1)
        # bare-name cache: Const/Range rules (single-output nodes only)
        if idx == "0" and name in self.consts:
            return self.consts[name]
        if key in self.consts:
            return self.consts[key]
        # constant-fold a structural subgraph (Shape→StridedSlice→Pack etc.):
        # if the producing var depends only on constants, evaluate it through
        # the graph engine (the reference resolves these via its attribute-
        # resolution pass; here the real lowering does the arithmetic)
        var = self.vars.get(key)
        if var is not None:
            from deeplearning4j_tpu_torch.modelimport.common import (
                fold_constant)
            arr = fold_constant(self.sd, var)
            if arr is not None:
                self.consts[key] = arr
                return arr
        raise TFImportError(
            f"op input {ref!r} must be a constant (or constant-foldable) "
            f"for import (structural argument)")


def _pool_args(attrs):
    k = attrs.get("ksize", [1, 1, 1, 1])
    s = attrs.get("strides", [1, 1, 1, 1])
    if attrs.get("data_format", "NHWC") != "NHWC":
        raise TFImportError("only NHWC supported")
    return tuple(k[1:3]), tuple(s[1:3]), attrs.get("padding", "VALID")


def _register_default_rules():
    E = lambda ctx, name, *a, **kw: ctx.sd._op(name, *a, **kw)

    @mapping_rule("Placeholder", "PlaceholderWithDefault")
    def _ph(ctx, node, inputs, attrs):
        shape = attrs.get("shape")
        shape = tuple(None if d in (-1, 0) and i == 0 else (None if d == -1 else d)
                      for i, d in enumerate(shape or ())) or None
        dt = _dtype_of(attrs.get("dtype", 1))
        return ctx.sd.placeholder(node.name, shape, dt)

    @mapping_rule("Const")
    def _const(ctx, node, inputs, attrs):
        if SKELETON_ATTR in node.attr:
            raise TFImportError(
                f"Const {node.name!r} is a skeleton's stripped weight: "
                f"fill the skeleton (tf_skeleton.fill_skeleton) before "
                f"import")
        arr = _tensor_to_ndarray(attrs["value"])
        ctx.consts[node.name] = arr
        return ctx.sd.constant(arr, name=node.name)

    @mapping_rule("Identity", "StopGradient", "PreventGradient", "Snapshot",
                  "CheckNumerics")
    def _ident(ctx, node, inputs, attrs):
        # emit a real identity op so the TF node name stays addressable as a
        # graph output (it aliases its input: no copy, no launch)
        return ctx.sd._op("Identity", inputs[0])

    # elementwise binaries/unaries ride the registry's TF aliases directly
    _PASSTHRU = [
        "Add", "AddV2", "Sub", "Mul", "RealDiv", "Maximum", "Minimum",
        "SquaredDifference", "Pow", "Neg", "FloorDiv", "FloorMod",
        "Relu", "Relu6", "Elu", "Selu", "Sigmoid", "Tanh", "Softplus",
        "Softsign", "Gelu",
        "Greater", "GreaterEqual", "Less", "LessEqual", "Equal", "NotEqual",
        "LogicalAnd", "LogicalOr", "LogicalNot", "Select", "SelectV2",
    ]
    for op in _PASSTHRU:
        @mapping_rule(op)
        def _ew(ctx, node, inputs, attrs, _op=op):
            alias = {"AddV2": "Add"}.get(_op, _op)
            return ctx.sd._op(alias, *inputs)

    for op, fn in [("Sqrt", "sqrt"), ("Rsqrt", "rsqrt"), ("Exp", "exp"),
                   ("Log", "log"), ("Abs", "abs"), ("Square", "square"),
                   ("Sign", "sign"), ("Floor", "floor"), ("Ceil", "ceil"),
                   ("Round", "round"), ("Erf", "erf"), ("Erfc", "erfc")]:
        @mapping_rule(op)
        def _un(ctx, node, inputs, attrs, _fn=fn):
            return ctx.sd._op(_fn, inputs[0])

    @mapping_rule("LeakyRelu")
    def _leaky(ctx, node, inputs, attrs):
        return ctx.sd._op("LeakyRelu", inputs[0],
                          alpha=attrs.get("alpha", 0.2))

    @mapping_rule("MatMul", "BatchMatMul", "BatchMatMulV2")
    def _mm(ctx, node, inputs, attrs):
        return ctx.sd._op("MatMul", inputs[0], inputs[1],
                          transpose_a=attrs.get("transpose_a",
                                                attrs.get("adj_x", False)),
                          transpose_b=attrs.get("transpose_b",
                                                attrs.get("adj_y", False)))

    @mapping_rule("BiasAdd")
    def _bias(ctx, node, inputs, attrs):
        if attrs.get("data_format", "NHWC") != "NHWC":
            raise TFImportError("BiasAdd: only NHWC supported")
        return ctx.sd._op("Add", inputs[0], inputs[1])

    @mapping_rule("Softmax", "LogSoftmax")
    def _sm(ctx, node, inputs, attrs):
        return ctx.sd._op(node.op, inputs[0])

    @mapping_rule("Mean", "Sum", "Max", "Min", "Prod", "All", "Any")
    def _red(ctx, node, inputs, attrs):
        axis = ctx.const_value(node.input[1])
        axis = tuple(int(a) for a in np.atleast_1d(axis))
        return ctx.sd._op(node.op, inputs[0], axis=axis,
                          keepdims=attrs.get("keep_dims", False))

    @mapping_rule("ArgMax", "ArgMin")
    def _arg(ctx, node, inputs, attrs):
        axis = int(ctx.const_value(node.input[1])) if len(node.input) > 1 else -1
        return ctx.sd._op(node.op, inputs[0], axis=axis)

    @mapping_rule("Reshape")
    def _reshape(ctx, node, inputs, attrs):
        shape = [int(s) for s in ctx.const_value(node.input[1])]
        return ctx.sd._op("Reshape", inputs[0], shape=shape)

    @mapping_rule("Transpose")
    def _transpose(ctx, node, inputs, attrs):
        perm = [int(p) for p in ctx.const_value(node.input[1])]
        return ctx.sd._op("Transpose", inputs[0], perm=perm)

    @mapping_rule("Squeeze")
    def _squeeze(ctx, node, inputs, attrs):
        dims = attrs.get("squeeze_dims") or None
        return ctx.sd._op("Squeeze", inputs[0],
                          axis=list(dims) if dims else None)

    @mapping_rule("ExpandDims")
    def _expand(ctx, node, inputs, attrs):
        axis = int(ctx.const_value(node.input[1]))
        return ctx.sd._op("ExpandDims", inputs[0], axis=axis)

    @mapping_rule("ConcatV2", "Concat")
    def _concat(ctx, node, inputs, attrs):
        axis = int(ctx.const_value(node.input[-1]))
        return ctx.sd._op("Concat", *inputs[:-1], axis=axis)

    @mapping_rule("Pack")
    def _pack(ctx, node, inputs, attrs):
        return ctx.sd._op("Stack", *inputs, axis=attrs.get("axis", 0))

    @mapping_rule("Pad", "PadV2")
    def _pad(ctx, node, inputs, attrs):
        pads = [[int(v) for v in row]
                for row in ctx.const_value(node.input[1])]
        return ctx.sd._op("Pad", inputs[0], paddings=pads)

    @mapping_rule("Cast")
    def _cast(ctx, node, inputs, attrs):
        return ctx.sd._op("Cast", inputs[0],
                          dtype=_dtype_of(attrs["DstT"]).name)

    @mapping_rule("Conv2D")
    def _conv(ctx, node, inputs, attrs):
        if attrs.get("data_format", "NHWC") != "NHWC":
            raise TFImportError("Conv2D: only NHWC supported")
        strides = tuple(attrs.get("strides", [1, 1, 1, 1])[1:3])
        dil = tuple(attrs.get("dilations", [1, 1, 1, 1])[1:3])
        return ctx.sd._op("conv2d", inputs[0], inputs[1],
                          strides=strides, padding=attrs.get("padding", "SAME"),
                          dilation=dil)

    @mapping_rule("DepthwiseConv2dNative")
    def _dwconv(ctx, node, inputs, attrs):
        strides = tuple(attrs.get("strides", [1, 1, 1, 1])[1:3])
        return ctx.sd._op("DepthwiseConv2dNative", inputs[0], inputs[1],
                          strides=strides,
                          padding=attrs.get("padding", "SAME"))

    @mapping_rule("MaxPool", "MaxPoolV2")
    def _maxpool(ctx, node, inputs, attrs):
        k, s, p = _pool_args(attrs)
        return ctx.sd._op("MaxPool", inputs[0], kernel=k, strides=s, padding=p)

    @mapping_rule("AvgPool")
    def _avgpool(ctx, node, inputs, attrs):
        k, s, p = _pool_args(attrs)
        return ctx.sd._op("AvgPool", inputs[0], kernel=k, strides=s, padding=p)

    @mapping_rule("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
    def _fbn(ctx, node, inputs, attrs):
        if attrs.get("is_training", True) and len(node.input) >= 5:
            # inference import of a graph exported in training mode still
            # carries moving stats as inputs 3/4 — use them
            pass
        x, scale, offset, mean, var = inputs[:5]
        return ctx.sd._op("batchnorm", x, mean, var, scale, offset,
                          epsilon=attrs.get("epsilon", 1e-3))

    def _dynamic_ss(ctx, node, inputs, attrs):
        """StridedSlice whose begin/end carry runtime values — the loop-body
        ``x[:, i, :]`` pattern (begin depends on a While loop variable).
        Supported form: every dynamically-indexed axis is a SHRINK axis
        (size-1 select, lowered to a gather on that axis); other axes must
        be fully masked (untouched). Anything else refuses loudly."""
        bm = attrs.get("begin_mask", 0)
        em = attrs.get("end_mask", 0)
        sm = attrs.get("shrink_axis_mask", 0)
        if attrs.get("new_axis_mask", 0) or attrs.get("ellipsis_mask", 0):
            raise TFImportError(
                "dynamic StridedSlice with new_axis/ellipsis unsupported")
        strides = [int(v) for v in ctx.const_value(node.input[3])]
        if any(s != 1 for s in strides):
            raise TFImportError("dynamic StridedSlice needs unit strides")
        nspec = len(strides)
        out = inputs[0]
        # gather from the HIGHEST axis down so earlier axis ids stay valid
        for a in reversed(range(nspec)):
            if (sm >> a) & 1:
                idx = ctx.sd._op("gather", inputs[1],
                                 ctx.sd.constant(np.asarray(a, np.int32)),
                                 axis=0)
                out = ctx.sd._op("gather", out, idx, axis=a)
            elif (bm >> a) & 1 and (em >> a) & 1:
                continue                       # full slice on this axis
            else:
                raise TFImportError(
                    "dynamic StridedSlice: non-shrink, non-full axis "
                    f"{a} unsupported (use masks or constant bounds)")
        return out

    @mapping_rule("StridedSlice")
    def _ss(ctx, node, inputs, attrs):
        try:
            begin = [int(v) for v in ctx.const_value(node.input[1])]
            end = [int(v) for v in ctx.const_value(node.input[2])]
        except TFImportError:
            return _dynamic_ss(ctx, node, inputs, attrs)
        strides = [int(v) for v in ctx.const_value(node.input[3])]
        bm = attrs.get("begin_mask", 0)
        em = attrs.get("end_mask", 0)
        sm = attrs.get("shrink_axis_mask", 0)
        nm = attrs.get("new_axis_mask", 0)
        elm = attrs.get("ellipsis_mask", 0)
        nspec = len(begin)
        if inputs[0].shape is not None:
            rank = len(inputs[0].shape)
        elif not elm:
            # rank only matters for ellipsis expansion / trailing fill;
            # without it, unspecified trailing dims are simply left unsliced
            rank = nspec - bin(nm & ((1 << nspec) - 1)).count("1")
        else:
            raise TFImportError(
                "StridedSlice with ellipsis_mask needs a statically-known "
                "input rank")
        # number of input dims the ellipsis expands into
        n_real = sum(1 for i in range(nspec)
                     if not (nm >> i) & 1 and not (elm >> i) & 1)
        ell_fill = rank - n_real
        # decompose into: one strided slice over input dims (None = full
        # extent in the stride's direction), then Squeeze for shrink dims,
        # then ExpandDims for new axes — mirroring TF's spec-entry walk
        sl_begin, sl_end, sl_str = [], [], []
        squeeze_dims, new_axis_pos = [], []
        out_dim = 0
        for i in range(nspec):
            if (nm >> i) & 1:
                new_axis_pos.append(out_dim)
                out_dim += 1
                continue
            if (elm >> i) & 1:
                for _ in range(ell_fill):
                    sl_begin.append(None); sl_end.append(None)
                    sl_str.append(1)
                    out_dim += 1
                continue
            b = None if (bm >> i) & 1 else begin[i]
            e = None if (em >> i) & 1 else end[i]
            if (sm >> i) & 1:
                # shrink: take exactly the element at begin[i]; begin=-1
                # must map to end=None, not end=0
                bb = b if b is not None else 0
                sl_begin.append(bb)
                sl_end.append(bb + 1 if bb != -1 else None)
                sl_str.append(1)
                squeeze_dims.append(len(sl_begin) - 1)
                continue
            sl_begin.append(b); sl_end.append(e); sl_str.append(strides[i])
            out_dim += 1
        while len(sl_begin) < rank:      # unspecified trailing dims
            sl_begin.append(None); sl_end.append(None); sl_str.append(1)
            out_dim += 1
        out = ctx.sd._op("StridedSlice", inputs[0], begin=sl_begin,
                         end=sl_end, strides=sl_str)
        if squeeze_dims:
            out = ctx.sd._op("Squeeze", out, axis=squeeze_dims)
        for pos in new_axis_pos:         # ascending: prior inserts accounted
            out = ctx.sd._op("ExpandDims", out, axis=pos)
        return out

    # ---------------- BERT-class breadth (ref: OpMappingRegistry long tail)
    @mapping_rule("Gather", "GatherV2")
    def _gather(ctx, node, inputs, attrs):
        if attrs.get("batch_dims", 0):
            raise TFImportError("Gather: batch_dims unsupported")
        axis = 0
        if node.op == "GatherV2" and len(node.input) > 2:
            axis = int(ctx.const_value(node.input[2]))
        return ctx.sd._op("Gather", inputs[0], inputs[1], axis=axis)

    @mapping_rule("GatherNd")
    def _gather_nd(ctx, node, inputs, attrs):
        return ctx.sd._op("GatherNd", inputs[0], inputs[1])

    @mapping_rule("Slice")
    def _slice(ctx, node, inputs, attrs):
        begin = [int(v) for v in ctx.const_value(node.input[1])]
        size = [int(v) for v in ctx.const_value(node.input[2])]
        return ctx.sd._op("Slice", inputs[0], begin=begin, size=size)

    @mapping_rule("Split")
    def _split(ctx, node, inputs, attrs):
        # TF Split input order: (axis, value)
        axis = int(ctx.const_value(node.input[0]))
        n = int(attrs["num_split"])
        return ctx.sd._op("Split", inputs[-1], num_split=n, axis=axis,
                          n_out=n)

    @mapping_rule("SplitV")
    def _split_v(ctx, node, inputs, attrs):
        sizes = [int(v) for v in ctx.const_value(node.input[1])]
        axis = int(ctx.const_value(node.input[2]))
        return ctx.sd._op("SplitV", inputs[0], size_splits=sizes, axis=axis,
                          n_out=len(sizes))

    @mapping_rule("Unpack")
    def _unpack(ctx, node, inputs, attrs):
        n = int(attrs["num"])
        return ctx.sd._op("Unstack", inputs[0], axis=attrs.get("axis", 0),
                          num=n, n_out=n)

    @mapping_rule("OneHot")
    def _one_hot(ctx, node, inputs, attrs):
        depth = int(ctx.const_value(node.input[1]))
        # .item() keeps the native python type; output dtype follows the
        # node's T attr (int OneHot must stay int)
        on = ctx.const_value(node.input[2]).item()
        off = ctx.const_value(node.input[3]).item()
        dt = _dtype_of(attrs["T"]).name if "T" in attrs else None
        return ctx.sd._op("OneHot", inputs[0], depth=depth, on_value=on,
                          off_value=off, axis=attrs.get("axis", -1),
                          dtype=dt)

    @mapping_rule("Einsum")
    def _einsum(ctx, node, inputs, attrs):
        return ctx.sd._op("Einsum", *inputs, equation=attrs["equation"])

    @mapping_rule("Tile")
    def _tile(ctx, node, inputs, attrs):
        reps = [int(v) for v in ctx.const_value(node.input[1])]
        return ctx.sd._op("Tile", inputs[0], reps=reps)

    @mapping_rule("Fill")
    def _fill(ctx, node, inputs, attrs):
        try:
            dims = [int(v) for v in ctx.const_value(node.input[0])]
        except TFImportError:
            # runtime-derived dims — tf.zeros((tf.shape(x)[0], D)) et al.
            # Pattern-fold Pack(Shape(v)[i], const, …): tensor shapes are
            # known when the graph runs, so each Shape slice becomes
            # a template entry resolved from the ref tensor's shape at
            # trace time (fill_template); unfoldable dims raise loudly
            tpl = _shape_template(ctx, node.input[0])
            if tpl is not None:
                refs = [v for v in tpl if not isinstance(v, int)]
                template = tuple(("shape", sum(1 for p in tpl[:i]
                                               if not isinstance(p, int)),
                                  v[1]) if not isinstance(v, int) else v
                                 for i, v in enumerate(tpl))
                return ctx.sd._op("fill_template", inputs[1],
                                  *[r[0] for r in refs], template=template)
            return ctx.sd._op("fill_dynamic", inputs[0], inputs[1])
        try:
            val = ctx.const_value(node.input[1])
            return ctx.sd.constant(np.full(dims, val), name=node.name)
        except TFImportError:
            # dynamic fill value: broadcast it against a ones tensor of the
            # value's own dtype (TF Fill output dtype == value dtype)
            ones = ctx.sd.constant(np.ones(dims, _np_dtype(inputs[1])))
            return ctx.sd._op("Mul", ones, inputs[1])

    @mapping_rule("Shape")
    def _shape(ctx, node, inputs, attrs):
        shp = inputs[0].shape
        if shp is not None and all(d is not None for d in shp):
            # fold statically-known shapes so downstream structural args
            # (Reshape targets computed via Shape→Slice→Pack) stay constant
            arr = np.asarray(shp, np.int32)
            ctx.consts[node.name] = arr
            return ctx.sd.constant(arr, name=node.name)
        return ctx.sd._op("Shape", inputs[0])

    @mapping_rule("Range")
    def _range(ctx, node, inputs, attrs):
        start, limit, delta = (ctx.const_value(node.input[i])
                               for i in range(3))
        arr = np.arange(np.asarray(start).item(), np.asarray(limit).item(),
                        np.asarray(delta).item(),
                        dtype=np.asarray(start).dtype)
        ctx.consts[node.name] = arr
        return ctx.sd.constant(arr, name=node.name)

    @mapping_rule("ReverseV2")
    def _reverse(ctx, node, inputs, attrs):
        axis = [int(v) for v in np.atleast_1d(ctx.const_value(node.input[1]))]
        return ctx.sd._op("ReverseV2", inputs[0], axis=axis)

    # -------- functional control flow (ref: Enter/Exit/Merge/Switch legacy
    # frames collapse to TF2's If/While, which map onto SameDiff's
    # __cond__/__while__ composite ops)
    @mapping_rule("StatelessIf", "If")
    def _if(ctx, node, inputs, attrs):
        then_f = ctx.library.get(attrs["then_branch"])
        else_f = ctx.library.get(attrs["else_branch"])
        if then_f is None or else_f is None:
            raise TFImportError(f"If branch functions not in graph library "
                                f"({attrs.get('then_branch')}, "
                                f"{attrs.get('else_branch')})")
        return ctx.sd.if_cond(inputs[0],
                              _fdef_builder(then_f, ctx.library),
                              _fdef_builder(else_f, ctx.library),
                              *inputs[1:], name=node.name)

    @mapping_rule("StatelessWhile", "While")
    def _while(ctx, node, inputs, attrs):
        cond_f = ctx.library.get(attrs["cond"])
        body_f = ctx.library.get(attrs["body"])
        if cond_f is None or body_f is None:
            raise TFImportError("While cond/body functions not in library")
        return ctx.sd.while_loop(_fdef_builder(cond_f, ctx.library),
                                 _fdef_builder(body_f, ctx.library),
                                 *inputs, name=node.name)



def _register_extended_rules():
    """Long-tail op-type coverage (trig/special functions, scans, segments,
    spatial reshuffles, linalg, image, quantization) — mechanical maps onto
    registry lowerings; structural inputs constant-folded like the default
    rules (ref: the OpMappingRegistry's several-hundred-rule table)."""
    # tensor-only passthrough onto canonical snake_case registry names
    def _snake(name):
        out = re.sub(r"(?<!^)(?=[A-Z][a-z])|(?<=[a-z0-9])(?=[A-Z])", "_",
                     name)
        return out.lower()

    for op in ["Sin", "Cos", "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh",
               "Asinh", "Acosh", "Atanh", "Expm1", "Log1p", "Rint",
               "Lgamma", "Digamma", "Atan2", "Betainc", "Igamma", "Igammac",
               "Zeta", "Polygamma", "Cross", "InvertPermutation",
               "MatrixDeterminant", "MatrixInverse",
               "L2Loss", "Cholesky", "LogMatrixDeterminant",
               "ZerosLike", "OnesLike", "RGBToHSV", "HSVToRGB"]:
        @mapping_rule(op)
        def _pt(ctx, node, inputs, attrs, _op=op):
            return ctx.sd._op(_snake(_op), *inputs)

    @mapping_rule("SegmentSum", "SegmentMean", "SegmentMax", "SegmentMin",
                  "SegmentProd")
    def _seg(ctx, node, inputs, attrs):
        # num_segments must be static: resolvable when the ids are
        # constant (the usual frozen-graph case)
        ids = np.asarray(ctx.const_value(node.input[1]))
        n = int(ids.max()) + 1
        name = "segment_" + node.op.replace("Segment", "").lower()
        return ctx.sd._op(name, inputs[0], inputs[1], num_segments=n)

    @mapping_rule("MatrixDiag")
    def _mdiag_v1(ctx, node, inputs, attrs):
        return ctx.sd._op("matrix_diag", inputs[0])

    @mapping_rule("MatrixDiagV3")
    def _mdiag_v3(ctx, node, inputs, attrs):
        k = int(np.asarray(ctx.const_value(node.input[1])).item())
        if k != 0:
            raise TFImportError("MatrixDiagV3 with k != 0 unsupported")
        rows = int(np.asarray(ctx.const_value(node.input[2])).item())
        cols = int(np.asarray(ctx.const_value(node.input[3])).item())
        padv = float(np.asarray(ctx.const_value(node.input[4])).item())
        diag_len = (inputs[0].shape[-1]
                    if inputs[0].shape and inputs[0].shape[-1] else None)
        for v in (rows, cols):
            if v != -1 and (diag_len is None or v != diag_len):
                raise TFImportError(
                    "MatrixDiagV3 with explicit num_rows/num_cols "
                    "different from the diagonal length unsupported")
        if padv != 0.0:
            raise TFImportError("MatrixDiagV3 with padding_value != 0 "
                                "unsupported")
        return ctx.sd._op("matrix_diag", inputs[0])

    @mapping_rule("MatrixSetDiag")
    def _msetdiag_v1(ctx, node, inputs, attrs):
        return ctx.sd._op("matrix_set_diag", inputs[0], inputs[1])

    @mapping_rule("MatrixSetDiagV3")
    def _msetdiag_v3(ctx, node, inputs, attrs):
        if len(node.input) > 2:
            k = int(np.asarray(ctx.const_value(node.input[2])).item())
            if k != 0:
                raise TFImportError("MatrixSetDiagV3 with k != 0 "
                                    "unsupported")
        return ctx.sd._op("matrix_set_diag", inputs[0], inputs[1])

    @mapping_rule("DenseBincount")
    def _dense_bincount(ctx, node, inputs, attrs):
        if inputs[0].shape is not None and len(inputs[0].shape) > 1:
            raise TFImportError("DenseBincount: only rank-1 input "
                                "supported (TF computes per-row bincounts "
                                "for rank-2)")
        if attrs.get("binary_output"):
            raise TFImportError("DenseBincount: binary_output=True "
                                "unsupported")
        w = np.asarray(ctx.const_value(node.input[2]))
        if w.size:
            raise TFImportError("DenseBincount: weights unsupported")
        size = int(np.asarray(ctx.const_value(node.input[1])).item())
        return ctx.sd._op("bincount", inputs[0], minlength=size,
                          length=size)

    @mapping_rule("ReverseSequence")
    def _revseq(ctx, node, inputs, attrs):
        return ctx.sd._op("reverse_sequence", inputs[0], inputs[1],
                          seq_axis=attrs.get("seq_dim", 1),
                          batch_axis=attrs.get("batch_dim", 0))

    @mapping_rule("MatrixDiagPart", "MatrixDiagPartV3")
    def _mdiagpart(ctx, node, inputs, attrs):
        if node.op == "MatrixDiagPartV3" and len(node.input) > 1:
            k = int(np.asarray(ctx.const_value(node.input[1])).item())
            if k != 0:
                raise TFImportError("MatrixDiagPartV3 with k != 0 "
                                    "unsupported")
        return ctx.sd._op("matrix_diag_part", inputs[0])

    @mapping_rule("Reciprocal", "Inv")
    def _recip(ctx, node, inputs, attrs):
        return ctx.sd._op("reciprocal", inputs[0])

    @mapping_rule("Cumsum", "Cumprod")
    def _cumx(ctx, node, inputs, attrs):
        axis = int(np.asarray(ctx.const_value(node.input[1])).item())
        return ctx.sd._op(node.op.lower(), inputs[0], axis=axis,
                          exclusive=bool(attrs.get("exclusive", False)),
                          reverse=bool(attrs.get("reverse", False)))

    @mapping_rule("TopKV2")
    def _topk(ctx, node, inputs, attrs):
        k = int(np.asarray(ctx.const_value(node.input[1])).item())
        return ctx.sd._op("top_k", inputs[0], k=k)

    @mapping_rule("InTopK", "InTopKV2")
    def _intopk(ctx, node, inputs, attrs):
        if node.op == "InTopKV2":
            k = int(np.asarray(ctx.const_value(node.input[2])).item())
        else:
            k = int(attrs["k"])
        return ctx.sd._op("in_top_k", inputs[0], inputs[1], k=k)

    @mapping_rule("MirrorPad")
    def _mirror_pad(ctx, node, inputs, attrs):
        pads = np.asarray(ctx.const_value(node.input[1])).tolist()
        return ctx.sd._op("mirror_pad", inputs[0], paddings=pads,
                          mode=attrs.get("mode", "REFLECT"))

    @mapping_rule("SpaceToBatchND", "BatchToSpaceND")
    def _sb_nd(ctx, node, inputs, attrs):
        block = np.asarray(ctx.const_value(node.input[1])).tolist()
        aux = np.asarray(ctx.const_value(node.input[2])).tolist()
        if node.op == "SpaceToBatchND":
            return ctx.sd._op("space_to_batch_nd", inputs[0],
                              block_shape=block, paddings=aux)
        return ctx.sd._op("batch_to_space_nd", inputs[0],
                          block_shape=block, crops=aux)

    @mapping_rule("SpaceToBatch", "BatchToSpace")
    def _sb(ctx, node, inputs, attrs):
        aux = np.asarray(ctx.const_value(node.input[1])).tolist()
        b = int(attrs["block_size"])
        if node.op == "SpaceToBatch":
            return ctx.sd._op("space_to_batch", inputs[0], block_size=b,
                              paddings=aux)
        return ctx.sd._op("batch_to_space", inputs[0], block_size=b,
                          crops=aux)

    @mapping_rule("SpaceToDepth", "DepthToSpace")
    def _sd_depth(ctx, node, inputs, attrs):
        name = ("space_to_depth" if node.op == "SpaceToDepth"
                else "depth_to_space")
        return ctx.sd._op(name, inputs[0],
                          block_size=int(attrs["block_size"]))

    @mapping_rule("MatrixBandPart", "BatchMatrixBandPart")
    def _band(ctx, node, inputs, attrs):
        lo = int(np.asarray(ctx.const_value(node.input[1])).item())
        hi = int(np.asarray(ctx.const_value(node.input[2])).item())
        return ctx.sd._op("matrix_band_part", inputs[0], lower=lo, upper=hi)

    @mapping_rule("HistogramFixedWidth")
    def _hfw(ctx, node, inputs, attrs):
        nbins = int(np.asarray(ctx.const_value(node.input[2])).item())
        return ctx.sd._op("histogram_fixed_width", inputs[0], inputs[1],
                          nbins=nbins)

    @mapping_rule("Bincount")
    def _bincount(ctx, node, inputs, attrs):
        if len(node.input) > 2:
            w = np.asarray(ctx.const_value(node.input[2]))
            if w.size:
                raise TFImportError("Bincount: weights unsupported")
        size = int(np.asarray(ctx.const_value(node.input[1])).item())
        return ctx.sd._op("bincount", inputs[0], minlength=size,
                          length=size)

    @mapping_rule("ClipByValue")
    def _clip(ctx, node, inputs, attrs):
        lo = float(np.asarray(ctx.const_value(node.input[1])).item())
        hi = float(np.asarray(ctx.const_value(node.input[2])).item())
        return ctx.sd._op("clipbyvalue", inputs[0], lo=lo, hi=hi)

    @mapping_rule("UnsortedSegmentSum", "UnsortedSegmentMax",
                  "UnsortedSegmentMin", "UnsortedSegmentProd")
    def _useg(ctx, node, inputs, attrs):
        n = int(np.asarray(ctx.const_value(node.input[2])).item())
        kind = node.op.replace("UnsortedSegment", "").lower()
        return ctx.sd._op(f"unsorted_segment_{kind}", inputs[0], inputs[1],
                          num_segments=n)

    @mapping_rule("SparseToDense")
    def _sparse_to_dense(ctx, node, inputs, attrs):
        shape = np.asarray(ctx.const_value(node.input[1])).tolist()
        default = float(np.asarray(ctx.const_value(node.input[3])).item())
        return ctx.sd._op("sparse_to_dense", inputs[0], inputs[2],
                          dense_shape=shape, default_value=default)

    @mapping_rule("ResizeBilinear", "ResizeNearestNeighbor",
                  "ResizeBicubic", "ResizeArea")
    def _resize_rule(ctx, node, inputs, attrs):
        if attrs.get("align_corners"):
            raise TFImportError(f"{node.op}: align_corners=True grid "
                                f"unsupported")
        # ResizeArea has no half_pixel_centers attr (and our lowering is
        # the documented linear approximation); the others must use the
        # modern half-pixel grid
        if node.op != "ResizeArea" and not attrs.get("half_pixel_centers",
                                                     False):
            raise TFImportError(
                f"{node.op}: only the half-pixel grid is supported "
                f"(tf.image.resize / half_pixel_centers=True); the legacy "
                f"asymmetric grid is not")
        size = [int(v) for v in np.asarray(ctx.const_value(node.input[1]))]
        name = {"ResizeBilinear": "resize_bilinear",
                "ResizeNearestNeighbor": "resize_nearest_neighbor",
                "ResizeBicubic": "resize_bicubic",
                "ResizeArea": "resize_area"}[node.op]
        return ctx.sd._op(name, inputs[0], size=size)

    @mapping_rule("AdjustContrastv2", "AdjustSaturation", "AdjustHue")
    def _adjust(ctx, node, inputs, attrs):
        factor = float(np.asarray(ctx.const_value(node.input[1])).item())
        name = {"AdjustContrastv2": "adjust_contrast",
                "AdjustSaturation": "adjust_saturation",
                "AdjustHue": "adjust_hue"}[node.op]
        kw = ("delta" if node.op == "AdjustHue" else "factor")
        return ctx.sd._op(name, inputs[0], **{kw: factor})

    @mapping_rule("CropAndResize")
    def _crop_resize(ctx, node, inputs, attrs):
        size = [int(v) for v in np.asarray(ctx.const_value(node.input[3]))]
        return ctx.sd._op("crop_and_resize", inputs[0], inputs[1],
                          inputs[2], crop_size=size)

    @mapping_rule("NonMaxSuppressionV3")
    def _nms(ctx, node, inputs, attrs):
        mx = int(np.asarray(ctx.const_value(node.input[2])).item())
        iou = float(np.asarray(ctx.const_value(node.input[3])).item())
        st = float(np.asarray(ctx.const_value(node.input[4])).item())
        return ctx.sd._op("non_max_suppression", inputs[0], inputs[1],
                          max_output_size=mx, iou_threshold=iou,
                          score_threshold=st)

    @mapping_rule("FakeQuantWithMinMaxArgs")
    def _fq_args(ctx, node, inputs, attrs):
        return ctx.sd._op("fake_quant_with_min_max_args", inputs[0],
                          min=float(attrs.get("min", -6.0)),
                          max=float(attrs.get("max", 6.0)),
                          num_bits=int(attrs.get("num_bits", 8)),
                          narrow_range=bool(attrs.get("narrow_range",
                                                      False)))

    @mapping_rule("FakeQuantWithMinMaxVars")
    def _fq_vars(ctx, node, inputs, attrs):
        return ctx.sd._op("fake_quant_with_min_max_vars", inputs[0],
                          inputs[1], inputs[2],
                          num_bits=int(attrs.get("num_bits", 8)),
                          narrow_range=bool(attrs.get("narrow_range",
                                                      False)))

    @mapping_rule("LRN")
    def _lrn_rule(ctx, node, inputs, attrs):
        return ctx.sd._op("lrn", inputs[0],
                          depth_radius=int(attrs.get("depth_radius", 5)),
                          bias=float(attrs.get("bias", 1.0)),
                          alpha=float(attrs.get("alpha", 1.0)),
                          beta=float(attrs.get("beta", 0.5)))

    @mapping_rule("Conv2DBackpropInput")
    def _deconv_rule(ctx, node, inputs, attrs):
        st = attrs.get("strides", [1, 1, 1, 1])
        pad = attrs.get("padding", "SAME")
        # lax.conv_transpose SAME always yields in*stride; TF records the
        # true forward-input size — when it is STATICALLY known, reject
        # odd-size gradients we cannot reproduce rather than silently
        # misalign the grid (dynamic input_sizes skips the validation)
        try:
            sizes = np.asarray(ctx.const_value(node.input[0])).tolist()
        except TFImportError:
            sizes = None
        in_shape = inputs[2].shape
        if sizes is not None and pad.upper() == "SAME" \
                and in_shape is not None and None not in in_shape[1:3]:
            want_h, want_w = int(sizes[1]), int(sizes[2])
            got_h = int(in_shape[1]) * int(st[1])
            got_w = int(in_shape[2]) * int(st[2])
            if (want_h, want_w) != (got_h, got_w):
                raise TFImportError(
                    f"Conv2DBackpropInput: recorded input_sizes "
                    f"({want_h}, {want_w}) != stride-inferred "
                    f"({got_h}, {got_w}) — odd-size SAME transposes are "
                    f"unsupported")
        # TF's op is the conv GRADIENT: lax applies the spatial flip +
        # channel swap itself under transpose_kernel=True, taking the
        # filter in TF's own (H, W, out, in) layout unmodified
        return ctx.sd._op("deconv2d", inputs[2], inputs[1],
                          strides=(int(st[1]), int(st[2])),
                          padding=pad, transpose_kernel=True)

    @mapping_rule("Conv3D")
    def _conv3d_rule(ctx, node, inputs, attrs):
        s = attrs.get("strides", [1, 1, 1, 1, 1])
        return ctx.sd._op("conv3d", inputs[0], inputs[1],
                          strides=tuple(int(v) for v in s[1:4]),
                          padding=attrs.get("padding", "SAME"))

    @mapping_rule("MaxPool3D", "AvgPool3D")
    def _pool3d(ctx, node, inputs, attrs):
        k = attrs.get("ksize", [1, 2, 2, 2, 1])
        s = attrs.get("strides", [1, 2, 2, 2, 1])
        name = "maxpool3d" if node.op == "MaxPool3D" else "avgpool3d"
        return ctx.sd._op(name, inputs[0],
                          kernel=tuple(int(v) for v in k[1:4]),
                          strides=tuple(int(v) for v in s[1:4]),
                          padding=attrs.get("padding", "VALID"))

    @mapping_rule("Dilation2D")
    def _dilation_rule(ctx, node, inputs, attrs):
        s = attrs.get("strides", [1, 1, 1, 1])
        r = attrs.get("rates", [1, 1, 1, 1])
        return ctx.sd._op("dilation2d", inputs[0], inputs[1],
                          strides=(int(s[1]), int(s[2])),
                          rates=(int(r[1]), int(r[2])),
                          padding=attrs.get("padding", "SAME"))

    @mapping_rule("MaxPoolWithArgmax")
    def _mpargmax(ctx, node, inputs, attrs):
        k = attrs.get("ksize", [1, 2, 2, 1])
        s = attrs.get("strides", [1, 2, 2, 1])
        return ctx.sd._op("maxpool_with_argmax", inputs[0],
                          kernel=(int(k[1]), int(k[2])),
                          strides=(int(s[1]), int(s[2])),
                          padding=attrs.get("padding", "VALID"))

    @mapping_rule("ExtractImagePatches")
    def _patches(ctx, node, inputs, attrs):
        k = attrs.get("ksizes", [1, 2, 2, 1])
        s = attrs.get("strides", [1, 1, 1, 1])
        r = attrs.get("rates", [1, 1, 1, 1])
        return ctx.sd._op("extract_image_patches", inputs[0],
                          ksizes=(int(k[1]), int(k[2])),
                          strides=(int(s[1]), int(s[2])),
                          rates=(int(r[1]), int(r[2])),
                          padding=attrs.get("padding", "VALID"))


    # tranche 3: remaining raw-op passthroughs (registry alias == TF type)
    @mapping_rule("Mod", "TruncateMod")
    def _mod_trunc(ctx, node, inputs, attrs):
        # TF's raw Mod is the C-style TRUNCATED remainder for floats
        # (pinned by the negative-operand corpus case); FloorMod is floor
        return ctx.sd._op("truncatemod", *inputs)

    for op in ["BitwiseAnd", "BitwiseOr", "BitwiseXor", "IsNan",
               "IsFinite", "Rank", "Size", "ListDiff",
               "TensorScatterAdd", "TensorScatterSub", "TensorScatterUpdate",
               "TruncateDiv", "Erfinv"]:
        @mapping_rule(op)
        def _pt3(ctx, node, inputs, attrs, _op=op):
            return ctx.sd._op(_op, *inputs)

    @mapping_rule("MatrixSolve")
    def _matrix_solve(ctx, node, inputs, attrs):
        a = inputs[0]
        if attrs.get("adjoint"):
            # real dtypes only (no complex in _TF_DTYPES): adjoint == T
            a = ctx.sd._op("matrix_transpose", a)
        return ctx.sd._op("solve", a, inputs[1])

    @mapping_rule("Diag")
    def _tf_diag(ctx, node, inputs, attrs):
        if inputs[0].shape is not None and len(inputs[0].shape) != 1:
            raise TFImportError(
                "Diag: only rank-1 input supported (TF's higher-rank "
                "(i..,j..) tensor-diag form is not)")
        return ctx.sd._op("diag", inputs[0])

    @mapping_rule("DiagPart")
    def _tf_diag_part(ctx, node, inputs, attrs):
        if inputs[0].shape is not None and len(inputs[0].shape) != 2:
            raise TFImportError(
                "DiagPart: only rank-2 input supported (TF's rank-2k "
                "form is not)")
        return ctx.sd._op("diag_part", inputs[0])

    @mapping_rule("LeftShift")
    def _lshift(ctx, node, inputs, attrs):
        return ctx.sd._op("shift_bits", *inputs)

    @mapping_rule("RightShift")
    def _rshift(ctx, node, inputs, attrs):
        return ctx.sd._op("rshift_bits", *inputs)

    @mapping_rule("TopK")
    def _topk_v1(ctx, node, inputs, attrs):
        return ctx.sd._op("top_k", inputs[0], k=int(attrs["k"]))

    @mapping_rule("BroadcastTo")
    def _broadcast_to(ctx, node, inputs, attrs):
        shape = [int(v) for v in np.asarray(ctx.const_value(node.input[1]))]
        return ctx.sd._op("broadcast_to", inputs[0], shape=tuple(shape))

    @mapping_rule("LinSpace")
    def _linspace(ctx, node, inputs, attrs):
        n = int(np.asarray(ctx.const_value(node.input[2])).item())
        return ctx.sd._op("linspace", inputs[0], inputs[1], num=n)

    @mapping_rule("ConfusionMatrix")
    def _confusion(ctx, node, inputs, attrs):
        # num_classes: explicit const input when given, else fold both
        # index inputs and take the max + 1
        try:
            n = int(np.asarray(ctx.const_value(node.input[2])).item())
        except (TFImportError, IndexError):
            a = np.asarray(ctx.const_value(node.input[0]))
            b = np.asarray(ctx.const_value(node.input[1]))
            n = int(max(a.max(), b.max())) + 1
        return ctx.sd._op("confusion_matrix", inputs[0], inputs[1],
                          num_classes=n)

    @mapping_rule("ScatterNd")
    def _scatter_nd_rule(ctx, node, inputs, attrs):
        shape = [int(v) for v in np.asarray(ctx.const_value(node.input[2]))]
        return ctx.sd._op("scatter_nd", inputs[0], inputs[1],
                          shape=tuple(shape))

    @mapping_rule("Qr")
    def _qr(ctx, node, inputs, attrs):
        mode = "complete" if attrs.get("full_matrices") else "reduced"
        return ctx.sd._op("qr", inputs[0], mode=mode)

    @mapping_rule("Svd")
    def _svd(ctx, node, inputs, attrs):
        # ours: (u, s, vh); TF: (s, u, v) with v NOT conjugate-transposed
        u, sdiag, vh = ctx.sd._op("svd", inputs[0],
                                  full_matrices=bool(
                                      attrs.get("full_matrices", 0)))
        v = ctx.sd._op("matrix_transpose", vh)
        return sdiag, u, v

    @mapping_rule("Bitcast")
    def _bitcast_rule(ctx, node, inputs, attrs):
        dt = _dtype_of(int(attrs.get("type", attrs.get("T", 1))))
        return ctx.sd._op("bitcast", inputs[0], dtype=dt)


_register_default_rules()
_register_extended_rules()


def _shape_template(ctx, dims_ref):
    """Fold a Pack of [Shape(v)[i] | const] elements into a template list
    of ints and (SDVariable, axis) pairs; None when the pattern differs."""
    pack = ctx.node_defs.get(dims_ref.split(":")[0])
    if pack is None or pack.op not in ("Pack", "pack"):
        return None
    out = []
    for inp in pack.input:
        try:
            out.append(int(np.asarray(ctx.const_value(inp)).reshape(())))
            continue
        except TFImportError:
            pass
        ss = ctx.node_defs.get(inp.split(":")[0])
        if ss is None or ss.op != "StridedSlice":
            return None
        shp = ctx.node_defs.get(ss.input[0].split(":")[0])
        if shp is None or shp.op not in ("Shape", "ShapeN"):
            return None
        try:
            axis = int(np.asarray(ctx.const_value(ss.input[1])).reshape(-1)[0])
        except TFImportError:
            return None
        ref_var = ctx.vars.get(_fq(shp.input[0]))
        if ref_var is None:
            return None
        out.append((ref_var, axis))
    return out


def _fq(ref: str) -> str:
    """Normalize a tensor ref to 'node:index'. GraphDef refs are 'node' or
    'node:i'; FunctionDef refs are 'arg', 'node:out_name:i'."""
    if ref.count(":") >= 2:                 # FunctionDef 3-part form
        parts = ref.split(":")
        return f"{parts[0]}:{parts[-1]}"
    return ref if ":" in ref else ref + ":0"


def _topo_sorted(nodes):
    """Kahn-sort a node list on intra-list data+control edges, keeping the
    original order among simultaneously-ready nodes.

    TF does NOT guarantee GraphDef/FunctionDef node order is topological —
    function-body graphs in particular come out in hash order that varies
    with PYTHONHASHSEED (found as a flaky whole-suite import failure:
    'consumes unknown tensor ... ReadVariableOp'). External references
    (function args, captures, nodes of an outer graph) are not edges."""
    from collections import deque

    nodes = list(nodes)
    by_name = {n.name: n for n in nodes}
    indeg = {n.name: 0 for n in nodes}
    children = {n.name: [] for n in nodes}
    for n in nodes:
        for ref in n.input:
            base = ref.lstrip("^").split(":")[0]
            if base in by_name and base != n.name:
                indeg[n.name] += 1
                children[base].append(n.name)
    ready = deque(n.name for n in nodes if indeg[n.name] == 0)
    order = []
    while ready:
        nm = ready.popleft()
        order.append(by_name[nm])
        for ch in children[nm]:
            indeg[ch] -= 1
            if indeg[ch] == 0:
                ready.append(ch)
    if len(order) != len(nodes):      # cycle — impossible in a valid
        return nodes                  # GraphDef; fall back to input order
    return order


def _map_nodes(ctx: _ImportCtx, nodes, skip=frozenset()):
    """Shared per-node rule walk for GraphDef.node and FunctionDef.node_def."""
    for node in _topo_sorted(nodes):
        ctx.node_defs[node.name] = node
        if node.name in skip or node.op == "NoOp":
            continue
        if node.op == "Assert":
            # debug-only; Assert's output is never consumed as a tensor
            # (CheckNumerics, by contrast, is an inline identity and routes
            # through the Identity rule below)
            continue
        if node.op == "Const" and int(node.attr["dtype"].type) == 7:
            # DT_STRING constants only ever feed Assert/summary nodes in
            # inference graphs — nothing numeric can consume them
            continue
        rule = _RULES.get(node.op)
        if rule is None:
            raise TFImportError(
                f"No mapping rule for TF op {node.op!r} (node "
                f"{node.name!r}); register one with "
                f"@tfimport.mapping_rule({node.op!r})")
        inputs = []
        for ref in node.input:
            if ref.startswith("^"):      # control edge — execution order
                continue                 # is given by topo order already
            key = _fq(ref)
            if key not in ctx.vars:
                raise TFImportError(
                    f"node {node.name!r} consumes unknown tensor {ref!r} "
                    f"(GraphDef not topologically ordered?)")
            inputs.append(ctx.vars[key])
        attrs = _parse_attrs(node)
        try:
            out = rule(ctx, node, inputs, attrs)
        except _op_registry.UnknownOpError as e:
            raise TFImportError(
                f"TF op {node.op!r} (node {node.name!r}) maps to registry op "
                f"{e.name!r}, which the port's registry does not hold") from e
        outs = out if isinstance(out, (list, tuple)) else [out]
        for i, o in enumerate(outs):
            ctx.vars[f"{node.name}:{i}"] = o
        # canonical graph name: rename single-output ops to the tf name
        if len(outs) == 1 and outs[0].name != node.name \
                and node.name not in ctx.sd._vars:
            outs[0].rename(node.name)


def _emit_v1_loop(ctx: _ImportCtx, loop):
    """Rewrite one analyzed V1 frame into sd.while_loop (see
    tf_v1_control_flow module docstring)."""
    lib = ctx.library
    lv_refs = [e.input[0] for e in loop.enters]
    inv_refs = [e.input[0] for e in loop.inv_enters]
    operands = [ctx.vars[_fq(r)] for r in lv_refs + inv_refs]
    n_lv = len(loop.enters)

    def cond_build(sub, *state):
        c = _ImportCtx(sub, library=lib)
        for m, st in zip(loop.merges, state[:n_lv]):
            c.vars[m.name + ":0"] = st
        for e, st in zip(loop.inv_enters, state[n_lv:]):
            c.vars[e.name + ":0"] = st
        _map_nodes_auto(c, loop.cond_nodes)
        return c.vars[_fq(loop.loop_cond.input[0])]

    def body_build(sub, *state):
        c = _ImportCtx(sub, library=lib)
        for m, sw, st in zip(loop.merges, loop.switches, state[:n_lv]):
            c.vars[m.name + ":0"] = st
            if sw is not None:
                # Switch:1 (output_true) feeds the body; seed :0 too so any
                # stray consumer resolves to the same per-iteration value
                c.vars[sw.name + ":1"] = st
                c.vars[sw.name + ":0"] = st
        for e, st in zip(loop.inv_enters, state[n_lv:]):
            c.vars[e.name + ":0"] = st
        # _auto: a V1 tf.cond inside the body is rewritten recursively
        _map_nodes_auto(c, loop.body_nodes)
        outs = [c.vars[_fq(ni.input[0])] for ni in loop.next_iters]
        outs += list(state[n_lv:])        # invariants pass through unchanged
        return outs if len(outs) > 1 else outs[0]

    res = ctx.sd.while_loop(cond_build, body_build, *operands,
                            name=loop.frame.split("/")[-1] or "v1_while")
    res = res if isinstance(res, tuple) else (res,)
    for i, ex in enumerate(loop.exits):
        if ex is not None:
            ctx.vars[ex.name + ":0"] = res[i]


def _emit_v1_cond(ctx: _ImportCtx, group):
    """Rewrite one V1 tf.cond call (a CondGroup — possibly multi-output)
    into ONE sd.if_cond; branch nodes are traced once per branch, not once
    per output."""
    pred = ctx.vars[_fq(group.pred_ref)]
    operands = [ctx.vars[_fq(s.input[0])] for s in group.switches]

    def make(take_refs):
        def build(sub, *args):
            c = _ImportCtx(sub, library=ctx.library)
            for s, a in zip(group.switches, args):
                c.vars[s.name + ":0"] = a
                c.vars[s.name + ":1"] = a
            _map_nodes_auto(c, group.branch_nodes)
            outs = [c.vars[_fq(r)] for r in take_refs]
            return outs if len(outs) > 1 else outs[0]
        return build

    out = ctx.sd.if_cond(pred, make(group.true_refs),
                         make(group.false_refs), *operands,
                         name=group.merges[0].name.replace("/", "_"))
    outs = out if isinstance(out, tuple) else (out,)
    for m, o in zip(group.merges, outs):
        ctx.vars[m.name + ":0"] = o


def _cond_ready(ctx, group):
    return _fq(group.pred_ref) in ctx.vars and all(
        _fq(s.input[0]) in ctx.vars for s in group.switches)


def _map_nodes_v1(ctx: _ImportCtx, nodes, skip=frozenset()):
    """Node walk for GraphDefs containing V1 control flow: loop frames and
    Switch/Merge conds are emitted as functional composites at the point
    their outer inputs are all available; their internal nodes are skipped
    from the plain walk."""
    from deeplearning4j_tpu_torch.modelimport.tf_v1_control_flow import (
        analyze_conds, analyze_loops)

    try:
        loops = analyze_loops(nodes)
        loop_names = set().union(*(l.all_names for l in loops)) \
            if loops else set()
        conds = analyze_conds(nodes, loop_names)
    except ValueError as e:
        raise TFImportError(str(e)) from e
    member_loop = {}
    for l in loops:
        for nm in l.all_names:
            member_loop[nm] = l
    cond_by_merge = {}
    for c in conds:
        for m in c.merges:
            cond_by_merge[m.name] = c
    cond_skip = set().union(*(c.skip_names for c in conds)) \
        if conds else set()

    # V1 tf.cond pivot plumbing (the pred Switch + switch_t/switch_f/pred_id
    # Identities) is consumed only over CONTROL edges — sweep any leftover
    # Switch, and any Identity chained off a swept node, whose tensor
    # outputs have no live data consumer
    name_set = {n.name for n in nodes}
    data_consumers = {}
    for n in nodes:
        for ref in n.input:
            if not ref.startswith("^"):
                data_consumers.setdefault(ref.split(":")[0], set()) \
                    .add(n.name)
    by_name = {n.name: n for n in nodes}
    dead = set()
    changed = True
    while changed:
        changed = False
        for n in nodes:
            if n.name in dead or n.name in cond_skip:
                continue
            live = {c for c in data_consumers.get(n.name, set())
                    if c not in dead and c not in cond_skip
                    and c not in member_loop}
            if live:
                continue
            src = n.input[0].split(":")[0].lstrip("^") if n.input else None
            if n.op == "Switch" or (
                    n.op == "Identity" and src in dead) or (
                    n.op == "Identity" and src in name_set
                    and by_name[src].op == "Switch"
                    and n.name not in member_loop):
                if n.name not in member_loop and n.name not in cond_by_merge:
                    dead.add(n.name)
                    changed = True
    cond_skip |= dead

    emitted = set()
    plain = []

    def loop_ready(l):
        return all(_fq(e.input[0]) in ctx.vars
                   for e in l.enters + l.inv_enters)

    for node in nodes:
        l = member_loop.get(node.name)
        if l is not None:
            if id(l) not in emitted:
                # flush plain nodes mapped so far, then emit when the
                # outer inputs are all present (topo order ⇒ by the time
                # any Merge appears, Enter inputs were walked)
                _map_nodes(ctx, plain, skip=skip)
                plain = []
                if loop_ready(l):
                    _emit_v1_loop(ctx, l)
                    emitted.add(id(l))
            continue
        c = cond_by_merge.get(node.name)
        if c is not None:
            if id(c) not in emitted:
                _map_nodes(ctx, plain, skip=skip)
                plain = []
                if _cond_ready(ctx, c):
                    _emit_v1_cond(ctx, c)
                    emitted.add(id(c))
            continue
        if node.name in cond_skip:
            continue
        plain.append(node)
    _map_nodes(ctx, plain, skip=skip)
    # hash-ordered node lists can place a region's outer producers AFTER
    # every member node, so the in-walk readiness checks all miss; retry
    # pending regions now that the final flush mapped everything else,
    # looping until a pass makes no progress (regions can unblock each
    # other — a cond feeding a loop's Enter)
    progress = True
    while progress:
        progress = False
        for l in loops:
            if id(l) not in emitted and loop_ready(l):
                _emit_v1_loop(ctx, l)
                emitted.add(id(l))
                progress = True
        for c in conds:
            if id(c) not in emitted and _cond_ready(ctx, c):
                _emit_v1_cond(ctx, c)
                emitted.add(id(c))
                progress = True
    missing = [l.frame for l in loops if id(l) not in emitted] \
        + [c.merges[0].name for c in conds if id(c) not in emitted]
    if missing:
        raise TFImportError(f"V1 control-flow regions never became "
                            f"emittable (inputs unmapped): {missing}")


def _map_nodes_auto(ctx: _ImportCtx, nodes, skip=frozenset()):
    """Plain walk, upgraded to the V1 control-flow walk when the node list
    itself contains Switch/Merge regions (cond-in-loop recursion)."""
    from deeplearning4j_tpu_torch.modelimport.tf_v1_control_flow import (
        has_v1_control_flow)
    if has_v1_control_flow(nodes):
        _map_nodes_v1(ctx, nodes, skip=skip)
    else:
        _map_nodes(ctx, nodes, skip=skip)


def _fdef_builder(fdef, library):
    """FunctionDef → a control-flow body builder fn(sub_sd, *args)."""
    def build(sub_sd, *args):
        ctx = _ImportCtx(sub_sd, library=library)
        for i, arg in enumerate(fdef.signature.input_arg):
            ctx.vars[f"{arg.name}:0"] = args[i]
        _map_nodes(ctx, fdef.node_def)
        outs = [ctx.vars[_fq(fdef.ret[oarg.name])]
                for oarg in fdef.signature.output_arg]
        return outs if len(outs) > 1 else outs[0]
    return build


_FUNC_WRAPPER = re.compile(r"(^|.*/)Func/.*/(input|output)/_\d+$")


def _elide_func_wrappers(nodes):
    """Drop the pass-through Identity nodes TF's function INLINER inserts
    (``Func/<scope>/input/_k`` / ``output/_k``) when control flow is lowered
    (``lower_control_flow=True``), rewiring consumers to the wrapped tensor.
    The V1 frame analyzer partitions nodes by Enter/Exit frames; these
    wrappers sit OUTSIDE the frames while referencing tensors inside them,
    which otherwise breaks the partition (round-3 finding)."""
    # a wrapper is a pass-through when its one DATA input is first and any
    # remaining inputs are control edges — which this importer drops
    # globally by design (functional executor; ordering comes from the
    # topo walk, see the control-edge skip in _map_nodes)
    subst = {n.name: n.input[0] for n in nodes
             if n.op == "Identity" and _FUNC_WRAPPER.match(n.name)
             and n.input and not n.input[0].startswith("^")
             and all(r.startswith("^") for r in n.input[1:])}
    if not subst:
        return nodes

    def resolve(ref):
        ctrl = ref.startswith("^")
        base = ref.lstrip("^").split(":")[0]
        suffix = None
        seen = set()
        while base in subst:
            if base in seen:
                raise TFImportError(
                    f"cyclic Func-wrapper chain at {base!r}")
            seen.add(base)
            nxt = subst[base]
            base = nxt.lstrip("^").split(":")[0]
            suffix = nxt.split(":", 1)[1] if ":" in nxt else None
        if not seen:
            return ref
        if ctrl:
            return "^" + base
        return base + (":" + suffix if suffix else "")

    out = []
    for n in nodes:
        if n.name in subst:
            continue
        new_inputs = [resolve(ref) for ref in n.input]
        if new_inputs != list(n.input):
            # copy before rewiring: the caller's GraphDef stays untouched
            copied = type(n)()
            copied.CopyFrom(n)
            del copied.input[:]
            copied.input.extend(new_inputs)
            n = copied
        out.append(n)
    return out


class TFGraphMapper:
    """ref: TFGraphMapper#importGraph — GraphDef → SameDiff."""

    @staticmethod
    def import_graph(graph_def, ignore_nodes=(), device=None) -> SameDiff:
        """A GraphDef (a parsed one, its serialized bytes, or a path to
        them, ``.gz`` gunzipped) as a SameDiff on ``device`` (None: the
        card)."""
        gd = _as_graph_def(graph_def)
        sd = SameDiff.create(device)
        library = {f.signature.name: f
                   for f in getattr(gd, "library", ()).function} \
            if gd.HasField("library") else {}
        ctx = _ImportCtx(sd, library=library)
        from deeplearning4j_tpu_torch.modelimport.tf_v1_control_flow import (
            has_v1_control_flow)
        nodes = _elide_func_wrappers(list(gd.node))
        if has_v1_control_flow(nodes):
            _map_nodes_v1(ctx, nodes, skip=set(ignore_nodes))
        else:
            _map_nodes(ctx, nodes, skip=set(ignore_nodes))
        return sd

    importGraph = import_graph


def _as_graph_def(graph_def):
    """A parsed GraphDef passes through; bytes and paths are read by the
    port's wire codec."""
    if hasattr(graph_def, "node"):
        return graph_def
    if isinstance(graph_def, str):
        return tf_proto.read_graph_def(graph_def)
    return tf_proto.parse_graph_def(bytes(graph_def))


def _register_tail_rules():
    """Round-3 long-tail sweep: the last common-GraphDef ops a probe of
    ~140 frequently-exported op types found missing."""

    @mapping_rule("AddN")
    def _addn(ctx, node, inputs, attrs):
        if len(inputs) == 1:               # N=1 (grappler/gradient forms):
            return ctx.sd._op("Identity", inputs[0])   # rename-safe
        acc = inputs[0]
        for x in inputs[1:]:
            acc = ctx.sd._op("Add", acc, x)
        return acc

    @mapping_rule("Div")
    def _div(ctx, node, inputs, attrs):
        # TF Div: plain division on floats (x/0 = ±inf), truncation toward
        # zero on integers — pick by operand dtype
        import numpy as np
        if np.issubdtype(_np_dtype(inputs[0]), np.integer):
            return ctx.sd._op("truncatediv", *inputs)
        return ctx.sd._op("RealDiv", *inputs)

    @mapping_rule("DivNoNan")
    def _div_no_nan(ctx, node, inputs, attrs):
        return ctx.sd._op("divide_no_nan", *inputs)

    @mapping_rule("IdentityN")
    def _identity_n(ctx, node, inputs, attrs):
        if len(inputs) == 1:
            # single output rides the normal rename path — emit a real op
            # so renaming cannot strip the PRODUCER's (or a placeholder's)
            # name
            return ctx.sd._op("Identity", inputs[0])
        # multi-output: alias the inputs directly (consumed as node:i refs,
        # never renamed); creating named Identity ops here could steal the
        # bare name "Identity" from a later graph-output node
        return list(inputs)

    @mapping_rule("Invert")
    def _invert(ctx, node, inputs, attrs):
        return ctx.sd._op("bitwise_not", inputs[0])

    @mapping_rule("RandomStandardNormal", "RandomUniform")
    def _tf_random(ctx, node, inputs, attrs):
        import numpy as np
        dims = ctx.const_value(node.input[0])   # raises if not foldable
        shape = tuple(int(d) for d in np.asarray(dims).reshape(-1))
        s1 = int(attrs.get("seed", 0))
        s2 = int(attrs.get("seed2", 0))
        # TF draws from the PAIR (graph seed, per-op seed): mix both so
        # ops sharing a graph-level seed still differ
        seed = (hash((s1, s2)) & 0x7FFFFFFF) if (s1 or s2) else 0
        if not seed:
            # one compiled program = one baked key: an unseeded TF random
            # draws FRESH values per session.run, but here the draw is
            # fixed at import time. Make that loud, and derive a
            # per-import seed so separate imports at least differ.
            import warnings
            seed = int(np.random.default_rng().integers(0, 2 ** 31 - 1))
            warnings.warn(
                f"{node.op} {node.name!r} has no seed: the draw is "
                f"fixed per import (TF would redraw per "
                f"run); set the seed attr for reproducibility",
                stacklevel=2)
        op = ("random_normal_gen" if node.op == "RandomStandardNormal"
              else "random_uniform_gen")
        out = ctx.sd._op(op, shape=shape, seed=seed)
        dt = _dtype_of(int(attrs.get("dtype", 1)))
        if str(dt) != "float32":
            out = ctx.sd._op("Cast", out, dtype=dt)
        return out

    @mapping_rule("DynamicStitch", "ParallelDynamicStitch")
    def _dynamic_stitch(ctx, node, inputs, attrs):
        # TF contract: merged.shape[0] = max(indices) + 1, duplicates
        # resolved last-wins. A static output shape therefore needs the
        # indices to be constant-foldable (they are in the partition/
        # stitch patterns TF emits); the merge then compiles to ONE gather
        # with a host-computed source plan — no scatter ordering hazards.
        import numpy as np
        n = int(attrs.get("N", len(inputs) // 2))
        data = inputs[n:]
        try:
            idx_vals = [np.asarray(ctx.const_value(r)).reshape(-1)
                        for r in node.input[:n]]
        except TFImportError:
            raise TFImportError(
                f"{node.op} {node.name!r}: indices must be "
                "constant-foldable — the output row count max(indices)+1 "
                "must be static")
        # element shape = data rank minus the indices rank (indices may
        # be scalar, 1-D, or higher — TF flattens index-major)
        idx_raw = [np.asarray(ctx.const_value(r))
                   for r in node.input[:n]]
        elem = tuple(int(d) for d in
                     (data[0].shape or ())[idx_raw[0].ndim:])
        flat_data = ctx.sd._op(
            "concat", *[ctx.sd._op("Reshape", d, shape=(-1,) + elem)
                        for d in data], axis=0) if n > 1 else \
            ctx.sd._op("Reshape", data[0], shape=(-1,) + elem)
        all_idx = np.concatenate(idx_vals)
        rows = int(all_idx.max()) + 1 if all_idx.size else 0
        src = np.zeros(rows, np.int64)
        for flat_pos, out_row in enumerate(all_idx):   # last write wins
            src[int(out_row)] = flat_pos
        return ctx.sd._op("gather", flat_data,
                          ctx.sd.constant(src), axis=0)

    @mapping_rule("DynamicPartition")
    def _dynamic_partition(ctx, node, inputs, attrs):
        raise TFImportError(
            "DynamicPartition has data-dependent output shapes, which the "
            "graph engine does not represent; restructure with "
            "masks/Where-free selects (the eager registry op "
            "'dynamic_partition' covers host-side use)")

    @mapping_rule("Where")
    def _where_tf(ctx, node, inputs, attrs):
        raise TFImportError(
            "TF Where (coordinate list) has a data-dependent output shape; "
            "use Select/SelectV2 masks instead "
            "(eager: ops registry 'nonzero_coords')")

    @mapping_rule("TensorListFromTensor", "TensorListStack",
                  "TensorListReserve", "TensorListGetItem",
                  "TensorListSetItem")
    def _tensor_list(ctx, node, inputs, attrs, _op=None):
        raise TFImportError(
            f"{node.op}: TensorList (TensorArray v2) ops are unsupported "
            "— restructure the loop to accumulate into a fixed-shape "
            "tensor (e.g. tensor_scatter_nd_update at the loop index), "
            "which the counted-While lowering trains through")


_register_tail_rules()
