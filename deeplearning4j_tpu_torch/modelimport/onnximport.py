"""ONNX model import into the port's graph engine: counterpart of
``deeplearning4j_tpu/modelimport/onnximport.py`` (ref:
``samediff-import-onnx``'s ``OnnxOpMappingRegistry``).

A per-op mapping-rule registry, the reference's rules one for one, walks
the graph's nodes in order and emits registry ops into a
:class:`SameDiff`; structural inputs (shapes, axes, pads, scales) are
constants or constant-folded at import. The proto is read by the port's
own wire codec (``onnx_proto``): no ``onnx`` package.

- ONNX is NCHW/OIHW: Conv, pooling and BatchNormalization map to the
  registry's ``*_nchw`` ops (cuDNN's convolutions on the card).
- Initializers import as constants, or with ``trainable=True`` the float
  ones as variables that ``SameDiff.fit`` trains.
- ``If``, ``Loop`` and ``Scan`` become the engine's ``if_cond`` and
  ``while_loop``; a subgraph's output shapes are learnt by tracing it into
  a scratch graph, whose shape inference runs each op on ``device="meta"``
  tensors (``ops/registry.py``'s ``infer_shape``).
- The graph lives on ``device`` (None: the card); the caller asks for the
  CPU with ``device="cpu"``.
- The refusals are the reference's, message for message: data-dependent
  shapes (``NonZero``, ``Unique``), sequence and string values.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, SDVariable
from deeplearning4j_tpu_torch.modelimport import onnx_proto as op_
from deeplearning4j_tpu_torch.ops import dtypes as _dt

_ONNX_RULES: Dict[str, Callable] = {}


def onnx_rule(*op_types):
    def deco(fn):
        for t in op_types:
            _ONNX_RULES[t] = fn
        return fn
    return deco


class ONNXImportError(ValueError):
    pass


def _is_int(var) -> bool:
    """Whether a graph variable holds integers (ONNX Div truncates
    them)."""
    dt = var.dtype
    return dt is not None and not dt.is_floating_point and \
        not dt.is_complex and dt != torch.bool


class _Ctx:
    def __init__(self, sd: SameDiff):
        self.sd = sd
        self.vars: Dict[str, SDVariable] = {}
        self.consts: Dict[str, np.ndarray] = {}

    def const(self, name: Optional[str], default=None) -> np.ndarray:
        if not name:                      # optional input omitted ('')
            if default is not None:
                return default
            raise ONNXImportError("missing required constant input")
        if name in self.consts:
            return self.consts[name]
        var = self.vars.get(name)
        if var is not None:               # constant-fold computed structurals
            from deeplearning4j_tpu_torch.modelimport.common import (
                fold_constant)
            arr = fold_constant(self.sd, var)
            if arr is not None:
                self.consts[name] = arr
                return arr
        raise ONNXImportError(
            f"input {name!r} must be a constant (or constant-foldable) "
            f"structural argument")


def _attrs(node: dict) -> dict:
    out = {}
    for a in node.get("attribute", []):
        t = a.get("type", 0)
        if t == 1:
            out[a["name"]] = a.get("f", 0.0)
        elif t == 2:
            out[a["name"]] = a.get("i", 0)
        elif t == 3:
            out[a["name"]] = a.get("s", b"").decode()
        elif t == 4:
            out[a["name"]] = op_.tensor_to_np(a["t"])
        elif t == 5:                       # GRAPH — subgraph (If/Loop/Scan)
            out[a["name"]] = a.get("g")
        elif t == 6:
            out[a["name"]] = a.get("floats", [])
        elif t == 7:
            out[a["name"]] = [int(x) for x in a.get("ints", [])]
        else:
            out[a["name"]] = a.get("i", a.get("f", a.get("s")))
    return out


def _pads(attrs, spatial: int):
    """ONNX pads [x1_b, x2_b, ..., x1_e, x2_e] → lax [(b, e), ...]."""
    auto = attrs.get("auto_pad", "NOTSET")
    if auto and auto not in ("NOTSET",):
        if auto == "VALID":
            return [(0, 0)] * spatial
        raise ONNXImportError(f"auto_pad={auto} unsupported; use explicit pads")
    p = attrs.get("pads", [0] * 2 * spatial)
    return [(int(p[i]), int(p[i + spatial])) for i in range(spatial)]


# -------------------------------------------------------------------- rules
def _axes_arg(ctx, node, attrs):
    """ONNX axes: attribute (opset < 18) or second input (opset >= 18).
    Returns (axes_list_or_None, is_empty) — empty axes pair with the
    noop_with_empty_axes=1 attr to mean "no reduction" per spec."""
    axes = attrs.get("axes")
    if axes is None and len(node.get("input", [])) > 1 and node["input"][1]:
        axes = [int(a) for a in
                np.asarray(ctx.const(node["input"][1])).reshape(-1)]
    if axes is None:
        return None, False
    axes = list(axes)
    return axes, len(axes) == 0


def _register_onnx_rules():
    def passthru(onnx_op, reg_op):
        @onnx_rule(onnx_op)
        def _r(ctx, node, inputs, attrs, _op=reg_op):
            return ctx.sd._op(_op, *inputs)

    @onnx_rule("Div")
    def _div(ctx, node, inputs, attrs):
        # ONNX Div truncates toward zero on integer tensors
        if _is_int(inputs[0]):
            return ctx.sd._op("TruncateDiv", *inputs)
        return ctx.sd._op("RealDiv", *inputs)

    for o, r in [
        ("Add", "Add"), ("Sub", "Sub"), ("Mul", "Mul"),
        ("Pow", "Pow"), ("Sqrt", "sqrt"), ("Exp", "exp"), ("Log", "log"),
        ("Abs", "abs"), ("Neg", "neg"), ("Erf", "erf"), ("Floor", "floor"),
        ("Ceil", "ceil"), ("Round", "round"), ("Sign", "sign"),
        ("Relu", "Relu"), ("Sigmoid", "Sigmoid"), ("Tanh", "Tanh"),
        ("Softplus", "Softplus"), ("Softsign", "Softsign"),
        ("Max", "Maximum"), ("Min", "Minimum"),
        ("Greater", "Greater"), ("GreaterOrEqual", "GreaterEqual"),
        ("Less", "Less"), ("LessOrEqual", "LessEqual"), ("Equal", "Equal"),
        ("And", "LogicalAnd"), ("Or", "LogicalOr"), ("Not", "LogicalNot"),
        ("Where", "Select"), ("MatMul", "MatMul"), ("Identity", "Identity"),
        ("Reciprocal", "reciprocal"), ("Sin", "sin"), ("Cos", "cos"),
    ]:
        passthru(o, r)

    @onnx_rule("Gelu")
    def _gelu(ctx, node, inputs, attrs):
        return ctx.sd._op("Gelu", inputs[0])

    @onnx_rule("LeakyRelu")
    def _leaky(ctx, node, inputs, attrs):
        return ctx.sd._op("LeakyRelu", inputs[0],
                          alpha=attrs.get("alpha", 0.01))

    @onnx_rule("Elu")
    def _elu(ctx, node, inputs, attrs):
        return ctx.sd._op("Elu", inputs[0])

    @onnx_rule("Clip")
    def _clip(ctx, node, inputs, attrs):
        lo = attrs.get("min")
        hi = attrs.get("max")
        if lo is None and len(node["input"]) > 1 and node["input"][1]:
            lo = float(ctx.const(node["input"][1]))
        if hi is None and len(node["input"]) > 2 and node["input"][2]:
            hi = float(ctx.const(node["input"][2]))
        return ctx.sd._op("clipbyvalue", inputs[0],
                          clip_value_min=lo if lo is not None else -np.inf,
                          clip_value_max=hi if hi is not None else np.inf)

    @onnx_rule("Gemm")
    def _gemm(ctx, node, inputs, attrs):
        a, b = inputs[0], inputs[1]
        y = ctx.sd._op("MatMul", a, b,
                       transpose_a=bool(attrs.get("transA", 0)),
                       transpose_b=bool(attrs.get("transB", 0)))
        alpha = attrs.get("alpha", 1.0)
        beta = attrs.get("beta", 1.0)
        if alpha != 1.0:
            y = y * alpha
        if len(inputs) > 2:
            c = inputs[2]
            y = y + (c * beta if beta != 1.0 else c)
        return y

    @onnx_rule("Softmax")
    def _softmax(ctx, node, inputs, attrs):
        return ctx.sd._op("Softmax", inputs[0], axis=attrs.get("axis", -1))

    @onnx_rule("LogSoftmax")
    def _logsoftmax(ctx, node, inputs, attrs):
        return ctx.sd._op("LogSoftmax", inputs[0], axis=attrs.get("axis", -1))

    @onnx_rule("Conv")
    def _conv(ctx, node, inputs, attrs):
        spatial = len(attrs.get("kernel_shape", [0, 0]))
        if spatial != 2:
            raise ONNXImportError("only Conv2D (4-D NCHW) supported")
        return ctx.sd._op(
            "conv2d_nchw", *inputs,
            strides=tuple(attrs.get("strides", [1] * spatial)),
            padding=_pads(attrs, spatial),
            dilation=tuple(attrs.get("dilations", [1] * spatial)),
            groups=attrs.get("group", 1))

    @onnx_rule("MaxPool")
    def _maxpool(ctx, node, inputs, attrs):
        k = attrs["kernel_shape"]
        # ONNX default stride is 1 per axis (overlapping windows), NOT k
        return ctx.sd._op("maxpool2d_nchw", inputs[0], kernel=tuple(k),
                          strides=tuple(attrs.get("strides", [1] * len(k))),
                          padding=_pads(attrs, len(k)))

    @onnx_rule("AveragePool")
    def _avgpool(ctx, node, inputs, attrs):
        k = attrs["kernel_shape"]
        return ctx.sd._op(
            "avgpool2d_nchw", inputs[0], kernel=tuple(k),
            strides=tuple(attrs.get("strides", [1] * len(k))),
            padding=_pads(attrs, len(k)),
            count_include_pad=bool(attrs.get("count_include_pad", 0)))

    @onnx_rule("GlobalAveragePool")
    def _gap(ctx, node, inputs, attrs):
        return ctx.sd._op("global_avgpool_nchw", inputs[0])

    @onnx_rule("BatchNormalization")
    def _bn(ctx, node, inputs, attrs):
        x, scale, b, mean, var = inputs[:5]
        return ctx.sd._op("batchnorm_nchw", x, scale, b, mean, var,
                          epsilon=attrs.get("epsilon", 1e-5))

    @onnx_rule("Dropout")
    def _dropout(ctx, node, inputs, attrs):
        return ctx.sd._op("Identity", inputs[0])   # inference import

    @onnx_rule("Flatten")
    def _flatten(ctx, node, inputs, attrs):
        axis = attrs.get("axis", 1)
        shp = inputs[0].shape or ()
        head, tail = shp[:axis], shp[axis:]
        dyn_head, dyn_tail = None in head, None in tail
        if dyn_head and dyn_tail:
            raise ONNXImportError(
                "Flatten: dynamic dims on both sides of the axis")
        lead = -1 if dyn_head else int(np.prod(head)) if head else 1
        rest = -1 if dyn_tail else int(np.prod(tail)) if tail else 1
        return ctx.sd._op("Reshape", inputs[0], shape=[lead, rest])

    @onnx_rule("Reshape")
    def _reshape(ctx, node, inputs, attrs):
        target = [int(s) for s in ctx.const(node["input"][1])]
        shp = inputs[0].shape
        if not attrs.get("allowzero", 0):
            target = [shp[i] if s == 0 else s for i, s in enumerate(target)]
        return ctx.sd._op("Reshape", inputs[0], shape=target)

    @onnx_rule("Transpose")
    def _transpose(ctx, node, inputs, attrs):
        return ctx.sd._op("Transpose", inputs[0],
                          perm=attrs.get("perm") or None)

    @onnx_rule("Concat")
    def _concat(ctx, node, inputs, attrs):
        return ctx.sd._op("Concat", *inputs, axis=attrs["axis"])

    @onnx_rule("Squeeze")
    def _squeeze(ctx, node, inputs, attrs):
        axes, _ = _axes_arg(ctx, node, attrs)
        return ctx.sd._op("Squeeze", inputs[0], axis=axes)

    @onnx_rule("Unsqueeze")
    def _unsqueeze(ctx, node, inputs, attrs):
        axes, _ = _axes_arg(ctx, node, attrs)
        out = inputs[0]
        for a in sorted(axes):
            out = ctx.sd._op("ExpandDims", out, axis=int(a))
        return out

    @onnx_rule("Gather")
    def _gather(ctx, node, inputs, attrs):
        return ctx.sd._op("Gather", inputs[0], inputs[1],
                          axis=attrs.get("axis", 0))

    @onnx_rule("Slice")
    def _slice(ctx, node, inputs, attrs):
        ins = node["input"]
        if "starts" in attrs:              # opset < 10 attribute form
            starts, ends = attrs["starts"], attrs["ends"]
            axes = attrs.get("axes")
            steps = None
        else:
            starts = [int(v) for v in ctx.const(ins[1])]
            ends = [int(v) for v in ctx.const(ins[2])]
            axes = ([int(v) for v in ctx.const(ins[3])]
                    if len(ins) > 3 and ins[3] else None)
            steps = ([int(v) for v in ctx.const(ins[4])]
                     if len(ins) > 4 and ins[4] else None)
        rank = len(inputs[0].shape)
        axes = axes if axes is not None else list(range(len(starts)))
        steps = steps if steps is not None else [1] * len(starts)
        INT_MAX = 2 ** 63 - 1
        begin = [None] * rank
        end = [None] * rank
        stride = [1] * rank
        for s, e, ax, st in zip(starts, ends, axes, steps):
            begin[ax] = None if abs(s) >= INT_MAX else s
            end[ax] = None if abs(e) >= INT_MAX - 1 else e
            stride[ax] = st
        return ctx.sd._op("StridedSlice", inputs[0], begin=begin, end=end,
                          strides=stride)

    @onnx_rule("Split")
    def _split(ctx, node, inputs, attrs):
        axis = attrs.get("axis", 0)
        sizes = attrs.get("split")
        if sizes is None and len(node["input"]) > 1 and node["input"][1]:
            sizes = [int(v) for v in ctx.const(node["input"][1])]
        n_out = len(node["output"])
        if sizes is None:
            return ctx.sd._op("Split", inputs[0], num_split=n_out, axis=axis,
                              n_out=n_out)
        return ctx.sd._op("SplitV", inputs[0], size_splits=sizes, axis=axis,
                          n_out=n_out)

    @onnx_rule("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
               "ReduceProd")
    def _reduce(ctx, node, inputs, attrs):
        reg = {"ReduceMean": "Mean", "ReduceSum": "Sum", "ReduceMax": "Max",
               "ReduceMin": "Min", "ReduceProd": "Prod"}[node["op_type"]]
        axes, empty = _axes_arg(ctx, node, attrs)
        if empty and attrs.get("noop_with_empty_axes"):
            return ctx.sd._op("Identity", inputs[0])
        return ctx.sd._op(reg, inputs[0],
                          axis=tuple(axes) if axes else None,
                          keepdims=bool(attrs.get("keepdims", 1)))

    @onnx_rule("ArgMax", "ArgMin")
    def _arg(ctx, node, inputs, attrs):
        out = ctx.sd._op(node["op_type"], inputs[0],
                         axis=attrs.get("axis", 0))
        if attrs.get("keepdims", 1):
            out = ctx.sd._op("ExpandDims", out, axis=attrs.get("axis", 0))
        return out

    @onnx_rule("Cast")
    def _cast(ctx, node, inputs, attrs):
        return ctx.sd._op("Cast", inputs[0],
                          dtype=op_.onnx_dtype(attrs["to"]).name)

    @onnx_rule("Shape")
    def _shape(ctx, node, inputs, attrs):
        shp = inputs[0].shape
        if shp is not None and all(d is not None for d in shp):
            arr = np.asarray(shp, np.int64)
            ctx.consts[node["output"][0]] = arr
            return ctx.sd.constant(arr, name=node["output"][0])
        return ctx.sd._op("Shape", inputs[0])

    @onnx_rule("Constant")
    def _constant(ctx, node, inputs, attrs):
        arr = attrs.get("value")
        if arr is None:
            for k in ("value_float", "value_int"):
                if k in attrs:
                    arr = np.asarray(attrs[k])
        arr = np.asarray(arr)
        ctx.consts[node["output"][0]] = arr
        return ctx.sd.constant(arr, name=node["output"][0])

    @onnx_rule("ConstantOfShape")
    def _const_of_shape(ctx, node, inputs, attrs):
        dims = [int(v) for v in ctx.const(node["input"][0])]
        val = attrs.get("value")
        val = np.zeros(1, np.float32) if val is None else np.asarray(val)
        arr = np.full(dims, val.reshape(-1)[0], dtype=val.dtype)
        ctx.consts[node["output"][0]] = arr
        return ctx.sd.constant(arr, name=node["output"][0])

    @onnx_rule("Range")
    def _range(ctx, node, inputs, attrs):
        start, limit, delta = (ctx.const(node["input"][i]) for i in range(3))
        arr = np.arange(np.asarray(start).item(), np.asarray(limit).item(),
                        np.asarray(delta).item(),
                        dtype=np.asarray(start).dtype)
        ctx.consts[node["output"][0]] = arr
        return ctx.sd.constant(arr, name=node["output"][0])

    @onnx_rule("Expand")
    def _expand(ctx, node, inputs, attrs):
        shape = [int(v) for v in ctx.const(node["input"][1])]
        return ctx.sd._op("broadcast_to", inputs[0], shape=shape)

    @onnx_rule("Tile")
    def _tile(ctx, node, inputs, attrs):
        reps = [int(v) for v in ctx.const(node["input"][1])]
        return ctx.sd._op("Tile", inputs[0], reps=reps)

    @onnx_rule("Pad")
    def _pad(ctx, node, inputs, attrs):
        pads = attrs.get("pads")
        if pads is None:
            pads = [int(v) for v in ctx.const(node["input"][1])]
        rank = len(pads) // 2
        paddings = [[pads[i], pads[i + rank]] for i in range(rank)]
        return ctx.sd._op("Pad", inputs[0], paddings=paddings)

    @onnx_rule("Einsum")
    def _einsum(ctx, node, inputs, attrs):
        return ctx.sd._op("Einsum", *inputs, equation=attrs["equation"])

    @onnx_rule("OneHot")
    def _onehot(ctx, node, inputs, attrs):
        depth = int(ctx.const(node["input"][1]))
        values = ctx.const(node["input"][2])   # [off, on]; sets output dtype
        return ctx.sd._op("OneHot", inputs[0], depth=depth,
                          on_value=values[1].item(),
                          off_value=values[0].item(),
                          axis=attrs.get("axis", -1),
                          dtype=np.dtype(values.dtype).name)


    # ---------------------------------------------------- opset long tail
    for o, r in [
        ("Tan", "tan"), ("Asin", "asin"), ("Acos", "acos"), ("Atan", "atan"),
        ("Sinh", "sinh"), ("Cosh", "cosh"), ("Asinh", "asinh"),
        ("Acosh", "acosh"), ("Atanh", "atanh"), ("Xor", "boolean_xor"),
        ("Selu", "selu"), ("Mish", "mish"), ("Expm1", "expm1"),
    ]:
        passthru(o, r)

    @onnx_rule("Sum")          # variadic elementwise ops
    def _vsum(ctx, node, inputs, attrs):
        out = inputs[0]
        for v in inputs[1:]:
            out = ctx.sd._op("Add", out, v)
        return out

    @onnx_rule("Mean")
    def _vmean(ctx, node, inputs, attrs):
        out = inputs[0]
        for v in inputs[1:]:
            out = ctx.sd._op("Add", out, v)
        return ctx.sd._op("Mul", out, ctx.sd.constant(
            np.float32(1.0 / len(inputs))))

    @onnx_rule("Mod")
    def _mod(ctx, node, inputs, attrs):
        if attrs.get("fmod", 0):
            raise ONNXImportError("Mod with fmod=1 (C-style) unsupported; "
                                  "only integer/floor Mod")
        return ctx.sd._op("FloorMod", *inputs)

    @onnx_rule("HardSwish")
    def _hard_swish(ctx, node, inputs, attrs):
        # onnx: x · max(0, min(1, x/6 + 1/2))
        x = inputs[0]
        ax = ctx.sd._op("Mul", x, ctx.sd.constant(np.float32(1.0 / 6.0)))
        axb = ctx.sd._op("Add", ax, ctx.sd.constant(np.float32(0.5)))
        return ctx.sd._op("Mul", x, ctx.sd._op("clipbyvalue", axb,
                                               lo=0.0, hi=1.0))

    @onnx_rule("HardSigmoid")
    def _hard_sigmoid(ctx, node, inputs, attrs):
        # onnx: max(0, min(1, alpha·x + beta))
        alpha = attrs.get("alpha", 0.2)
        beta = attrs.get("beta", 0.5)
        ax = ctx.sd._op("Mul", inputs[0], ctx.sd.constant(np.float32(alpha)))
        axb = ctx.sd._op("Add", ax, ctx.sd.constant(np.float32(beta)))
        return ctx.sd._op("clipbyvalue", axb, lo=0.0, hi=1.0)

    @onnx_rule("PRelu")
    def _prelu_rule(ctx, node, inputs, attrs):
        x, slope = inputs
        neg = ctx.sd._op("Mul", ctx.sd._op("minimum", x,
                                           ctx.sd.constant(np.float32(0.0))),
                         slope)
        pos = ctx.sd._op("Relu", x)
        return ctx.sd._op("Add", pos, neg)

    @onnx_rule("ThresholdedRelu")
    def _trelu(ctx, node, inputs, attrs):
        return ctx.sd._op("thresholdedrelu", inputs[0],
                          theta=attrs.get("alpha", 1.0))

    @onnx_rule("CumSum")
    def _cumsum(ctx, node, inputs, attrs):
        axis = int(ctx.const(node["input"][1]))
        return ctx.sd._op("cumsum", inputs[0], axis=axis,
                          exclusive=bool(attrs.get("exclusive", 0)),
                          reverse=bool(attrs.get("reverse", 0)))

    @onnx_rule("TopK")
    def _topk(ctx, node, inputs, attrs):
        k = int(ctx.const(node["input"][1]))
        if attrs.get("axis", -1) not in (-1,):
            raise ONNXImportError("TopK only supports the last axis")
        if not attrs.get("largest", 1):
            raise ONNXImportError("TopK largest=0 (smallest-k) unsupported")
        return ctx.sd._op("top_k", inputs[0], k=k, n_out=2)

    @onnx_rule("GatherND")
    def _gather_nd(ctx, node, inputs, attrs):
        if attrs.get("batch_dims", 0):
            raise ONNXImportError("GatherND batch_dims unsupported")
        return ctx.sd._op("gather_nd", inputs[0], inputs[1])

    @onnx_rule("ScatterND")
    def _scatter_nd(ctx, node, inputs, attrs):
        return ctx.sd._op("scatter_nd_update", *inputs)

    @onnx_rule("InstanceNormalization")
    def _instancenorm(ctx, node, inputs, attrs):
        # NCHW: normalize over spatial dims per channel per example
        x, scale, b = inputs
        eps = attrs.get("epsilon", 1e-5)
        mean = ctx.sd._op("reduce_mean", x, axis=(2, 3), keepdims=True)
        var = ctx.sd._op("reduce_variance", x, axis=(2, 3), keepdims=True)
        xc = ctx.sd._op("Sub", x, mean)
        denom = ctx.sd._op("sqrt", ctx.sd._op(
            "Add", var, ctx.sd.constant(np.float32(eps))))
        xn = ctx.sd._op("RealDiv", xc, denom)
        s4 = ctx.sd._op("reshape", scale, shape=[1, -1, 1, 1])
        b4 = ctx.sd._op("reshape", b, shape=[1, -1, 1, 1])
        return ctx.sd._op("Add", ctx.sd._op("Mul", xn, s4), b4)

    @onnx_rule("LayerNormalization")
    def _layernorm_rule(ctx, node, inputs, attrs):
        if attrs.get("axis", -1) != -1:
            raise ONNXImportError("LayerNormalization only supports axis=-1")
        x, scale = inputs[0], inputs[1]
        b = inputs[2] if len(inputs) > 2 else None
        out = ctx.sd._op("layer_norm", x, scale,
                         b if b is not None else
                         ctx.sd.constant(np.zeros(1, np.float32)),
                         epsilon=attrs.get("epsilon", 1e-5))
        return out

    @onnx_rule("DepthToSpace")
    def _d2s(ctx, node, inputs, attrs):
        # our op is NHWC; onnx is NCHW — transpose around it
        bs = attrs.get("blocksize", 2)
        nhwc = ctx.sd._op("transpose", inputs[0], perm=[0, 2, 3, 1])
        out = ctx.sd._op("depth_to_space", nhwc, block_size=bs)
        return ctx.sd._op("transpose", out, perm=[0, 3, 1, 2])

    @onnx_rule("SpaceToDepth")
    def _s2d(ctx, node, inputs, attrs):
        bs = attrs.get("blocksize", 2)
        nhwc = ctx.sd._op("transpose", inputs[0], perm=[0, 2, 3, 1])
        out = ctx.sd._op("space_to_depth", nhwc, block_size=bs)
        return ctx.sd._op("transpose", out, perm=[0, 3, 1, 2])

    @onnx_rule("ReduceL1")
    def _reduce_l1(ctx, node, inputs, attrs):
        axes = attrs.get("axes")
        return ctx.sd._op("reduce_norm1", inputs[0],
                          axis=tuple(axes) if axes else None,
                          keepdims=bool(attrs.get("keepdims", 1)))

    @onnx_rule("ReduceL2")
    def _reduce_l2(ctx, node, inputs, attrs):
        axes = attrs.get("axes")
        return ctx.sd._op("reduce_norm2", inputs[0],
                          axis=tuple(axes) if axes else None,
                          keepdims=bool(attrs.get("keepdims", 1)))

    @onnx_rule("Resize")
    def _resize(ctx, node, inputs, attrs):
        mode = attrs.get("mode", "nearest")
        ins = node["input"]
        # sizes (input 3) preferred; else scales (input 2)
        if len(ins) > 3 and ins[3]:
            sizes = [int(v) for v in ctx.const(ins[3])]
            out_h, out_w = sizes[2], sizes[3]
        elif len(ins) > 2 and ins[2]:
            scales = [float(v) for v in ctx.const(ins[2])]
            shape = ctx.vars[ins[0]].shape
            out_h = int(shape[2] * scales[2])
            out_w = int(shape[3] * scales[3])
        else:
            raise ONNXImportError("Resize needs sizes or scales")
        op = {"nearest": "resize_nearest_neighbor",
              "linear": "resize_bilinear",
              "cubic": "resize_bicubic"}.get(mode, "resize_bilinear")
        nhwc = ctx.sd._op("transpose", inputs[0], perm=[0, 2, 3, 1])
        out = ctx.sd._op(op, nhwc, size=(out_h, out_w))
        return ctx.sd._op("transpose", out, perm=[0, 3, 1, 2])


    # ------------------------------------------------ extended tranche
    def _rnn_fill(ctx, node, x, w, r, gates, b, states):
        """Substitute explicit zeros for omitted optional inputs — the op's
        positional signature must never see shifted slots."""
        d = w.shape[0] if w.shape else None
        hsz = r.shape[2] if r.shape else None
        if d is None or hsz is None:
            raise ONNXImportError(f"{node['op_type']}: W/R shapes must be "
                                  f"static")
        out = []
        if b is None:
            b = ctx.sd.constant(
                np.zeros((d, 2 * gates * hsz), np.float32))
        out.append(b)
        bsz = x.shape[1] if x.shape else None
        for st in states:
            if st is None:
                if bsz is None:
                    raise ONNXImportError(
                        f"{node['op_type']}: initial state required when "
                        f"the batch dimension is dynamic")
                st = ctx.sd.constant(np.zeros((d, bsz, hsz), np.float32))
            out.append(st)
        return tuple(out)

    def _rnn_slots(ctx, node, n_slots):
        """Positional recurrent-op inputs with ''-skipped optionals kept in
        their slots (the generic input list drops empty names)."""
        refs = list(node.get("input", [])) + [""] * n_slots
        return [ctx.vars.get(r) if r else None for r in refs[:n_slots]]

    @onnx_rule("LSTM")
    def _lstm(ctx, node, inputs, attrs):
        if attrs.get("activations"):
            raise ONNXImportError("LSTM with custom activations "
                                  "unsupported")
        if attrs.get("clip"):
            raise ONNXImportError("LSTM with clip unsupported")
        x, w, r, b, seq_lens, h0, c0, peep = _rnn_slots(ctx, node, 8)
        if seq_lens is not None:
            raise ONNXImportError("LSTM with sequence_lens unsupported")
        if peep is not None:
            raise ONNXImportError("LSTM with peephole weights unsupported")
        b, h0, c0 = _rnn_fill(ctx, node, x, w, r, gates=4,
                              b=b, states=[h0, c0])
        return ctx.sd._op("onnx_lstm", x, w, r, b, h0, c0,
                          direction=attrs.get("direction", "forward"))

    @onnx_rule("GRU")
    def _gru(ctx, node, inputs, attrs):
        if attrs.get("activations"):
            raise ONNXImportError("GRU with custom activations "
                                  "unsupported")
        x, w, r, b, seq_lens, h0 = _rnn_slots(ctx, node, 6)
        if seq_lens is not None:
            raise ONNXImportError("GRU with sequence_lens unsupported")
        b, h0 = _rnn_fill(ctx, node, x, w, r, gates=3, b=b, states=[h0])
        return ctx.sd._op("onnx_gru", x, w, r, b, h0,
                          direction=attrs.get("direction", "forward"),
                          linear_before_reset=int(
                              attrs.get("linear_before_reset", 0)))

    @onnx_rule("RNN")
    def _rnn(ctx, node, inputs, attrs):
        if attrs.get("activations"):
            raise ONNXImportError("RNN with custom activations "
                                  "unsupported")
        x, w, r, b, seq_lens, h0 = _rnn_slots(ctx, node, 6)
        if seq_lens is not None:
            raise ONNXImportError("RNN with sequence_lens unsupported")
        b, h0 = _rnn_fill(ctx, node, x, w, r, gates=1, b=b, states=[h0])
        return ctx.sd._op("onnx_rnn", x, w, r, b, h0,
                          direction=attrs.get("direction", "forward"))

    @onnx_rule("ConvTranspose")
    def _convt(ctx, node, inputs, attrs):
        spatial = len(attrs.get("kernel_shape", [0, 0]))
        if spatial != 2:
            raise ONNXImportError("only 2-D ConvTranspose supported")
        if any(attrs.get("output_padding", [])) or attrs.get("group", 1) != 1:
            raise ONNXImportError("ConvTranspose output_padding/groups "
                                  "unsupported")
        if any(v != 1 for v in attrs.get("dilations", [])):
            raise ONNXImportError("ConvTranspose dilations unsupported")
        if attrs.get("auto_pad") not in (None, "", "NOTSET"):
            raise ONNXImportError("ConvTranspose auto_pad unsupported "
                                  "(use explicit pads)")
        if attrs.get("output_shape"):
            raise ONNXImportError("ConvTranspose output_shape unsupported")
        pads = attrs.get("pads", [0] * 4)
        padding = ((pads[0], pads[2]), (pads[1], pads[3]))
        return ctx.sd._op("deconv2d_nchw", *inputs,
                          strides=tuple(attrs.get("strides", [1, 1])),
                          padding=padding)

    @onnx_rule("LRN")
    def _lrn(ctx, node, inputs, attrs):
        size = int(attrs.get("size", 5))
        if size % 2 == 0:
            raise ONNXImportError("LRN with even size unsupported "
                                  "(depth_radius windows are odd)")
        # our lrn is NHWC with depth_radius; ONNX size = full window
        x = ctx.sd._op("Transpose", inputs[0], perm=[0, 2, 3, 1])
        y = ctx.sd._op("lrn", x, depth_radius=(size - 1) // 2,
                       bias=float(attrs.get("bias", 1.0)),
                       alpha=float(attrs.get("alpha", 1e-4)) / size,
                       beta=float(attrs.get("beta", 0.75)))
        return ctx.sd._op("Transpose", y, perm=[0, 3, 1, 2])

    @onnx_rule("GroupNormalization")
    def _groupnorm(ctx, node, inputs, attrs):
        return ctx.sd._op("group_norm", *inputs,
                          num_groups=int(attrs["num_groups"]),
                          epsilon=float(attrs.get("epsilon", 1e-5)))

    @onnx_rule("ReduceLogSumExp", "ReduceSumSquare")
    def _reduce_extra(ctx, node, inputs, attrs):
        axes, empty = _axes_arg(ctx, node, attrs)
        if empty and attrs.get("noop_with_empty_axes"):
            return ctx.sd._op("Identity", inputs[0])
        axes = tuple(axes) if axes else None
        kd = bool(attrs.get("keepdims", 1))
        name = ("reduce_logsumexp_axes" if node["op_type"] ==
                "ReduceLogSumExp" else "reduce_sqnorm")
        return ctx.sd._op(name, inputs[0], axis=axes, keepdims=kd)

    @onnx_rule("Trilu")
    def _trilu(ctx, node, inputs, attrs):
        k = 0
        if len(inputs) > 1:
            k = int(np.asarray(ctx.const(node["input"][1])).item())
        return ctx.sd._op("trilu", inputs[0], k=k,
                          upper=bool(attrs.get("upper", 1)))

    @onnx_rule("Hardmax")
    def _hardmax(ctx, node, inputs, attrs):
        return ctx.sd._op("hardmax", inputs[0],
                          axis=int(attrs.get("axis", -1)))

    @onnx_rule("GlobalMaxPool")
    def _gmp(ctx, node, inputs, attrs):
        return ctx.sd._op("global_maxpool_nchw", inputs[0])

    @onnx_rule("IsInf")
    def _isinf(ctx, node, inputs, attrs):
        pos = bool(attrs.get("detect_positive", 1))
        neg = bool(attrs.get("detect_negative", 1))
        if pos and neg:
            return ctx.sd._op("isinf", inputs[0])
        inf = ctx.sd._op("isinf", inputs[0])
        sign_ok = (ctx.sd._op("Greater", inputs[0],
                              ctx.sd.constant(np.float32(0.0))) if pos
                   else ctx.sd._op("Less", inputs[0],
                                   ctx.sd.constant(np.float32(0.0))))
        return ctx.sd._op("boolean_and", inf, sign_ok)

    @onnx_rule("IsNaN")
    def _isnan(ctx, node, inputs, attrs):
        return ctx.sd._op("isnan", inputs[0])

    @onnx_rule("Det")
    def _det(ctx, node, inputs, attrs):
        return ctx.sd._op("matrix_determinant", inputs[0])

    @onnx_rule("ReverseSequence")
    def _revseq_onnx(ctx, node, inputs, attrs):
        return ctx.sd._op("reverse_sequence", inputs[0], inputs[1],
                          seq_axis=int(attrs.get("time_axis", 0)),
                          batch_axis=int(attrs.get("batch_axis", 1)))

    @onnx_rule("ScatterElements")
    def _scatter_el(ctx, node, inputs, attrs):
        return ctx.sd._op("scatter_elements", *inputs,
                          axis=int(attrs.get("axis", 0)),
                          reduction=attrs.get("reduction", "none"))

    @onnx_rule("Shrink")
    def _shrink(ctx, node, inputs, attrs):
        return ctx.sd._op("shrink", inputs[0],
                          bias=float(attrs.get("bias", 0.0)),
                          lambd=float(attrs.get("lambd", 0.5)))

    @onnx_rule("Celu")
    def _celu(ctx, node, inputs, attrs):
        return ctx.sd._op("celu", inputs[0],
                          alpha=float(attrs.get("alpha", 1.0)))



_register_onnx_rules()


def _walk_nodes(ctx: "_Ctx", graph: dict):
    """Map every node of ``graph`` through the rule registry into
    ``ctx.sd`` — shared by the top-level import and subgraph (If/Loop)
    body builders."""
    sd = ctx.sd
    for node in graph.get("node", []):
        rule = _ONNX_RULES.get(node.get("op_type"))
        if rule is None:
            raise ONNXImportError(
                f"No mapping rule for ONNX op {node.get('op_type')!r} "
                f"(node {node.get('name')!r}); register one with "
                f"@onnximport.onnx_rule({node.get('op_type')!r})")
        inputs = [ctx.vars[r] for r in node.get("input", []) if r]
        attrs = _attrs(node)
        out = rule(ctx, node, inputs, attrs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        for tensor_name, o in zip(node["output"], outs):
            ctx.vars[tensor_name] = o
            if o.name != tensor_name and tensor_name not in sd._vars:
                o.rename(tensor_name)


def _subgraph_captures(graph: dict, outer_ctx: "_Ctx") -> List[str]:
    """Outer-scope tensor names referenced by ``graph``'s nodes (ONNX
    subgraphs capture implicitly), in first-use order."""
    needed: List[str] = []

    def walk(g, local):
        local = set(local)
        local |= {i["name"] for i in g.get("initializer", [])}
        local |= {vi["name"] for vi in g.get("input", [])}
        for node in g.get("node", []):
            for r in node.get("input", []):
                if r and r not in local and r in outer_ctx.vars \
                        and r not in needed:
                    needed.append(r)
            for a in node.get("attribute", []):
                if a.get("type") == 5 and a.get("g"):
                    walk(a["g"], local)
            local |= set(node.get("output", []))

    walk(graph, set())
    return needed


def _subgraph_body(outer_ctx: "_Ctx", graph: dict, seed_names: List[str]):
    """Build an ``fn(sub_sd, *args)`` body that maps ``graph`` with
    ``seed_names[i]`` bound to ``args[i]`` and returns the graph outputs."""

    def body(sub_sd, *args):
        ctx2 = _Ctx(sub_sd)
        ctx2.consts.update(outer_ctx.consts)
        for nm, a in zip(seed_names, args):
            ctx2.vars[nm] = a
        for init in graph.get("initializer", []):
            arr = op_.tensor_to_np(init)
            ctx2.consts[init["name"]] = arr
            ctx2.vars[init["name"]] = sub_sd.constant(arr,
                                                      name=init["name"])
        _walk_nodes(ctx2, graph)
        outs = [ctx2.vars[o["name"]] for o in graph.get("output", [])]
        return outs if len(outs) != 1 else outs[0]

    return body


class _FakeVar:
    """Shape/dtype template standing in for an SDVariable when pre-tracing
    a subgraph against element (sliced) shapes."""

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


class OnnxGraphMapper:
    """ref: OnnxFrameworkImporter#runImport — ONNX ModelProto → SameDiff."""

    @staticmethod
    def import_model(model, trainable: bool = False,
                     device=None) -> SameDiff:
        """``model``: path, bytes, or a parsed dict from onnx_proto; the
        graph on ``device`` (None: the card).

        ``trainable=True`` imports float initializers as VARIABLEs
        (fine-tunable through ``sd.fit``) instead of CONSTANTs.
        """
        if not isinstance(model, dict):
            model = op_.parse_model(model)
        graph = model.get("graph") or {}
        sd = SameDiff.create(device)
        ctx = _Ctx(sd)
        for init in graph.get("initializer", []):
            arr = op_.tensor_to_np(init)
            ctx.consts[init["name"]] = arr
            if trainable and np.issubdtype(arr.dtype, np.floating) \
                    and arr.ndim >= 1:
                ctx.vars[init["name"]] = sd.var(init["name"], init=arr)
            else:
                ctx.vars[init["name"]] = sd.constant(arr, name=init["name"])
        for vi in graph.get("input", []):
            if vi["name"] in ctx.vars:
                continue                   # initializer re-listed as input
            tt = (vi.get("type") or {}).get("tensor_type") or {}
            shape_msg = tt.get("shape")
            if shape_msg is None:
                shape = None               # no shape field: truly unknown
            else:
                # empty dim list = a SCALAR (shape ()), not unknown —
                # collapsing () to None loses the rank and downstream
                # dtype inference (eval_shape can't run on shape None)
                shape = tuple(int(d["dim_value"]) if "dim_value" in d
                              else None for d in shape_msg.get("dim", []))
            dt = op_.onnx_dtype(tt.get("elem_type", 1))
            ctx.vars[vi["name"]] = sd.placeholder(vi["name"], shape, dt)
        _walk_nodes(ctx, graph)
        return sd

    importModel = import_model
    import_graph = import_model


# --------------------------------------------------------------------------
# rule tranche 2 (round 3): the remaining common-opset tail
def _register_onnx_rules_t2():
    @onnx_rule("Size")
    def _size(ctx, node, inputs, attrs):
        return ctx.sd._op("size", inputs[0])

    @onnx_rule("EyeLike")
    def _eyelike(ctx, node, inputs, attrs):
        if int(attrs.get("k", 0)) != 0:
            raise ONNXImportError("EyeLike with k != 0 unsupported")
        x = inputs[0]
        # ONNX contract: dtype attr wins, else the INPUT's dtype
        dt = (op_.onnx_dtype(attrs["dtype"]).name if "dtype" in attrs
              else _dt.name_of(x.dtype))
        # the identity as a constant: an op without tensor inputs would
        # make it on the host, whatever the graph's device
        e = ctx.sd.constant(np.eye(int(x.shape[-2]), int(x.shape[-1]),
                                   dtype=np.float32))
        return ctx.sd._op("Cast", e, dtype=dt)

    @onnx_rule("GatherElements")
    def _gather_elements(ctx, node, inputs, attrs):
        # take_along_axis semantics — the registry's scatter_elements dual
        return ctx.sd._op("gather_elements", *inputs,
                          axis=int(attrs.get("axis", 0)))

    @onnx_rule("ReduceLogSum")
    def _reduce_log_sum(ctx, node, inputs, attrs):
        axes, empty = _axes_arg(ctx, node, attrs)
        if empty and attrs.get("noop_with_empty_axes"):
            return ctx.sd._op("log", inputs[0])
        s = ctx.sd._op("reduce_sum", inputs[0],
                       axis=tuple(axes) if axes else None,
                       keepdims=bool(attrs.get("keepdims", 1)))
        return ctx.sd._op("log", s)

    @onnx_rule("NonMaxSuppression")
    def _nms(ctx, node, inputs, attrs):
        boxes, scores = inputs[0], inputs[1]
        if int(attrs.get("center_point_box", 0)) != 0:
            raise ONNXImportError(
                "NonMaxSuppression center_point_box=1 (center/width format) "
                "unsupported — convert boxes to corner coords first")
        max_out = int(np.asarray(ctx.const(node["input"][2], 0)).reshape(()))\
            if len(node.get("input", [])) > 2 and node["input"][2] else 0
        iou_t = float(np.asarray(ctx.const(node["input"][3], 0.5))
                      .reshape(())) if len(node.get("input", [])) > 3 \
            and node["input"][3] else 0.5
        score_t = float(np.asarray(ctx.const(node["input"][4], -np.inf))
                        .reshape(())) if len(node.get("input", [])) > 4 \
            and node["input"][4] else float("-inf")
        # single batch + single class only (the registry op's contract);
        # the batched/multi-class loop is a loud error, not a shape crash
        if len(boxes.shape) == 3 and boxes.shape[0] not in (1, None):
            raise ONNXImportError(
                "batched NonMaxSuppression (num_batches > 1) unsupported")
        if len(scores.shape) == 3 and scores.shape[1] not in (1, None):
            raise ONNXImportError(
                "multi-class NonMaxSuppression (num_classes > 1) unsupported")
        b2 = ctx.sd._op("Reshape", boxes, shape=(-1, 4))
        s2 = ctx.sd._op("Reshape", scores, shape=(-1,))
        # ONNX default max_output_boxes_per_class IS 0 = select nothing
        idx = ctx.sd._op("non_max_suppression", b2, s2,
                         max_output_size=max_out,
                         iou_threshold=iou_t, score_threshold=score_t)
        # ONNX layout: (num_selected, 3) rows of [batch, class, box_idx].
        # Whole-graph jit needs STATIC shapes, so num_selected is the padded
        # max_output_size with -1 rows for unselected slots (documented
        # divergence; the reference's dynamic row count cannot exist here)
        zeros = ctx.sd._op("zeros_as", idx)
        return ctx.sd._op("stack", zeros, zeros, idx, axis=1)

    @onnx_rule("NonZero")
    def _nonzero(ctx, node, inputs, attrs):
        # data-dependent output SHAPE cannot exist under whole-graph jit
        # (the executor emits ONE compiled program; SURVEY §3.3 north star).
        # A specific error beats the generic no-rule hint.
        raise ONNXImportError(
            "NonZero has a data-dependent output shape, which the "
            "whole-graph-jit executor cannot represent; replace it with a "
            "mask (Equal/Where) or precompute indices host-side "
            "(ops.registry 'nonzero_coords' works eagerly)")

    @onnx_rule("CastLike")
    def _castlike(ctx, node, inputs, attrs):
        return ctx.sd._op("cast", inputs[0],
                          dtype=_dt.name_of(inputs[1].dtype))

    @onnx_rule("Shrink")
    def _shrink(ctx, node, inputs, attrs):
        return ctx.sd._op("shrink", inputs[0],
                          lambd=float(attrs.get("lambd", 0.5)),
                          bias=float(attrs.get("bias", 0.0)))

    @onnx_rule("Bernoulli")
    def _bernoulli(ctx, node, inputs, attrs):
        # per-element probabilities (the input IS the p tensor)
        out = ctx.sd._op("bernoulli_sample", inputs[0],
                         seed=(int(attrs["seed"])
                               if attrs.get("seed") is not None else None))
        if "dtype" in attrs:
            out = ctx.sd._op("Cast", out,
                             dtype=op_.onnx_dtype(attrs["dtype"]).name)
        return out

    @onnx_rule("Multinomial")
    def _multinomial(ctx, node, inputs, attrs):
        seed = attrs.get("seed")
        out = ctx.sd._op("random_multinomial", inputs[0],
                         num_samples=int(attrs.get("sample_size", 1)),
                         seed=int(seed) if seed is not None else None)
        # spec default output dtype is int32; dtype attr overrides
        dt = (op_.onnx_dtype(attrs["dtype"]).name if "dtype" in attrs
              else "int32")
        return ctx.sd._op("Cast", out, dtype=dt)


_register_onnx_rules_t2()


# --------------------------------------------------------------------------
# rule tranche 3 (round 3, continued): control flow, quantized ops, image
# sampling, Lp family, random generators, and loud informative errors for
# the dynamic-shape / sequence-typed remainder
def _register_onnx_rules_t3():
    @onnx_rule("Upsample")
    def _upsample(ctx, node, inputs, attrs):
        # deprecated opset-9 alias of Resize: scales via input 1 (or the
        # even older 'scales' attr)
        mode = attrs.get("mode", "nearest")
        ins = node["input"]
        if len(ins) > 1 and ins[1]:
            scales = [float(v) for v in ctx.const(ins[1])]
        elif attrs.get("scales"):
            scales = [float(v) for v in attrs["scales"]]
        else:
            raise ONNXImportError("Upsample needs scales")
        shape = inputs[0].shape
        if len(shape) != 4 or len(scales) != 4:
            raise ONNXImportError(
                f"Upsample: only 4-D NCHW is supported (got rank "
                f"{len(shape)} input, {len(scales)} scales); use Resize "
                f"for other ranks")
        out_h = int(shape[2] * scales[2])
        out_w = int(shape[3] * scales[3])
        op = {"nearest": "resize_nearest_neighbor",
              "linear": "resize_bilinear"}.get(mode, "resize_bilinear")
        nhwc = ctx.sd._op("transpose", inputs[0], perm=[0, 2, 3, 1])
        out = ctx.sd._op(op, nhwc, size=(out_h, out_w))
        return ctx.sd._op("transpose", out, perm=[0, 3, 1, 2])

    @onnx_rule("Scatter")
    def _scatter_deprecated(ctx, node, inputs, attrs):
        # opset-9 deprecated alias of ScatterElements
        return ctx.sd._op("scatter_elements", *inputs,
                          axis=int(attrs.get("axis", 0)))

    @onnx_rule("LpNormalization")
    def _lp_norm(ctx, node, inputs, attrs):
        axis = int(attrs.get("axis", -1))
        p = int(attrs.get("p", 2))
        x = inputs[0]
        if p == 2:
            n = ctx.sd._op("reduce_norm2", x, axis=(axis,), keepdims=True)
        else:                              # p == 1
            n = ctx.sd._op("reduce_sum", ctx.sd._op("abs", x),
                           axis=(axis,), keepdims=True)
        return ctx.sd._op("div", x, n)

    @onnx_rule("LpPool")
    def _lp_pool(ctx, node, inputs, attrs):
        k = attrs["kernel_shape"]
        return ctx.sd._op("lp_pool2d_nchw", inputs[0], kernel=tuple(k),
                          strides=tuple(attrs.get("strides", [1] * len(k))),
                          padding=_pads(attrs, len(k)),
                          p=float(attrs.get("p", 2)))

    @onnx_rule("GlobalLpPool")
    def _global_lp_pool(ctx, node, inputs, attrs):
        h, w = inputs[0].shape[2], inputs[0].shape[3]
        return ctx.sd._op("lp_pool2d_nchw", inputs[0], kernel=(int(h),
                                                               int(w)),
                          p=float(attrs.get("p", 2)))

    @onnx_rule("MeanVarianceNormalization")
    def _mvn(ctx, node, inputs, attrs):
        axes = tuple(attrs.get("axes", [0, 2, 3]))
        x = inputs[0]
        mean = ctx.sd._op("reduce_mean", x, axis=axes, keepdims=True)
        centered = ctx.sd._op("subtract", x, mean)
        var = ctx.sd._op("reduce_mean", ctx.sd._op("square", centered),
                         axis=axes, keepdims=True)
        return ctx.sd._op("div", centered, ctx.sd._op("sqrt", var))

    @onnx_rule("SoftmaxCrossEntropyLoss")
    def _sce_loss(ctx, node, inputs, attrs):
        if attrs.get("ignore_index") is not None:
            raise ONNXImportError(
                "SoftmaxCrossEntropyLoss ignore_index unsupported")
        scores, labels = inputs[0], inputs[1]
        weights = inputs[2] if len(inputs) > 2 else None
        logp = ctx.sd._op("log_softmax", scores, axis=1)
        oh = ctx.sd._op("one_hot", labels, depth=int(scores.shape[1]),
                        axis=1)
        nll = ctx.sd._op("neg", ctx.sd._op(
            "reduce_sum", ctx.sd._op("multiply", logp, oh), axis=(1,)))
        if weights is not None:
            w_per = ctx.sd._op("gather", weights, labels, axis=0)
            nll = ctx.sd._op("multiply", nll, w_per)
        red = attrs.get("reduction", "mean")
        if red == "none":
            loss = nll
        elif red == "sum":
            loss = ctx.sd._op("reduce_sum", nll)
        elif weights is not None:
            # spec: weighted mean divides by the SUM OF WEIGHTS
            loss = ctx.sd._op("div", ctx.sd._op("reduce_sum", nll),
                              ctx.sd._op("reduce_sum", w_per))
        else:
            loss = ctx.sd._op("reduce_mean", nll)
        return [loss, logp]

    @onnx_rule("QuantizeLinear")
    def _quantize_linear(ctx, node, inputs, attrs):
        x = inputs[0]
        scale = np.asarray(ctx.const(node["input"][1]))
        ins = node.get("input", [])
        zp = (np.asarray(ctx.const(ins[2]))
              if len(ins) > 2 and ins[2] else np.zeros((), np.uint8))
        axis = int(attrs.get("axis", 1))
        qdt = zp.dtype
        lo, hi = np.iinfo(qdt).min, np.iinfo(qdt).max
        if scale.ndim == 1:                # per-axis: broadcast along axis
            bshape = [1] * len(x.shape)
            bshape[axis] = scale.shape[0]
            scale = scale.reshape(bshape)
            zp = zp.reshape(bshape) if zp.ndim == 1 else zp
        scaled = ctx.sd._op("div", x,
                            ctx.sd.constant(scale.astype(np.float32)))
        rounded = ctx.sd._op("rint", scaled)   # round half-to-even (spec)
        shifted = ctx.sd._op("add", rounded, ctx.sd.constant(
            zp.astype(np.float32)))
        clipped = ctx.sd._op("clip_by_value", shifted, clip_value_min=lo,
                             clip_value_max=hi)
        return ctx.sd._op("Cast", clipped, dtype=np.dtype(qdt).name)

    @onnx_rule("DequantizeLinear")
    def _dequantize_linear(ctx, node, inputs, attrs):
        x = inputs[0]
        scale = np.asarray(ctx.const(node["input"][1]))
        ins = node.get("input", [])
        zp = (np.asarray(ctx.const(ins[2]))
              if len(ins) > 2 and ins[2] else np.zeros((), np.int32))
        axis = int(attrs.get("axis", 1))
        if scale.ndim == 1:
            bshape = [1] * len(x.shape)
            bshape[axis] = scale.shape[0]
            scale = scale.reshape(bshape)
            zp = zp.reshape(bshape) if zp.ndim == 1 else zp
        xf = ctx.sd._op("Cast", x, dtype="float32")
        centered = ctx.sd._op("subtract", xf, ctx.sd.constant(
            zp.astype(np.float32)))
        return ctx.sd._op("multiply", centered, ctx.sd.constant(
            scale.astype(np.float32)))

    @onnx_rule("MatMulInteger")
    def _matmul_integer(ctx, node, inputs, attrs):
        a, b = inputs[0], inputs[1]
        ins = node.get("input", [])
        ai = ctx.sd._op("Cast", a, dtype="int32")
        bi = ctx.sd._op("Cast", b, dtype="int32")
        if len(ins) > 2 and ins[2]:
            ai = ctx.sd._op("subtract", ai, ctx.sd._op(
                "Cast", ctx.vars[ins[2]], dtype="int32"))
        if len(ins) > 3 and ins[3]:
            bi = ctx.sd._op("subtract", bi, ctx.sd._op(
                "Cast", ctx.vars[ins[3]], dtype="int32"))
        return ctx.sd._op("matmul", ai, bi)

    @onnx_rule("ConvInteger")
    def _conv_integer(ctx, node, inputs, attrs):
        ins = node.get("input", [])
        x_zp = (ctx.vars[ins[2]] if len(ins) > 2 and ins[2]
                else ctx.sd.constant(np.zeros((), np.int32)))
        w_zp = (ctx.vars[ins[3]] if len(ins) > 3 and ins[3]
                else ctx.sd.constant(np.zeros((), np.int32)))
        k = attrs.get("kernel_shape", [1, 1])
        return ctx.sd._op(
            "conv_integer", inputs[0], inputs[1], x_zp, w_zp,
            strides=tuple(attrs.get("strides", [1] * len(k))),
            padding=_pads(attrs, len(k)),
            dilations=tuple(attrs.get("dilations", [1] * len(k))))

    @onnx_rule("GridSample")
    def _grid_sample(ctx, node, inputs, attrs):
        return ctx.sd._op(
            "grid_sample", inputs[0], inputs[1],
            mode={"linear": "bilinear"}.get(attrs.get("mode", "bilinear"),
                                            attrs.get("mode", "bilinear")),
            padding_mode=attrs.get("padding_mode", "zeros"),
            align_corners=bool(attrs.get("align_corners", 0)))

    @onnx_rule("MaxUnpool")
    def _max_unpool(ctx, node, inputs, attrs):
        x, indices = inputs[0], inputs[1]
        ins = node.get("input", [])
        if len(ins) > 2 and ins[2]:
            out_shape = [int(v) for v in ctx.const(ins[2])]
        else:
            k = attrs["kernel_shape"]
            st = attrs.get("strides", [1] * len(k))   # ONNX default: 1s
            pads = attrs.get("pads", [0] * (2 * len(k)))
            n, c, ph, pw = x.shape
            # spec: out = (in - 1)*stride + kernel - pad_begin - pad_end
            out_shape = [int(n), int(c),
                         (int(ph) - 1) * st[0] + k[0] - pads[0]
                         - pads[len(k)],
                         (int(pw) - 1) * st[1] + k[1] - pads[1]
                         - pads[len(k) + 1]]
        spatial = int(np.prod(out_shape[2:]))
        # ONNX MaxPool indices are flat over the WHOLE NCHW tensor;
        # max_unpool wants per-(N,C) spatial offsets — mod folds them
        local = ctx.sd._op("mod", indices, ctx.sd.constant(
            np.asarray(spatial, np.int64)))
        return ctx.sd._op("max_unpool", x, local,
                          output_shape=tuple(out_shape))

    @onnx_rule("Compress")
    def _compress(ctx, node, inputs, attrs):
        cond = np.asarray(ctx.const(node["input"][1])).astype(bool)
        idx = np.nonzero(cond)[0].astype(np.int64)
        axis = attrs.get("axis")
        gather_idx = ctx.sd.constant(idx)
        if axis is None:
            flat = ctx.sd._op("Reshape", inputs[0], shape=(-1,))
            return ctx.sd._op("gather", flat, gather_idx, axis=0)
        return ctx.sd._op("gather", inputs[0], gather_idx,
                          axis=int(axis))

    @onnx_rule("RandomNormal", "RandomNormalLike")
    def _random_normal(ctx, node, inputs, attrs):
        if node["op_type"].endswith("Like"):
            shape = tuple(int(s) for s in inputs[0].shape)
            default_dt = _dt.name_of(inputs[0].dtype)  # spec: the input's
        else:
            shape = tuple(int(s) for s in attrs["shape"])
            default_dt = "float32"
        dt = (op_.onnx_dtype(attrs["dtype"]).name if "dtype" in attrs
              else default_dt)
        seed = attrs.get("seed")
        out = ctx.sd._op("random_normal_gen", shape=shape,
                         mean=float(attrs.get("mean", 0.0)),
                         scale=float(attrs.get("scale", 1.0)),
                         seed=int(seed) if seed is not None else None)
        return ctx.sd._op("Cast", out, dtype=dt)

    @onnx_rule("RandomUniform", "RandomUniformLike")
    def _random_uniform(ctx, node, inputs, attrs):
        if node["op_type"].endswith("Like"):
            shape = tuple(int(s) for s in inputs[0].shape)
            default_dt = _dt.name_of(inputs[0].dtype)
        else:
            shape = tuple(int(s) for s in attrs["shape"])
            default_dt = "float32"
        dt = (op_.onnx_dtype(attrs["dtype"]).name if "dtype" in attrs
              else default_dt)
        seed = attrs.get("seed")
        out = ctx.sd._op("random_uniform_gen", shape=shape,
                         low=float(attrs.get("low", 0.0)),
                         high=float(attrs.get("high", 1.0)),
                         seed=int(seed) if seed is not None else None)
        return ctx.sd._op("Cast", out, dtype=dt)

    @onnx_rule("If")
    def _if(ctx, node, inputs, attrs):
        then_g, else_g = attrs["then_branch"], attrs["else_branch"]
        if then_g is None or else_g is None:
            raise ONNXImportError("If: missing branch subgraph")
        caps = _subgraph_captures(then_g, ctx)
        for nm in _subgraph_captures(else_g, ctx):
            if nm not in caps:
                caps.append(nm)
        operands = [ctx.vars[nm] for nm in caps]
        return ctx.sd.if_cond(inputs[0],
                              _subgraph_body(ctx, then_g, caps),
                              _subgraph_body(ctx, else_g, caps),
                              *operands)

    def _pretrace_outputs(ctx, graph, seed_names, arg_templates):
        """Trace a subgraph against placeholder templates to learn its
        output shapes/dtypes without touching the real graph."""
        tmp = SameDiff.create(ctx.sd.device)
        args = [tmp.placeholder(f"__t{i}", v.shape, v.dtype)
                for i, v in enumerate(arg_templates)]
        outs = _subgraph_body(ctx, graph, seed_names)(tmp, *args)
        return list(outs) if isinstance(outs, (list, tuple)) else [outs]

    def _loop_cond_statically_true(ctx, body_g, cond_name):
        """True when the Loop can provably never exit early: the initial
        cond is a constant True AND the body's cond_out is the cond input
        (or a constant True) threaded through Identity nodes — the pattern
        for-loop exporters emit."""
        init = ctx.consts.get(cond_name)
        if init is None or not bool(np.asarray(init).reshape(())):
            return False
        b_inputs = [vi["name"] for vi in body_g.get("input", [])]
        cond_in = b_inputs[1] if len(b_inputs) > 1 else None
        outs = body_g.get("output", [])
        if not outs:
            return False
        src = outs[0]["name"]
        producers = {o: n for n in body_g.get("node", [])
                     for o in n.get("output", [])}
        for _ in range(64):                # follow the Identity chain
            if src == cond_in:
                return True
            for init_t in body_g.get("initializer", []):
                if init_t["name"] == src:
                    return bool(np.asarray(
                        op_.tensor_to_np(init_t)).reshape(()))
            n = producers.get(src)
            if n is None or n.get("op_type") not in ("Identity", "Cast"):
                return False
            src = n["input"][0]
        return False

    @onnx_rule("Loop")
    def _loop(ctx, node, inputs, attrs):
        body_g = attrs["body"]
        ins = node.get("input", [])
        b_inputs = [vi["name"] for vi in body_g.get("input", [])]
        n_carried = len(b_inputs) - 2
        n_body_out = len(body_g.get("output", []))
        n_scan = n_body_out - 1 - n_carried
        m_name = ins[0] if len(ins) > 0 else ""
        cond_name = ins[1] if len(ins) > 1 else ""
        trip_max = (int(np.asarray(ctx.const(m_name)).reshape(()))
                    if m_name else None)
        if n_scan > 0 and trip_max is None:
            raise ONNXImportError(
                "Loop scan outputs need a static trip count (constant M "
                "input): the whole-graph-jit executor preallocates the "
                "stacked output, so its length must be known at trace time")
        carried = [ctx.vars[r] for r in ins[2:]]
        caps = _subgraph_captures(body_g, ctx)
        cap_vars = [ctx.vars[nm] for nm in caps]
        i0 = ctx.sd.constant(np.asarray(0, np.int64))
        c0 = (ctx.vars[cond_name] if cond_name
              else ctx.sd.constant(np.asarray(True)))
        n_car = len(carried)
        seeds = ([b_inputs[0], b_inputs[1]] + list(b_inputs[2:])
                 + list(caps))

        accs = []
        if n_scan > 0:
            # scan accumulators: (M, *elem) zeros, rows written at index i.
            # If the body's cond_out goes false before M trips (dynamic
            # early exit), the remaining rows stay zero — a documented
            # divergence from ONNX's true-length scan output, which cannot
            # exist under static shapes. Surfaced at import time (not just
            # here): consumers that rely on the true-length semantics must
            # mask the tail rows themselves. NOT warned for the ubiquitous
            # for-loop export pattern (constant-true cond threaded through
            # unchanged) where early exit is statically impossible.
            if cond_name and not _loop_cond_statically_true(
                    ctx, body_g, cond_name):
                import warnings

                warnings.warn(
                    f"ONNX Loop {node.get('name') or ''!r}: scan outputs "
                    f"are padded to the static trip count M={trip_max}; on "
                    f"dynamic early exit the tail rows are ZEROS, not "
                    f"truncated as ONNX specifies. Mask them using the "
                    f"final iteration count if your consumer depends on "
                    f"true-length scan outputs.", stacklevel=2)
            tmpl = _pretrace_outputs(ctx, body_g, seeds,
                                     [i0, c0, *carried, *cap_vars])
            for t in tmpl[1 + n_car:]:
                accs.append(ctx.sd.constant(np.zeros(
                    (trip_max,) + tuple(int(d) for d in (t.shape or ())),
                    _dt.to_numpy_dtype(t.dtype))))

        def cond_body(sub_sd, i, c, *rest):
            out = c
            if trip_max is not None:
                lim = sub_sd.constant(np.asarray(trip_max, np.int64))
                out = sub_sd._op("boolean_and",
                                 sub_sd._op("Cast", c, dtype="bool"),
                                 sub_sd._op("less", i, lim))
            return sub_sd._op("Cast", out, dtype="bool")

        def loop_body(sub_sd, i, c, *rest):
            vs = rest[:n_car]
            acc_vs = rest[n_car:n_car + n_scan]
            cvs = rest[n_car + n_scan:]
            body = _subgraph_body(ctx, body_g, seeds)
            outs = body(sub_sd, i, c, *vs, *cvs)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            new_accs = []
            row = sub_sd._op("Reshape", i, shape=(1,))
            for acc, step in zip(acc_vs, outs[1 + n_car:]):
                new_accs.append(sub_sd._op(
                    "scatter_update", acc, row,
                    sub_sd._op("expand_dims", step, axis=0)))
            one = sub_sd.constant(np.asarray(1, np.int64))
            return [sub_sd._op("add", i, one), outs[0],
                    *outs[1:1 + n_car], *new_accs, *cvs]

        final = ctx.sd.while_loop(cond_body, loop_body,
                                  i0, c0, *carried, *accs, *cap_vars)
        final = list(final) if isinstance(final, (list, tuple)) else [final]
        return final[2:2 + n_car + n_scan]

    @onnx_rule("Scan")
    def _scan(ctx, node, inputs, attrs):
        body_g = attrs["body"]
        m = int(attrs["num_scan_inputs"])
        if attrs.get("scan_input_axes") or attrs.get("scan_input_directions") \
                or attrs.get("scan_output_axes") \
                or attrs.get("scan_output_directions"):
            raise ONNXImportError(
                "Scan with non-default axes/directions unsupported "
                "(transpose/reverse the scan tensors around the node)")
        ins = node.get("input", [])
        b_inputs = [vi["name"] for vi in body_g.get("input", [])]
        n_state = len(b_inputs) - m
        states = [ctx.vars[r] for r in ins[:n_state]]
        scans = [ctx.vars[r] for r in ins[n_state:]]
        trips = {int(v.shape[0]) for v in scans if v.shape}
        if len(trips) != 1:
            raise ONNXImportError(
                f"Scan inputs must share one static leading length, "
                f"got {sorted(trips)}")
        trip = trips.pop()
        n_body_out = len(body_g.get("output", []))
        n_scan_out = n_body_out - n_state
        caps = _subgraph_captures(body_g, ctx)
        cap_vars = [ctx.vars[nm] for nm in caps]
        seeds = list(b_inputs) + list(caps)
        elem_tmpl = [_FakeVar(tuple((v.shape or ())[1:]), v.dtype)
                     for v in scans]
        tmpl = _pretrace_outputs(ctx, body_g, seeds,
                                 [*states, *elem_tmpl, *cap_vars])
        accs = [ctx.sd.constant(np.zeros(
                    (trip,) + tuple(int(d) for d in (t.shape or ())),
                    _dt.to_numpy_dtype(t.dtype)))
                for t in tmpl[n_state:]]
        i0 = ctx.sd.constant(np.asarray(0, np.int64))
        n_st, n_sc = len(states), len(scans)

        def cond_body(sub_sd, i, *rest):
            lim = sub_sd.constant(np.asarray(trip, np.int64))
            return sub_sd._op("less", i, lim)

        def loop_body(sub_sd, i, *rest):
            sts = rest[:n_st]
            acc_vs = rest[n_st:n_st + n_scan_out]
            sc_ins = rest[n_st + n_scan_out:n_st + n_scan_out + n_sc]
            cvs = rest[n_st + n_scan_out + n_sc:]
            elems = [sub_sd._op("gather", sv, i, axis=0) for sv in sc_ins]
            body = _subgraph_body(ctx, body_g, seeds)
            outs = body(sub_sd, *sts, *elems, *cvs)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            row = sub_sd._op("Reshape", i, shape=(1,))
            new_accs = [sub_sd._op("scatter_update", acc, row,
                                   sub_sd._op("expand_dims", step, axis=0))
                        for acc, step in zip(acc_vs, outs[n_st:])]
            one = sub_sd.constant(np.asarray(1, np.int64))
            return [sub_sd._op("add", i, one), *outs[:n_st], *new_accs,
                    *sc_ins, *cvs]

        final = ctx.sd.while_loop(cond_body, loop_body,
                                  i0, *states, *accs, *scans, *cap_vars)
        final = list(final) if isinstance(final, (list, tuple)) else [final]
        return final[1:1 + n_st + n_scan_out]

    for seq_op in ("RoiAlign", "MaxRoiPool"):
        @onnx_rule(seq_op)
        def _heavy_unsupported(ctx, node, inputs, attrs,
                               _op_name=seq_op):
            raise ONNXImportError(
                f"{_op_name} unsupported in this build — "
                f"use crop_and_resize + pooling (ops registry) host-side")

    @onnx_rule("Unique")
    def _unique(ctx, node, inputs, attrs):
        raise ONNXImportError(
            "Unique has a data-dependent output shape, which the "
            "whole-graph-jit executor cannot represent; the eager registry "
            "op 'unique' covers host-side use")

    for seq_op in ("SequenceAt", "SequenceConstruct", "SequenceEmpty",
                   "SequenceErase", "SequenceInsert", "SequenceLength",
                   "SplitToSequence", "ConcatFromSequence",
                   "StringNormalizer", "TfIdfVectorizer"):
        @onnx_rule(seq_op)
        def _seq_unsupported(ctx, node, inputs, attrs, _op_name=seq_op):
            raise ONNXImportError(
                f"{_op_name}: sequence/string-typed ONNX values are outside "
                f"the dense-tensor model (the reference importer shares "
                f"this gap); restructure with dense tensors")


_register_onnx_rules_t3()
