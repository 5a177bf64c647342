"""ComputationGraph configuration: a DAG of layers and graph vertices.

Counterpart of ``deeplearning4j_tpu/nn/graph_conf.py`` (the reference's
``ComputationGraphConfiguration``, its ``GraphBuilder`` and the vertices of
``org.deeplearning4j.nn.graph.vertex.impl``). A vertex is a function over
its input activations; autograd differentiates the whole DAG. Ported
vertices: ``MergeVertex``, ``ElementWiseVertex``, ``SubsetVertex``,
``L2NormalizeVertex``, ``ScaleVertex``, ``ShiftVertex``, ``StackVertex``,
``UnstackVertex``, ``ReshapeVertex``, ``PoolHelperVertex``, ``L2Vertex``,
``PreprocessorVertex``, ``LambdaVertex``, the time-series vertices
(``LastTimeStepVertex``, ``DuplicateToTimeSeriesVertex``,
``ReverseTimeSeriesVertex``) and the Keras-import vertices ``DotVertex``,
``DotProductAttentionVertex`` and ``AdditiveAttentionVertex`` (no DL4J
analog; plain torch, as the reference leaves them to XLA).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_dict
from deeplearning4j_tpu_torch.optim import updaters as _upd

_VERTEX_TYPES: Dict[str, type] = {}


def register_vertex(cls):
    _VERTEX_TYPES[cls.__name__] = cls
    return cls


def vertex_from_dict(d: dict) -> "GraphVertex":
    d = dict(d)
    cls = _VERTEX_TYPES[d.pop("@vertex")]
    field_names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in d.items() if k in field_names})


@dataclasses.dataclass
class GraphVertex:
    """Parameterless DAG node combining/transforming activations
    (ref: org.deeplearning4j.nn.conf.graph.GraphVertex). A class that sets
    ``takes_mask`` gets the network's first feature mask as ``apply``'s
    ``mask``."""

    takes_mask = False

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@vertex"] = type(self).__name__
        return d

    def apply(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def output_type(self, input_types: Sequence[InputType]) -> InputType:
        return input_types[0]


@register_vertex
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the channel (last) axis (ref: vertex.impl.MergeVertex;
    reference concatenates dim 1 in NCHW == last axis in our NHWC layout)."""

    def apply(self, inputs):
        return torch.cat(list(inputs), dim=-1)

    def output_type(self, input_types):
        t0 = input_types[0]
        if t0.kind == "cnn":
            return InputType.convolutional(t0.height, t0.width,
                                           sum(t.channels for t in input_types))
        if t0.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in input_types),
                                       t0.timeseries_length)
        return InputType.feed_forward(sum(t.size for t in input_types))


@register_vertex
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise combine (ref: vertex.impl.ElementWiseVertex, ops
    Add/Subtract/Product/Average/Max)."""
    op: str = "add"

    def apply(self, inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op in ("sub", "subtract"):
            return inputs[0] - inputs[1]
        if op in ("prod", "product", "mul"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op in ("avg", "average"):
            return sum(inputs) / len(inputs)
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        if op == "min":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.minimum(out, x)
            return out
        raise ValueError(f"Unknown ElementWiseVertex op {self.op!r}")


@register_vertex
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Channel-range subset [from, to] inclusive (ref: vertex.impl.SubsetVertex)."""
    from_idx: int = 0
    to_idx: int = 0

    def apply(self, inputs):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def output_type(self, input_types):
        n = self.to_idx - self.from_idx + 1
        t = input_types[0]
        if t.kind == "cnn":
            return InputType.convolutional(t.height, t.width, n)
        if t.kind == "rnn":
            return InputType.recurrent(n, t.timeseries_length)
        return InputType.feed_forward(n)


@register_vertex
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """L2-normalize over all non-batch axes (ref: vertex.impl.L2NormalizeVertex)."""
    eps: float = 1e-8

    def apply(self, inputs):
        x = inputs[0]
        dims = tuple(range(1, x.dim()))
        norm = torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=True)
                          + self.eps)
        return x / norm


@register_vertex
@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    """Multiply by a fixed scalar (ref: vertex.impl.ScaleVertex)."""
    scale: float = 1.0

    def apply(self, inputs):
        return inputs[0] * self.scale


@register_vertex
@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    """Add a fixed scalar (ref: vertex.impl.ShiftVertex)."""
    shift: float = 0.0

    def apply(self, inputs):
        return inputs[0] + self.shift


@register_vertex
@dataclasses.dataclass
class StackVertex(GraphVertex):
    """Stack minibatches along batch axis (ref: vertex.impl.StackVertex)."""

    def apply(self, inputs):
        return torch.cat(list(inputs), dim=0)


@register_vertex
@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Take the i-th of n equal batch slices (ref: vertex.impl.UnstackVertex)."""
    from_idx: int = 0
    stack_size: int = 1

    def apply(self, inputs):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_idx * n:(self.from_idx + 1) * n]


@register_vertex
@dataclasses.dataclass
class ReshapeVertex(GraphVertex):
    """Reshape non-batch dims (ref: vertex.impl.ReshapeVertex)."""
    shape: Tuple[int, ...] = ()

    def apply(self, inputs):
        x = inputs[0]
        return torch.reshape(x, (x.shape[0],) + tuple(self.shape))


@register_vertex
@dataclasses.dataclass
class PoolHelperVertex(GraphVertex):
    """Crop first row/col (GoogLeNet import compat; ref: vertex.impl.PoolHelperVertex)."""

    def apply(self, inputs):
        return inputs[0][:, 1:, 1:, :]


@register_vertex
@dataclasses.dataclass
class L2Vertex(GraphVertex):
    """Pairwise L2 distance between two inputs, per example
    (ref: vertex.impl.L2Vertex — used by siamese/triplet setups)."""
    eps: float = 1e-8

    def apply(self, inputs):
        a, b = inputs[0], inputs[1]
        diff = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(diff * diff, dim=1, keepdim=True)
                          + self.eps)

    def output_type(self, input_types):
        return InputType.feed_forward(1)


@register_vertex
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertex):
    """(N, T, C) → (N, C) at the last step whose mask is set (not
    sum(mask) − 1: a mask with an interior gap, [1, 0, 1, 0], picks index
    2), index 0 for a row whose mask is all zero; the last step without a
    mask."""

    takes_mask = True

    def apply(self, inputs, mask=None):
        x = inputs[0]
        if mask is None:
            return x[:, -1]
        t_len = x.shape[1]
        set_ = torch.flip(mask, dims=(1,)) > 0
        last = t_len - 1 - torch.argmax(set_.int(), dim=1)
        last = torch.where(torch.sum(mask, dim=1) > 0, last,
                           torch.zeros_like(last))
        return x[torch.arange(x.shape[0], device=x.device), last]

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)


@register_vertex
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """(N, C) → (N, T, C), T taken from a time series: inputs [vector,
    series] (a seq2seq decoder broadcasting an encoder's summary)."""

    def apply(self, inputs):
        vec, series = inputs[0], inputs[1]
        return vec[:, None, :].expand(vec.shape[0], series.shape[1],
                                      vec.shape[-1])

    def output_type(self, input_types):
        return InputType.recurrent(input_types[0].size,
                                   input_types[1].timeseries_length)


@register_vertex
@dataclasses.dataclass
class ReverseTimeSeriesVertex(GraphVertex):
    """The time axis of (N, T, C) reversed."""

    def apply(self, inputs):
        return torch.flip(inputs[0], dims=(1,))


@register_vertex
@dataclasses.dataclass
class DotVertex(GraphVertex):
    """Keras ``Dot`` merge: the batched dot of two inputs over ``axes``
    (one axis for both, or a pair), output (N, *rest_a, *rest_b): two (N,
    T, D) inputs over axis 2 give the (N, T, T') similarities, rank-2
    inputs (N, 1) as Keras. ``normalize`` L2-normalizes along the dot axes
    first (cosine proximity). A Keras-import helper with no DL4J analog:
    plain torch (one batched matmul)."""
    axes: int = -1
    normalize: bool = False

    def _axes(self, ndim_a, ndim_b):
        if isinstance(self.axes, (tuple, list)):
            ax_a, ax_b = self.axes
        else:
            ax_a = ax_b = self.axes
        return ax_a % ndim_a, ax_b % ndim_b

    def apply(self, inputs):
        a, b = _promoted(inputs[0], inputs[1])
        ax_a, ax_b = self._axes(a.dim(), b.dim())
        if self.normalize:
            a = a / torch.clamp_min(torch.linalg.vector_norm(
                a, dim=ax_a, keepdim=True), 1e-12)
            b = b / torch.clamp_min(torch.linalg.vector_norm(
                b, dim=ax_b, keepdim=True), 1e-12)
        a = torch.movedim(a, ax_a, -1)
        b = torch.movedim(b, ax_b, 1)
        rest_a, rest_b = a.shape[1:-1], b.shape[2:]
        out = torch.bmm(a.reshape(a.shape[0], -1, a.shape[-1]),
                        b.reshape(b.shape[0], b.shape[1], -1))
        out = out.reshape((a.shape[0],) + tuple(rest_a) + tuple(rest_b))
        if out.dim() == 1:                      # rank-2 inputs: Keras (N, 1)
            out = out[:, None]
        return out

    def output_type(self, input_types):
        ta, tb = input_types[0], input_types[1]
        if ta.kind == "ff" and tb.kind == "ff":
            return InputType.feed_forward(1)
        if ta.kind == "rnn" and tb.kind == "rnn":
            # (N, T, D)·(N, T', D) over the feature axis → (N, T, T')
            ax_a, ax_b = self._axes(3, 3)
            if ax_a == 2 and ax_b == 2:
                return InputType.recurrent(tb.timeseries_length,
                                           ta.timeseries_length)
            # contracting time: (N, D, D')
            return InputType.recurrent(tb.size, ta.size)
        raise ValueError(
            f"DotVertex: unsupported input kinds ({ta.kind}, {tb.kind})")


def _promoted(*xs):
    """The inputs in their promoted dtype, as jnp's products take mixed
    types."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def _attend(scores, v, causal: bool):
    """The attention vertices' shared tail: a causal mask by the sentinel
    -1e9 (not the layers' -1e30), the softmax over keys in the scores'
    own dtype (bf16 stays bf16), then the product with v."""
    if causal:
        tq, tk = scores.shape[1], scores.shape[2]
        keep = (torch.arange(tq, device=scores.device)[:, None]
                >= torch.arange(tk, device=scores.device)[None, :])
        scores = torch.where(keep[None], scores,
                             torch.tensor(-1e9, dtype=scores.dtype))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.bmm(*_promoted(p, v))


@register_vertex
@dataclasses.dataclass
class DotProductAttentionVertex(GraphVertex):
    """Dot-product attention over [query, value] or [query, value, key]
    (Keras ``Attention`` with use_scale=False: unscaled): q (N, Tq, d), v
    (N, Tv, dv), k (N, Tv, d); out = softmax(q·kᵀ)·v. A Keras-import
    helper with no DL4J analog: plain torch, not the flash kernels (no
    scale, the -1e9 sentinel and a softmax in the input dtype)."""
    causal: bool = False

    def apply(self, inputs):
        q, v = inputs[0], inputs[1]
        k = inputs[2] if len(inputs) > 2 else v
        q, k = _promoted(q, k)
        return _attend(torch.bmm(q, k.transpose(1, 2)), v, self.causal)

    def output_type(self, input_types):
        return InputType.recurrent(input_types[1].size,
                                   input_types[0].timeseries_length)


@register_vertex
@dataclasses.dataclass
class AdditiveAttentionVertex(GraphVertex):
    """Bahdanau-style additive attention over [query, value] (Keras
    ``AdditiveAttention`` with use_scale=False): scores sum(tanh(q + k))
    over features. A Keras-import helper with no DL4J analog: plain
    torch."""
    causal: bool = False

    def apply(self, inputs):
        q, v = inputs[0], inputs[1]
        k = inputs[2] if len(inputs) > 2 else v
        s = torch.sum(torch.tanh(q[:, :, None, :] + k[:, None, :, :]),
                      dim=-1)
        return _attend(s, v, self.causal)

    def output_type(self, input_types):
        return InputType.recurrent(input_types[1].size,
                                   input_types[0].timeseries_length)


@register_vertex
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """Wrap an InputPreProcessor as a standalone vertex
    (ref: vertex.impl.PreprocessorVertex)."""
    preprocessor: Optional[dict] = None
    _pp: "object" = dataclasses.field(default=None, repr=False,
                                      compare=False)

    @staticmethod
    def wrap(pp) -> "PreprocessorVertex":
        v = PreprocessorVertex(preprocessor=pp.to_dict())
        v._materialize()
        return v

    def _materialize(self):
        if self._pp is None and self.preprocessor is not None:
            from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
                preprocessor_from_dict)
            self._pp = preprocessor_from_dict(self.preprocessor)

    def to_dict(self) -> dict:
        # the materialized _pp object must never leak into JSON
        return {"@vertex": type(self).__name__,
                "preprocessor": self.preprocessor}

    def apply(self, inputs):
        self._materialize()
        return self._pp.pre_process(inputs[0])

    def output_type(self, input_types):
        self._materialize()
        if hasattr(self._pp, "output_type"):
            return self._pp.output_type(input_types[0])
        return input_types[0]


class LambdaVertex(GraphVertex):
    """User-defined vertex fn (ref: SameDiffLambdaVertex). Not JSON-serializable."""

    def __init__(self, fn, out_type=None):
        self.fn = fn
        self.out_type = out_type

    def to_dict(self):
        raise TypeError("LambdaVertex is not serializable")

    def apply(self, inputs):
        return self.fn(*inputs)

    def output_type(self, input_types):
        return self.out_type or input_types[0]


# ---------------------------------------------------------------------------
# Graph nodes + configuration

@dataclasses.dataclass
class GraphNode:
    name: str
    inputs: List[str]
    layer: Optional[Layer] = None
    vertex: Optional[GraphVertex] = None


class GraphBuilder:
    """ref: ComputationGraphConfiguration.GraphBuilder fluent DSL."""

    def __init__(self, nn_conf):
        self._conf = nn_conf
        self._inputs: List[str] = []
        self._input_types: List[InputType] = []
        self._nodes: Dict[str, GraphNode] = {}
        self._outputs: List[str] = []
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_bwd = 20

    def add_inputs(self, *names) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    addInputs = add_inputs

    def set_input_types(self, *types) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    setInputTypes = set_input_types

    def add_layer(self, name: str, layer: Layer, *inputs) -> "GraphBuilder":
        self._nodes[name] = GraphNode(name, list(inputs), layer=layer)
        return self

    addLayer = add_layer

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs) -> "GraphBuilder":
        self._nodes[name] = GraphNode(name, list(inputs), vertex=vertex)
        return self

    addVertex = add_vertex

    def set_outputs(self, *names) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    setOutputs = set_outputs

    def gradient_checkpointing(self, enabled: bool = True,
                               policy: Optional[str] = None) -> "GraphBuilder":
        """Rematerialise every hidden layer node during training (see
        ListBuilder.gradient_checkpointing; ``policy`` names a save
        policy — nn/_remat.py)."""
        self._remat = bool(enabled)
        self._remat_policy = policy
        return self

    gradientCheckpointing = gradient_checkpointing

    def backprop_type(self, t: str) -> "GraphBuilder":
        self._backprop_type = t
        return self

    def t_bptt_length(self, fwd: int, bwd: Optional[int] = None) -> "GraphBuilder":
        self._tbptt_fwd = fwd
        self._tbptt_bwd = bwd if bwd is not None else fwd
        return self

    def build(self) -> "ComputationGraphConfiguration":
        c = self._conf
        cfg = ComputationGraphConfiguration(
            network_inputs=self._inputs,
            input_types=self._input_types,
            nodes=self._nodes,
            network_outputs=self._outputs,
            seed=c._seed,
            updater=c._updater,
            dtype=c._dtype,
            remat=getattr(self, "_remat", False),
            remat_policy=getattr(self, "_remat_policy", None),
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            grad_normalization=c._grad_normalization,
            grad_norm_threshold=c._grad_norm_threshold,
        )
        cfg._apply_defaults_and_shapes(c.global_defaults())
        return cfg


@dataclasses.dataclass
class ComputationGraphConfiguration:
    """Built DAG config (ref: ComputationGraphConfiguration; topo order is
    computed once at build time — Kahn's algorithm, the analog of
    ComputationGraph#topologicalSortOrder)."""
    network_inputs: List[str]
    input_types: List[InputType]
    nodes: Dict[str, GraphNode]
    network_outputs: List[str]
    seed: int = 12345
    updater: object = None
    dtype: str = "float32"
    remat: bool = False
    remat_policy: Optional[str] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    grad_normalization: Optional[str] = None
    grad_norm_threshold: float = 1.0
    topo_order: List[str] = dataclasses.field(default_factory=list)
    activation_types: Dict[str, InputType] = dataclasses.field(default_factory=dict)

    def _toposort(self) -> List[str]:
        indeg = {n: 0 for n in self.nodes}
        children: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for node in self.nodes.values():
            for src in node.inputs:
                if src in self.nodes:
                    indeg[node.name] += 1
                    children[src].append(node.name)
                elif src not in self.network_inputs:
                    raise ValueError(f"Vertex {node.name!r} input {src!r} unknown")
        # deterministic order: insertion order among ready nodes
        ready = [n for n in self.nodes if indeg[n] == 0]
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for ch in children[n]:
                indeg[ch] -= 1
                if indeg[ch] == 0:
                    ready.append(ch)
        if len(order) != len(self.nodes):
            cyc = [n for n in self.nodes if n not in order]
            raise ValueError(f"Graph has a cycle involving {cyc}")
        return order

    def _apply_defaults_and_shapes(self, defaults: dict):
        self.topo_order = self._toposort()
        types: Dict[str, InputType] = {}
        for name, t in zip(self.network_inputs, self.input_types):
            types[name] = t
        for name in self.topo_order:
            node = self.nodes[name]
            in_types = [types.get(src) for src in node.inputs]
            if node.layer is not None:
                node.layer.apply_global_defaults(defaults)
                if in_types and in_types[0] is not None:
                    if hasattr(node.layer, "set_n_in_multi"):
                        node.layer.set_n_in_multi(in_types)
                    else:
                        node.layer.set_n_in(in_types[0])
                    types[name] = node.layer.output_type(in_types[0])
            else:
                if all(t is not None for t in in_types) and in_types:
                    try:
                        types[name] = node.vertex.output_type(in_types)
                    except Exception:
                        pass
        self.activation_types = types

    # ------------------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps({
            "network_inputs": self.network_inputs,
            "input_types": [t.to_dict() for t in self.input_types],
            "nodes": [{
                "name": n.name, "inputs": n.inputs,
                "layer": n.layer.to_dict() if n.layer is not None else None,
                "vertex": n.vertex.to_dict() if n.vertex is not None else None,
            } for n in (self.nodes[k] for k in self.topo_order)],
            "network_outputs": self.network_outputs,
            "seed": self.seed,
            "updater": self.updater.to_dict() if self.updater is not None else None,
            "dtype": self.dtype,
            "remat": self.remat,
            "remat_policy": self.remat_policy,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_bwd_length": self.tbptt_bwd_length,
            "grad_normalization": self.grad_normalization,
            "grad_norm_threshold": self.grad_norm_threshold,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        nodes = {}
        for nd_ in d["nodes"]:
            nodes[nd_["name"]] = GraphNode(
                nd_["name"], list(nd_["inputs"]),
                layer=layer_from_dict(nd_["layer"]) if nd_.get("layer") else None,
                vertex=vertex_from_dict(nd_["vertex"]) if nd_.get("vertex") else None)
        cfg = ComputationGraphConfiguration(
            network_inputs=d["network_inputs"],
            input_types=[InputType.from_dict(t) for t in d.get("input_types", [])],
            nodes=nodes,
            network_outputs=d["network_outputs"],
            seed=d.get("seed", 12345),
            updater=_upd.Updater.from_dict(d["updater"]) if d.get("updater") else None,
            dtype=d.get("dtype", "float32"),
            remat=d.get("remat", False),
            remat_policy=d.get("remat_policy"),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_bwd_length=d.get("tbptt_bwd_length", 20),
            grad_normalization=d.get("grad_normalization"),
            grad_norm_threshold=d.get("grad_norm_threshold", 1.0),
        )
        cfg._apply_defaults_and_shapes({})
        return cfg
