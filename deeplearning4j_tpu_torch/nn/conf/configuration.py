"""Network configuration DSL: a copy of
``deeplearning4j_tpu/nn/conf/configuration.py``, analog of
``org.deeplearning4j.nn.conf.NeuralNetConfiguration`` (builder) →
``MultiLayerConfiguration`` (JSON round-trippable model architecture format,
SURVEY D1/§5.6).

Usage (mirrors the reference's fluent builder):

    conf = (NeuralNetConfiguration.builder()
            .seed(123)
            .updater(Adam(1e-3))
            .weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=128, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss_function="negativeloglikelihood"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())
    net = MultiLayerNetwork(conf); net.init()
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_dict
from deeplearning4j_tpu_torch.optim import updaters as _upd
from deeplearning4j_tpu_torch.nn.conf import preprocessors as _preproc


@dataclasses.dataclass
class BackpropType:
    Standard = "standard"
    TruncatedBPTT = "tbptt"


class NeuralNetConfiguration:
    """Global-hyperparameter builder (ref: NeuralNetConfiguration.Builder)."""

    def __init__(self):
        self._seed = 12345
        self._updater = _upd.Sgd(0.1)
        self._weight_init = "xavier"
        self._activation = None
        self._l1 = None
        self._l2 = None
        self._dropout = None
        self._dtype = "float32"
        self._grad_normalization = None      # ref: GradientNormalization enum
        self._grad_norm_threshold = 1.0
        self._mini_batch = True

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def seed(self, s: int):
        self._seed = int(s)
        return self

    def updater(self, u):
        self._updater = u
        return self

    def weight_init(self, w: str):
        self._weight_init = w
        return self

    # camelCase aliases for reference parity
    weightInit = weight_init

    def activation(self, a: str):
        self._activation = a
        return self

    def l1(self, v: float):
        self._l1 = v
        return self

    def l2(self, v: float):
        self._l2 = v
        return self

    def dropout(self, retain_prob: float):
        self._dropout = retain_prob
        return self

    def data_type(self, dt: str):
        """ref: Builder#dataType(DataType). Normalized lowercase; unknown
        values raise rather than silently training in f32."""
        dt = str(dt).lower()
        allowed = {"float32", "float", "single",          # f32 (default)
                   "float64", "double",                   # accepted, runs f32
                   "bfloat16", "bf16", "float16", "half"}  # bf16 compute
        if dt not in allowed:
            raise ValueError(f"data_type {dt!r} not supported; use one of "
                             f"{sorted(allowed)}")
        self._dtype = {"float": "float32", "single": "float32",
                       "double": "float64"}.get(dt, dt)
        return self

    def gradient_normalization(self, kind: str, threshold: float = 1.0):
        """ref: GradientNormalization.{ClipL2PerLayer,ClipElementWiseAbsoluteValue,
        ClipL2PerParamType,RenormalizeL2PerLayer} — applied globally here."""
        self._grad_normalization = kind
        self._grad_norm_threshold = threshold
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self)

    def graph_builder(self):
        from deeplearning4j_tpu_torch.nn.graph_conf import GraphBuilder
        return GraphBuilder(self)

    def global_defaults(self) -> dict:
        return {
            "activation": self._activation,
            "weight_init": self._weight_init,
            "l1": self._l1,
            "l2": self._l2,
            "dropout": self._dropout,
        }


class ListBuilder:
    """Sequential-net builder (ref: NeuralNetConfiguration.ListBuilder)."""

    def __init__(self, nn_conf: NeuralNetConfiguration):
        self._conf = nn_conf
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._backprop_type = BackpropType.Standard
        self._tbptt_fwd = 20
        self._tbptt_bwd = 20
        self._preprocessors = {}

    def layer(self, *args) -> "ListBuilder":
        """layer(conf) or layer(index, conf)."""
        conf = args[-1]
        self._layers.append(conf)
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        self._input_type = t
        return self

    def input_pre_processor(self, idx: int, proc) -> "ListBuilder":
        """Attach an explicit InputPreProcessor before layer ``idx`` (ref:
        ListBuilder#inputPreProcessor)."""
        self._preprocessors[int(idx)] = proc
        return self

    inputPreProcessor = input_pre_processor

    setInputType = set_input_type

    def backprop_type(self, t: str) -> "ListBuilder":
        self._backprop_type = t
        return self

    def gradient_checkpointing(self, enabled: bool = True,
                               policy: Optional[str] = None) -> "ListBuilder":
        """Rematerialise every hidden layer during training: backward
        recomputes activations instead of saving them (memory for FLOPs).

        ``policy`` names a save policy (see nn/_remat.py: ``"dots"`` keeps
        matrix products' outputs so backward replays only the cheap ops);
        None = full recompute."""
        self._remat = bool(enabled)
        self._remat_policy = policy
        return self

    gradientCheckpointing = gradient_checkpointing

    def t_bptt_length(self, fwd: int, bwd: Optional[int] = None) -> "ListBuilder":
        self._tbptt_fwd = fwd
        self._tbptt_bwd = bwd if bwd is not None else fwd
        return self

    tBPTTLength = t_bptt_length

    def build(self) -> "MultiLayerConfiguration":
        c = self._conf
        defaults = c.global_defaults()
        input_type = self._input_type
        for layer in self._layers:
            layer.apply_global_defaults(defaults)
            if input_type is not None:
                layer.set_n_in(input_type)
                input_type = layer.output_type(input_type)
        return MultiLayerConfiguration(
            layers=self._layers,
            seed=c._seed,
            updater=c._updater,
            dtype=c._dtype,
            input_type=self._input_type,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            grad_normalization=c._grad_normalization,
            grad_norm_threshold=c._grad_norm_threshold,
            input_pre_processors=self._preprocessors,
            remat=getattr(self, "_remat", False),
            remat_policy=getattr(self, "_remat_policy", None),
        )


@dataclasses.dataclass
class MultiLayerConfiguration:
    """Built sequential config (ref: MultiLayerConfiguration; JSON-parity via
    to_json/from_json — the JSON is this framework's own schema, not the
    reference's Jackson layout)."""
    layers: List[Layer]
    seed: int = 12345
    updater: Any = None
    dtype: str = "float32"
    input_type: Optional[InputType] = None
    backprop_type: str = BackpropType.Standard
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    grad_normalization: Optional[str] = None
    grad_norm_threshold: float = 1.0
    input_pre_processors: dict = dataclasses.field(default_factory=dict)
    remat: bool = False
    remat_policy: Optional[str] = None

    def recompute_shapes(self):
        """Re-run config-time shape inference after layer edits
        (used by transfer learning's graph surgery)."""
        input_type = self.input_type
        for layer in self.layers:
            layer.apply_global_defaults({})
            if input_type is not None:
                layer.set_n_in(input_type)
                input_type = layer.output_type(input_type)

    def to_json(self) -> str:
        return json.dumps({
            "layers": [l.to_dict() for l in self.layers],
            "seed": self.seed,
            "updater": self.updater.to_dict() if self.updater is not None else None,
            "dtype": self.dtype,
            "input_type": self.input_type.to_dict() if self.input_type else None,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_bwd_length": self.tbptt_bwd_length,
            "grad_normalization": self.grad_normalization,
            "grad_norm_threshold": self.grad_norm_threshold,
            "input_pre_processors": {str(k): v.to_dict() for k, v in
                                     self.input_pre_processors.items()},
            "remat": self.remat,
            "remat_policy": self.remat_policy,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        return MultiLayerConfiguration(
            layers=[layer_from_dict(ld) for ld in d["layers"]],
            seed=d.get("seed", 12345),
            updater=_upd.Updater.from_dict(d["updater"]) if d.get("updater") else None,
            dtype=d.get("dtype", "float32"),
            input_type=InputType.from_dict(d["input_type"]) if d.get("input_type") else None,
            backprop_type=d.get("backprop_type", BackpropType.Standard),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_bwd_length=d.get("tbptt_bwd_length", 20),
            grad_normalization=d.get("grad_normalization"),
            grad_norm_threshold=d.get("grad_norm_threshold", 1.0),
            input_pre_processors={
                int(k): _preproc.preprocessor_from_dict(v)
                for k, v in (d.get("input_pre_processors") or {}).items()},
            remat=d.get("remat", False),
            remat_policy=d.get("remat_policy"),
        )
