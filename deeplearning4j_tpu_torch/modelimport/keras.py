"""Keras H5 model import: counterpart of
``deeplearning4j_tpu/modelimport/keras.py``.

Reference: ``org.deeplearning4j.nn.modelimport.keras.KerasModelImport`` +
``KerasModel/KerasSequentialModel/KerasLayer`` and the per-layer mapping
classes under ``...modelimport.keras.layers.**`` (SURVEY D12). The reference
reads H5 through JavaCPP's HDF5 (``Hdf5Archive``); the port through its
own reader, ``modelimport/hdf5.py``, which gives ``_H5Weights`` the tree
an h5py file gives. Weights land in torch tensors on the network's device
(``device``: None is the card; ``"cpu"`` asks for the CPU).

The mapping is the JAX package's, its behaviours included: ``LSTM``,
``GRU`` and ``SimpleRNN`` read ``activation`` but not
``recurrent_activation`` (only ``ConvLSTM2D`` reads it), so an LSTM saved
with ``hard_sigmoid`` gates imports with sigmoid gates.

Layout notes (why no weight transposition is needed anywhere): Keras and
this framework agree on Dense (in,out), Conv2D HWIO kernels, NHWC
activations, and LSTM gate order (i,f,c/g,o) — the reference needs NCHW and
gate reordering; we do not. BatchNorm moving statistics land in layer
*state*, not params.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport import hdf5
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph_conf import (ElementWiseVertex,
                                                    MergeVertex)
from deeplearning4j_tpu_torch.optim.updaters import Adam


class InvalidKerasConfigurationException(ValueError):
    """ref: exceptions.InvalidKerasConfigurationException."""


class UnsupportedKerasConfigurationException(ValueError):
    """ref: exceptions.UnsupportedKerasConfigurationException."""


_ACTIVATION_MAP = {
    "linear": "identity", "relu": "relu", "relu6": "relu6",
    "sigmoid": "sigmoid", "tanh": "tanh", "softmax": "softmax",
    "elu": "elu", "selu": "selu", "gelu": "gelu", "softplus": "softplus",
    "softsign": "softsign", "swish": "swish", "silu": "swish",
    "hard_sigmoid": "hardsigmoid", "leaky_relu": "leakyrelu",
    "exponential": None, "mish": "mish",
}


def _map_activation(name: Optional[str]) -> str:
    if name is None:
        return "identity"
    if isinstance(name, dict):   # serialized Activation object
        name = name.get("config", {}).get("activation", "linear")
    mapped = _ACTIVATION_MAP.get(str(name))
    if mapped is None and str(name) not in _ACTIVATION_MAP:
        raise UnsupportedKerasConfigurationException(
            f"Unsupported Keras activation {name!r}")
    return mapped or "identity"


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _padding(cfg) -> object:
    return "same" if cfg.get("padding", "valid") == "same" else 0


def _as_seq(v):
    return v if isinstance(v, (list, tuple)) else (v,)


class _H5Weights:
    """Per-layer weight lookup that tolerates the nested group layouts of
    Keras 2 (`layer/layer/kernel:0`) and Keras 3 (`layer/model/layer/kernel`)."""

    def __init__(self, h5file):
        # full group path (relative to the top-level layer) → array, so
        # nested submodels with several sub-layers can never collide
        self.by_layer: Dict[str, Dict[str, np.ndarray]] = {}
        root = h5file["model_weights"] if "model_weights" in h5file else h5file

        def walk(group, top, prefix=""):
            for k in group:
                item = group[k]
                name = k.split(":")[0]
                if hasattr(item, "shape"):
                    self.by_layer.setdefault(top, {})[prefix + name] = \
                        np.asarray(item)
                else:
                    walk(item, top, prefix=prefix + name + "/")

        for top in root:
            if hasattr(root[top], "keys"):
                walk(root[top], top)

    def get(self, layer_name: str,
            allow_ambiguous_leaves: bool = False) -> Dict[str, np.ndarray]:
        """Weights for one layer, keyed by leaf name ('kernel', 'bias', …)
        where unambiguous; full paths are always present. Ambiguous leaf
        names (nested submodels with several sub-layers) raise rather than
        silently loading the last-walked weight — unless the caller handles
        full paths itself (``allow_ambiguous_leaves``, e.g. the
        Bidirectional loader filters on forward_/backward_ prefixes)."""
        by_path = self.by_layer.get(layer_name, {})
        out: Dict[str, np.ndarray] = dict(by_path)
        leaves: Dict[str, list] = {}
        for path in by_path:
            leaves.setdefault(path.rsplit("/", 1)[-1], []).append(path)
        for leaf, paths in leaves.items():
            if leaf in out:      # a top-level dataset already owns this name
                continue
            if len(paths) > 1:
                if allow_ambiguous_leaves:
                    continue     # full paths remain available
                raise UnsupportedKerasConfigurationException(
                    f"Ambiguous weight name {leaf!r} in layer "
                    f"{layer_name!r}: {sorted(paths)} — nested submodel "
                    f"layouts must be addressed by full path")
            out[leaf] = by_path[paths[0]]
        return out


# ------------------------------------------------------------ layer mapping
# ---- custom/lambda layer registries (ref: KerasLayer.registerCustomLayer
# and KerasLayerUtils.registerLambdaLayer) -------------------------------
_CUSTOM_LAYERS: Dict[str, "object"] = {}
# single source of truth for lambda bodies: layers.LAMBDA_REGISTRY
_LAMBDA_LAYERS = L.LAMBDA_REGISTRY


def register_custom_layer(class_name: str, builder):
    """ref: ``KerasLayer.registerCustomLayer(name, clazz)``. ``builder`` is
    ``fn(config_dict) -> Layer``; consulted for unknown class_names."""
    _CUSTOM_LAYERS[class_name] = builder


def register_lambda_layer(layer_name: str, fn, output_type_fn=None):
    """ref: ``KerasLayerUtils.registerLambdaLayer``. ``fn`` is a
    torch ``fn(x) -> y`` bound to the Keras Lambda layer's NAME
    (lambda bodies cannot be deserialized from H5). ``output_type_fn``
    (InputType -> InputType) must be given for shape-CHANGING lambdas so
    downstream layers infer n_in correctly."""
    L.LAMBDA_REGISTRY[layer_name] = (fn, output_type_fn)


def _map_layer(cls: str, cfg: dict):
    """Keras layer config dict → (our Layer | '__flatten__' | None).

    Returning None means "structural no-op at runtime" (InputLayer etc.).
    """
    act = _map_activation(cfg.get("activation"))
    use_bias = cfg.get("use_bias", True)
    name = cfg.get("name")

    if cls == "InputLayer":
        return None
    if cls == "Flatten":
        # explicit row-major flatten (ref: KerasFlatten → preprocessor);
        # NHWC order matches Keras so Dense kernels line up
        return L.FlattenLayer(name=name)
    if cls == "Dense":
        return L.DenseLayer(name=name, n_out=cfg["units"], activation=act,
                            has_bias=use_bias)
    if cls == "Dropout":
        # Keras rate = drop prob; our dropout field = retain prob (ref parity)
        return L.DropoutLayer(name=name, dropout=1.0 - cfg["rate"])
    if cls in ("GaussianNoise", "GaussianDropout", "AlphaDropout"):
        from deeplearning4j_tpu_torch.nn.conf.dropout import (
            AlphaDropout, GaussianDropout, GaussianNoise)
        obj = {"GaussianNoise": lambda: GaussianNoise(
                   float(cfg.get("stddev", 0.1))),
               "GaussianDropout": lambda: GaussianDropout(
                   float(cfg.get("rate", 0.5))),
               "AlphaDropout": lambda: AlphaDropout(
                   1.0 - float(cfg.get("rate", 0.05)))}[cls]()
        return L.DropoutLayer(name=name, dropout=obj)
    if cls == "Activation":
        return L.ActivationLayer(name=name, activation=act)
    if cls == "Reshape":
        return L.ReshapeLayer(name=name,
                              target_shape=tuple(cfg["target_shape"]))
    if cls == "Permute":
        return L.PermuteLayer(name=name, dims=tuple(cfg["dims"]))
    if cls == "RepeatVector":
        return L.RepeatVectorLayer(name=name, n=int(cfg["n"]))
    if cls in ("SpatialDropout2D", "SpatialDropout1D"):
        # channel-wise dropout (ref: KerasSpatialDropout → SpatialDropout)
        return L.SpatialDropoutLayer(name=name, dropout=1.0 - cfg["rate"])
    if cls == "Conv2D" or cls == "Convolution2D":
        return L.ConvolutionLayer(
            name=name, n_out=cfg["filters"],
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            dilation=_pair(cfg.get("dilation_rate", 1)),
            padding=_padding(cfg), activation=act, has_bias=use_bias)
    if cls == "Conv2DTranspose":
        op = cfg.get("output_padding")
        return L.Deconvolution2D(
            name=name, n_out=cfg["filters"],
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            dilation=_pair(cfg.get("dilation_rate", 1)),
            output_padding=_pair(op) if op is not None else None,
            padding=_padding(cfg), activation=act, has_bias=use_bias)
    if cls == "SeparableConv2D":
        return L.SeparableConvolution2D(
            name=name, n_out=cfg["filters"],
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            depth_multiplier=cfg.get("depth_multiplier", 1),
            padding=_padding(cfg), activation=act, has_bias=use_bias)
    if cls == "SeparableConv1D":
        # __post_init__ normalizes list/tuple kernel/stride/dilation to int;
        # "same"/"causal" pass through as strings (the layer left-pads for
        # causal), anything else is valid = 0
        pad = cfg.get("padding", "valid")
        return L.SeparableConvolution1D(
            name=name, n_out=cfg["filters"],
            kernel_size=cfg["kernel_size"],
            stride=cfg.get("strides", 1),
            dilation=cfg.get("dilation_rate", 1),
            depth_multiplier=cfg.get("depth_multiplier", 1),
            padding=pad if pad in ("same", "causal") else 0,
            activation=act, has_bias=use_bias)
    if cls == "Conv3DTranspose":
        op3 = cfg.get("output_padding")
        d3 = cfg.get("dilation_rate", 1)
        return L.Deconvolution3D(
            name=name, n_out=cfg["filters"],
            kernel_size=tuple(cfg["kernel_size"]),
            stride=tuple(cfg.get("strides", (1, 1, 1))),
            dilation=tuple(d3) if not isinstance(d3, int) else (d3,) * 3,
            output_padding=tuple(op3) if op3 is not None else None,
            padding=_padding(cfg), activation=act, has_bias=use_bias)
    if cls == "ConvLSTM2D":
        if cfg.get("go_backwards") or cfg.get("stateful"):
            raise UnsupportedKerasConfigurationException(
                "ConvLSTM2D: go_backwards/stateful unsupported")
        if any(int(d) != 1 for d in _as_seq(cfg.get("dilation_rate", 1))):
            raise UnsupportedKerasConfigurationException(
                "ConvLSTM2D: dilation_rate != 1 unsupported")
        return L.ConvLSTM2D(
            name=name, n_out=cfg["filters"],
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            padding=cfg.get("padding", "valid"),   # string: same|valid
            activation=_map_activation(cfg.get("activation", "tanh")),
            recurrent_activation=cfg.get("recurrent_activation", "sigmoid"),
            return_sequences=bool(cfg.get("return_sequences", False)),
            has_bias=use_bias)
    if cls in ("MaxPooling2D", "MaxPool2D"):
        return L.SubsamplingLayer(
            name=name, pooling_type="max",
            kernel_size=_pair(cfg.get("pool_size", 2)),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
            padding=_padding(cfg))
    if cls in ("AveragePooling2D", "AvgPool2D"):
        return L.SubsamplingLayer(
            name=name, pooling_type="avg",
            kernel_size=_pair(cfg.get("pool_size", 2)),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
            padding=_padding(cfg))
    if cls in ("GlobalMaxPooling2D", "GlobalMaxPooling1D",
               "GlobalMaxPooling3D"):
        return L.GlobalPoolingLayer(name=name, pooling_type="max")
    if cls in ("GlobalAveragePooling2D", "GlobalAveragePooling1D",
               "GlobalAveragePooling3D"):
        return L.GlobalPoolingLayer(name=name, pooling_type="avg")
    if cls == "BatchNormalization":
        return L.BatchNormalization(name=name,
                                    decay=cfg.get("momentum", 0.99),
                                    eps=cfg.get("epsilon", 1e-3))
    if cls == "ZeroPadding2D":
        p = cfg.get("padding", 1)
        if isinstance(p, int):
            pads = (p, p, p, p)
        else:
            (t, b), (l, r) = [_pair(q) for q in p]
            pads = (t, b, l, r)
        return L.ZeroPaddingLayer(name=name, padding=pads)
    if cls == "Cropping2D":
        c = cfg.get("cropping", 0)
        if isinstance(c, int):
            crops = (c, c, c, c)
        else:
            (t, b), (l, r) = [_pair(q) for q in c]
            crops = (t, b, l, r)
        return L.Cropping2D(name=name, cropping=crops)
    if cls == "UpSampling2D":
        return L.Upsampling2D(name=name, size=_pair(cfg.get("size", 2)),
                              interpolation=cfg.get("interpolation",
                                                    "nearest"))
    # ---- tranche-2 layer mappings (ref KerasDepthwiseConvolution2D,
    # KerasPReLU, KerasThresholdedReLU, KerasMasking, KerasLocallyConnected,
    # the 1D/3D structural family — deeplearning4j-modelimport layers.*)
    if cls == "DepthwiseConv2D":
        return L.DepthwiseConvolution2D(
            name=name, kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", 1)),
            dilation=_pair(cfg.get("dilation_rate", 1)),
            depth_multiplier=cfg.get("depth_multiplier", 1),
            padding=_padding(cfg), activation=act, has_bias=use_bias)
    if cls == "PReLU":
        shared = cfg.get("shared_axes")
        if shared:
            raise UnsupportedKerasConfigurationException(
                "PReLU shared_axes unsupported — full-shape alpha only")
        return L.PReLULayer(name=name)
    if cls == "ThresholdedReLU":
        theta = float(cfg.get("theta", 1.0))
        return L.LambdaLayer(
            name=name or "thresholded_relu",
            fn=lambda x, _t=theta: torch.where(x > _t, x,
                                               torch.zeros_like(x)))
    if cls == "Masking":
        # fused with the FOLLOWING layer by the sequential walk (Keras
        # masking semantics = derive mask from mask_value rows and hand it
        # to the next recurrent layer) — MaskZeroLayer carries both steps
        return ("__masking__", float(cfg.get("mask_value", 0.0)), name)
    if cls in ("LocallyConnected2D", "LocallyConnected1D"):
        if _padding(cfg) not in (0, (0, 0), "valid", "VALID"):
            raise UnsupportedKerasConfigurationException(
                f"{cls}: only 'valid' padding")
        if int(cfg.get("implementation", 1)) not in (1, 2):
            # implementation=3 stores a scipy-sparse kernel whose
            # get_weights layout is backend-dependent — still refused
            raise UnsupportedKerasConfigurationException(
                f"{cls}: implementation=3 (sparse) kernels are not "
                f"importable; re-save with implementation=1 or 2")
        if cls == "LocallyConnected2D":
            return L.LocallyConnected2D(
                name=name, n_out=cfg["filters"],
                kernel_size=_pair(cfg["kernel_size"]),
                stride=_pair(cfg.get("strides", 1)),
                activation=act, has_bias=use_bias)
        return L.LocallyConnected1D(
            name=name, n_out=cfg["filters"],
            kernel_size=int(cfg["kernel_size"][0]
                            if isinstance(cfg["kernel_size"],
                                          (list, tuple))
                            else cfg["kernel_size"]),
            stride=int(cfg.get("strides", [1])[0]
                       if isinstance(cfg.get("strides", 1), (list, tuple))
                       else cfg.get("strides", 1)),
            activation=act, has_bias=use_bias)
    if cls == "Cropping1D":
        return L.Cropping1D(name=name, cropping=_pair(
            cfg.get("cropping", 1)))
    if cls == "ZeroPadding1D":
        return L.ZeroPadding1DLayer(name=name, padding=_pair(
            cfg.get("padding", 1)))
    if cls == "UpSampling1D":
        return L.Upsampling1D(name=name, size=int(cfg.get("size", 2)))
    if cls == "Cropping3D":
        c = cfg.get("cropping", 0)
        if isinstance(c, int):
            crops = (c,) * 6
        else:
            crops = tuple(int(v) for pair in c for v in _pair(pair))
        return L.Cropping3D(name=name, cropping=crops)
    if cls == "ZeroPadding3D":
        p = cfg.get("padding", 1)
        if isinstance(p, int):
            pads = (p,) * 6
        else:
            pads = tuple(int(v) for pair in p for v in _pair(pair))
        return L.ZeroPadding3DLayer(name=name, padding=pads)
    if cls == "UpSampling3D":
        s = cfg.get("size", 2)
        return L.Upsampling3D(name=name, size=(s,) * 3
                              if isinstance(s, int) else tuple(s))
    if cls in ("MaxPooling1D", "AveragePooling1D"):
        pool = "max" if cls.startswith("Max") else "avg"
        ps = cfg.get("pool_size", 2)
        ps = int(ps[0] if isinstance(ps, (list, tuple)) else ps)
        st = cfg.get("strides") or ps
        st = int(st[0] if isinstance(st, (list, tuple)) else st)
        return L.Subsampling1DLayer(name=name, pooling_type=pool,
                                    kernel_size=ps, stride=st,
                                    padding=_padding(cfg))
    if cls in ("MaxPooling3D", "AveragePooling3D"):
        pool = "max" if cls.startswith("Max") else "avg"
        ps = cfg.get("pool_size", 2)
        ps = (ps,) * 3 if isinstance(ps, int) else tuple(ps)
        st = cfg.get("strides") or ps
        st = (st,) * 3 if isinstance(st, int) else tuple(st)
        return L.Subsampling3DLayer(name=name, pooling_type=pool,
                                    kernel_size=ps, stride=st,
                                    padding=_padding(cfg))
    if cls == "Embedding":
        return L.EmbeddingSequenceLayer(name=name, n_in=cfg["input_dim"],
                                        n_out=cfg["output_dim"])
    if cls in ("Conv1D", "Convolution1D"):
        pad = cfg.get("padding", "valid")
        pad = {"valid": 0, "same": "same", "causal": "causal"}[pad]
        ks = cfg["kernel_size"]
        return L.Convolution1DLayer(
            name=name, n_out=cfg["filters"],
            kernel_size=ks[0] if isinstance(ks, (list, tuple)) else ks,
            stride=(cfg.get("strides", [1]) or [1])[0]
            if isinstance(cfg.get("strides", 1), (list, tuple))
            else cfg.get("strides", 1),
            dilation=(cfg.get("dilation_rate", [1]) or [1])[0]
            if isinstance(cfg.get("dilation_rate", 1), (list, tuple))
            else cfg.get("dilation_rate", 1),
            padding=pad, activation=act, has_bias=use_bias)
    if cls in ("Conv3D", "Convolution3D"):
        return L.Convolution3D(
            name=name, n_out=cfg["filters"],
            kernel_size=tuple(cfg["kernel_size"]),
            stride=tuple(cfg.get("strides", (1, 1, 1))),
            dilation=tuple(cfg.get("dilation_rate", (1, 1, 1))),
            padding=_padding(cfg), activation=act, has_bias=use_bias)
    if cls == "LayerNormalization":
        # we normalize over the LAST dim. Keras 3 keeps axis=-1; Keras 2
        # (tf_keras) H5 configs carry the RESOLVED positive axis with no
        # per-layer build_config — defer the rank check to the layer's
        # shape-inference (LayerNormalization.set_n_in), where the input
        # rank is known.
        axis = cfg.get("axis", -1)
        axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
        if len(axes) != 1:
            raise UnsupportedKerasConfigurationException(
                f"LayerNormalization over multiple axes {axes} unsupported")
        return L.LayerNormalization(name=name, eps=cfg.get("epsilon", 1e-3),
                                    axis=int(axes[0]))
    if cls == "LeakyReLU":
        alpha = cfg.get("negative_slope", cfg.get("alpha", 0.3))
        return L.ActivationLayer(name=name,
                                 activation=f"leakyrelu:{alpha}")
    if cls == "ELU":
        return L.ActivationLayer(name=name, activation="elu")
    if cls == "ReLU":
        max_value = cfg.get("max_value")
        slope = cfg.get("negative_slope", 0.0) or 0.0
        if cfg.get("threshold", 0.0):
            raise UnsupportedKerasConfigurationException(
                "ReLU threshold != 0 is not supported")
        if slope:
            return L.ActivationLayer(name=name,
                                     activation=f"leakyrelu:{slope}")
        if max_value == 6.0:
            return L.ActivationLayer(name=name, activation="relu6")
        if max_value is not None:
            raise UnsupportedKerasConfigurationException(
                f"ReLU max_value={max_value} unsupported (only None/6.0)")
        return L.ActivationLayer(name=name, activation="relu")
    if cls == "Softmax":
        return L.ActivationLayer(name=name, activation="softmax")
    if cls == "TimeDistributed":
        # TimeDistributed(Dense) == our per-timestep dense on rnn input
        inner = cfg["layer"]
        mapped = _map_layer(inner["class_name"], inner["config"])
        if not isinstance(mapped, L.DenseLayer):
            raise UnsupportedKerasConfigurationException(
                "TimeDistributed only supported around Dense")
        mapped.name = name or mapped.name
        return mapped
    if cls == "Bidirectional":
        inner = cfg["layer"]
        mapped = _map_layer(inner["class_name"], inner["config"])
        wrapped = mapped
        if isinstance(mapped, L.LastTimeStep):
            wrapped = mapped._inner_layer
        mode = {"concat": "concat", "sum": "add", "ave": "average",
                "mul": "mul"}.get(cfg.get("merge_mode", "concat"), "concat")
        bi = L.Bidirectional.wrap(wrapped, mode=mode)
        bi.name = name
        if isinstance(mapped, L.LastTimeStep):
            return L.LastTimeStep.wrap(bi)
        return bi
    if cls in ("LSTM", "GRU", "SimpleRNN"):
        ctor = {"LSTM": L.LSTM, "GRU": L.GRU, "SimpleRNN": L.SimpleRnn}[cls]
        kw = {}
        if cls == "GRU":
            if not cfg.get("reset_after", True):
                raise UnsupportedKerasConfigurationException(
                    "GRU reset_after=False is not supported (candidate-gate "
                    "formulation differs); re-save with reset_after=True")
            kw["recurrent_bias"] = True
        lyr = ctor(name=name, n_out=cfg["units"],
                   activation=_map_activation(cfg.get("activation", "tanh")),
                   **kw)
        if not cfg.get("return_sequences", False):
            # wrapped, as the reference's KerasLSTM does with LastTimeStep
            return L.LastTimeStep.wrap(lyr)
        return lyr
    if cls == "Lambda":
        entry = _LAMBDA_LAYERS.get(name)
        if entry is None:
            raise UnsupportedKerasConfigurationException(
                f"Keras Lambda layer {name!r}: register its body with "
                f"keras.register_lambda_layer({name!r}, fn) before import "
                f"(lambda code cannot be read from H5)")
        fn, ot = entry
        return L.LambdaLayer(name=name, fn=fn, output_type_fn=ot)
    if cls in _CUSTOM_LAYERS:
        return _CUSTOM_LAYERS[cls](cfg)
    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras layer type {cls!r} (register a builder with "
        f"keras.register_custom_layer({cls!r}, builder))")


def _tensor(a) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a`` (the network moves it)."""
    return torch.from_numpy(np.array(a))


def _load_weights_into(layer, w: Dict[str, np.ndarray], params: dict,
                       states: dict, lkey: str):
    """Copy Keras weights into our param/state trees for one layer, as
    CPU tensors (the importer then moves the trees to the network's
    device)."""
    if not w:
        return
    def put(our, theirs):
        if theirs in w:
            params.setdefault(lkey, {})[our] = _tensor(w[theirs])
    while isinstance(layer, (L.LastTimeStep, L.MaskZeroLayer)):
        layer._materialize()
        layer = layer._inner_layer   # params live under the wrapper's key
    if isinstance(layer, L.SeparableConvolution2D):
        put("dW", "depthwise_kernel")
        put("pW", "pointwise_kernel")
        put("b", "bias")
    elif isinstance(layer, L.SeparableConvolution1D):
        put("dW", "depthwise_kernel")
        if "pointwise_kernel" in w:          # keras (1, C*dm, F) → (C*dm, F)
            params.setdefault(lkey, {})["pW"] = _tensor(
                np.asarray(w["pointwise_kernel"])[0])
        put("b", "bias")
    elif isinstance(layer, (L.Deconvolution2D, L.Deconvolution3D)):
        # keras Conv{2,3}DTranspose kernel is (*k, OUT, IN); ours (*k, IN, OUT)
        if "kernel" in w:
            kk = np.asarray(w["kernel"])
            perm = tuple(range(kk.ndim - 2)) + (kk.ndim - 1, kk.ndim - 2)
            params.setdefault(lkey, {})["W"] = _tensor(
                kk.transpose(perm))
        put("b", "bias")
    elif isinstance(layer, L.ConvLSTM2D):
        put("W", "kernel")
        put("RW", "recurrent_kernel")
        put("b", "bias")
    elif isinstance(layer, L.SelfAttentionLayer):
        # keras MultiHeadAttention sublayer paths: query/key/value einsum
        # kernels (C, H, dh) + biases (H, dh); attention_output kernel
        # (H, dh, C_out) + bias (C_out,)
        hs = layer.n_heads * layer.head_size

        def find(path_suffix):
            for k, v in w.items():
                if k.endswith(path_suffix):
                    return np.asarray(v)
            return None

        for ours, theirs in (("Wq", "query/kernel"), ("Wk", "key/kernel"),
                             ("Wv", "value/kernel")):
            arr = find(theirs)
            if arr is not None:
                # einsum kernel (C, H, dh) — C is the SOURCE's feature dim
                # (differs per projection for cross attention)
                params.setdefault(lkey, {})[ours] = _tensor(
                    arr.reshape(arr.shape[0], hs))
        arr = find("attention_output/kernel")
        if arr is not None:
            params.setdefault(lkey, {})["Wo"] = _tensor(
                arr.reshape(hs, layer.n_out))
        if layer.qkv_bias:
            for ours, theirs in (("bq", "query/bias"), ("bk", "key/bias"),
                                 ("bv", "value/bias"),
                                 ("bo", "attention_output/bias")):
                arr = find(theirs)
                if arr is not None:
                    params.setdefault(lkey, {})[ours] = _tensor(
                        arr.reshape(-1))
    elif isinstance(layer, L.DepthwiseConvolution2D):
        # Keras 2 names it depthwise_kernel; Keras 3 plain kernel
        put("dW", "depthwise_kernel")
        put("dW", "kernel")
        put("b", "bias")
    elif isinstance(layer, L.PReLULayer):
        put("alpha", "alpha")
    elif isinstance(layer, (L.LocallyConnected2D, L.LocallyConnected1D)):
        # Keras LC implementation=1 kernel: (positions, kh*kw*in, filters),
        # feature axis in (*k, C) order — exactly the layer's internal
        # patch layout, so a pure reshape onto the position grid suffices.
        # implementation=2 stores the FULL masked dense kernel
        # (in_spatial…, cin, out_spatial…, filters); the local weights are
        # its banded diagonal — extracted below (r5 closes that refusal).
        for pname in ("kernel", "bias"):
            arr = w.get(pname)
            if arr is None:
                continue
            arr = np.asarray(arr)
            our = "W" if pname == "kernel" else "b"
            tgt = layer.param_shapes()[our]
            if pname == "kernel" and isinstance(
                    layer, L.LocallyConnected2D) and arr.ndim == 6:
                oh, ow, fd, f = tgt
                kh, kw = layer.kernel_size
                sh, sw = layer.stride
                cin = fd // (kh * kw)
                out = np.empty((oh, ow, kh, kw, cin, f), arr.dtype)
                for dh in range(kh):
                    for dw in range(kw):
                        sub = arr[dh:dh + oh * sh:sh,
                                  dw:dw + ow * sw:sw]
                        out[:, :, dh, dw] = np.einsum("ijcijf->ijcf", sub)
                arr = out
            elif pname == "kernel" and isinstance(
                    layer, L.LocallyConnected1D) and arr.ndim == 4:
                ol, fd, f = tgt
                k, s = layer.kernel_size, layer.stride
                cin = fd // k
                out = np.empty((ol, k, cin, f), arr.dtype)
                for d in range(k):
                    out[:, d] = np.einsum("icif->icf",
                                          arr[d:d + ol * s:s])
                arr = out
            params.setdefault(lkey, {})[our] = _tensor(
                np.reshape(arr, tgt))
    elif isinstance(layer, L.BatchNormalization):
        put("gamma", "gamma")
        put("beta", "beta")
        st = states.setdefault(lkey, {})
        if "moving_mean" in w:
            st["mean"] = _tensor(w["moving_mean"])
        if "moving_variance" in w:
            st["var"] = _tensor(w["moving_variance"])
    elif isinstance(layer, (L.LSTM, L.SimpleRnn)):
        put("W", "kernel")
        put("RW", "recurrent_kernel")
        put("b", "bias")
    elif isinstance(layer, L.GRU):
        # Keras gate order (z, r, h) -> ours (r, u=z, n); Keras default
        # reset_after=True carries a (2, 3u) bias: [input_bias, recurrent_bias]
        k, rk = w.get("kernel"), w.get("recurrent_kernel")
        if k is not None and rk is not None:
            u = k.shape[1] // 3

            def reorder(m):
                return np.concatenate([m[:, u:2 * u], m[:, :u], m[:, 2 * u:]],
                                      axis=1)
            params.setdefault(lkey, {})["W"] = _tensor(reorder(k))
            params[lkey]["RW"] = _tensor(reorder(rk))
            b = w.get("bias")
            if b is not None:
                def reorder_b(v):
                    return np.concatenate([v[u:2 * u], v[:u], v[2 * u:]])
                if b.ndim == 2:      # reset_after=True
                    params[lkey]["b"] = _tensor(reorder_b(b[0]))
                    params[lkey]["bR"] = _tensor(reorder_b(b[1]))
                else:
                    params[lkey]["b"] = _tensor(reorder_b(b))
    elif isinstance(layer, (L.EmbeddingLayer, L.EmbeddingSequenceLayer)):
        put("W", "embeddings")
    elif isinstance(layer, L.LayerNormalization):
        put("gamma", "gamma")
        put("beta", "beta")
    elif isinstance(layer, L.Bidirectional):
        # Keras nests weights per direction; our params are flat
        # "f_<name>"/"b_<name>" keys (Bidirectional.param_shapes)
        layer._materialize()
        for ours_prefix, theirs_prefix in (("f_", "forward_"),
                                           ("b_", "backward_")):
            sub = {k.split("/")[-1]: v for k, v in w.items()
                   if k.startswith(theirs_prefix)
                   or f"/{theirs_prefix}" in k}
            if sub:
                inner_params = {}
                _load_weights_into(layer._fwd_layer, sub, inner_params,
                                   {}, "x")
                for pname, val in inner_params.get("x", {}).items():
                    params.setdefault(lkey, {})[ours_prefix + pname] = val
    else:
        put("W", "kernel")
        put("b", "bias")


def _input_type_from_config(cfg_layers: List[dict]) -> Optional[InputType]:
    """Infer InputType from the first layer's batch_shape/batch_input_shape."""
    for ld in cfg_layers:
        cfg = ld.get("config", {})
        shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
        if shape:
            dims = [d for d in shape[1:]]
            if len(dims) == 4:
                return InputType.convolutional3d(dims[0], dims[1], dims[2],
                                                 dims[3])
            if len(dims) == 3:
                return InputType.convolutional(dims[0], dims[1], dims[2])
            if len(dims) == 2:
                return InputType.recurrent(dims[1], dims[0])
            if len(dims) == 1:
                return InputType.feed_forward(dims[0])
    return None


class KerasModelImport:
    """ref: KerasModelImport#importKerasSequentialModelAndWeights /
    #importKerasModelAndWeights."""

    @staticmethod
    def import_keras_sequential_model_and_weights(
            h5_path: str, enforce_training_config: bool = False,
            device=None):
        """Sequential model → MultiLayerNetwork on ``device`` (None: the
        card)."""
        with hdf5.File(h5_path, "r") as f:
            model_config = json.loads(f.attrs["model_config"])
            weights = _H5Weights(f)
            if model_config["class_name"] != "Sequential":
                raise InvalidKerasConfigurationException(
                    "not a Sequential model; use import_keras_model_and_weights")
            layer_dicts = model_config["config"]["layers"]
            input_type = _input_type_from_config(layer_dicts)

            b = (NeuralNetConfiguration.builder()
                 .updater(Adam(1e-3)).weight_init("xavier").list())
            mapped: List[tuple] = []   # (our layer, keras name)
            pending_mask = None        # (mask_value, name) from Masking
            for ld in layer_dicts:
                out = _map_layer(ld["class_name"], ld["config"])
                if out is None:
                    continue
                if isinstance(out, tuple) and out[0] == "__masking__":
                    pending_mask = (out[1], out[2])
                    continue
                for lyr in (out if isinstance(out, list) else [out]):
                    if pending_mask is not None:
                        mv, mname = pending_mask
                        pending_mask = None
                        lyr = L.MaskZeroLayer.wrap(lyr, mask_value=mv)
                        lyr.name = mname
                    mapped.append((lyr, ld["config"].get("name")))
            if pending_mask is not None:
                raise UnsupportedKerasConfigurationException(
                    "Masking as the FINAL layer has nothing to mask")
            # Keras graphs carry no loss head; make the net trainable by
            # promoting the final Dense to an OutputLayer with a loss
            # inferred from its activation (ref: KerasLoss mapping)
            if mapped and type(mapped[-1][0]) is L.DenseLayer:
                d = mapped[-1][0]
                loss = {"softmax": "mcxent", "sigmoid": "xent"}.get(
                    d.activation, "mse")
                mapped[-1] = (L.OutputLayer(
                    name=d.name, n_out=d.n_out, activation=d.activation,
                    has_bias=d.has_bias, loss_function=loss), mapped[-1][1])
            elif mapped and not hasattr(mapped[-1][0], "loss"):
                mapped.append((L.LossLayer(loss_function="mse"), None))
            for lyr, _ in mapped:
                b.layer(lyr)
            if input_type is not None:
                b.set_input_type(input_type)
            conf = b.build()

            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork)
            net = MultiLayerNetwork(conf, device=device).init()
            for i, (lyr, kname) in enumerate(mapped):
                _load_weights_into(
                    lyr, weights.get(kname, allow_ambiguous_leaves=isinstance(
                        lyr, (L.Bidirectional, L.SelfAttentionLayer))),
                    net._params, net._states, str(i))
            return _placed(net)

    importKerasSequentialModelAndWeights = import_keras_sequential_model_and_weights

    @staticmethod
    def import_keras_model_and_weights(h5_path: str, device=None):
        """Functional-API model → ComputationGraph on ``device`` (None:
        the card)."""
        with hdf5.File(h5_path, "r") as f:
            model_config = json.loads(f.attrs["model_config"])
            weights = _H5Weights(f)
            if model_config["class_name"] == "Sequential":
                return KerasModelImport.import_keras_sequential_model_and_weights(
                    h5_path, device=device)
            cfg = model_config["config"]
            g = (NeuralNetConfiguration.builder()
                 .updater(Adam(1e-3)).weight_init("xavier").graph_builder())

            # keras node name → our vertex name (keras layer names are unique)
            input_names = []
            input_types = []
            name_of = {}
            mapped = {}
            for ld in cfg["layers"]:
                cls, lcfg = ld["class_name"], ld["config"]
                name = ld.get("name") or lcfg.get("name")
                inbound = _inbound_layer_names(ld.get("inbound_nodes"))
                if cls == "InputLayer":
                    input_names.append(name)
                    name_of[name] = name
                    shape = lcfg.get("batch_shape") or lcfg.get("batch_input_shape")
                    dims = list(shape[1:]) if shape else []
                    if len(dims) == 4:
                        input_types.append(InputType.convolutional3d(*dims))
                    elif len(dims) == 3:
                        input_types.append(InputType.convolutional(*dims))
                    elif len(dims) == 2:
                        input_types.append(InputType.recurrent(dims[1], dims[0]))
                    else:
                        input_types.append(InputType.feed_forward(dims[0] if dims else 0))
                    continue
                srcs = [name_of[s] for s in inbound if s in name_of]
                if cls == "Add":
                    g.add_vertex(name, ElementWiseVertex(op="add"), *srcs)
                elif cls in ("Concatenate", "Merge"):
                    g.add_vertex(name, MergeVertex(), *srcs)
                elif cls in ("Subtract",):
                    g.add_vertex(name, ElementWiseVertex(op="sub"), *srcs)
                elif cls in ("Multiply",):
                    g.add_vertex(name, ElementWiseVertex(op="prod"), *srcs)
                elif cls in ("Average",):
                    g.add_vertex(name, ElementWiseVertex(op="avg"), *srcs)
                elif cls in ("Maximum",):
                    g.add_vertex(name, ElementWiseVertex(op="max"), *srcs)
                elif cls in ("Minimum",):
                    g.add_vertex(name, ElementWiseVertex(op="min"), *srcs)
                elif cls == "Dot":
                    from deeplearning4j_tpu_torch.nn.graph_conf import (
                        DotVertex)
                    ax = lcfg.get("axes", -1)
                    g.add_vertex(name, DotVertex(
                        axes=tuple(ax) if isinstance(ax, list) else ax,
                        normalize=bool(lcfg.get("normalize", False))), *srcs)
                elif cls in ("Attention", "AdditiveAttention"):
                    from deeplearning4j_tpu_torch.nn.graph_conf import (
                        AdditiveAttentionVertex, DotProductAttentionVertex)
                    if lcfg.get("use_scale") and cls == "Attention":
                        raise UnsupportedKerasConfigurationException(
                            "Attention(use_scale=True) carries a learned "
                            "scale — re-save with use_scale=False")
                    if cls == "AdditiveAttention" \
                            and lcfg.get("use_scale", True):
                        raise UnsupportedKerasConfigurationException(
                            "AdditiveAttention(use_scale=True) carries a "
                            "learned scale vector — re-save with "
                            "use_scale=False")
                    if lcfg.get("score_mode", "dot") not in ("dot",):
                        raise UnsupportedKerasConfigurationException(
                            f"Attention score_mode "
                            f"{lcfg.get('score_mode')!r} unsupported")
                    vcls = (DotProductAttentionVertex if cls == "Attention"
                            else AdditiveAttentionVertex)
                    g.add_vertex(name, vcls(
                        causal=bool(lcfg.get("causal", False))), *srcs)
                elif cls == "MultiHeadAttention":
                    if lcfg.get("value_dim") not in (None,
                                                     lcfg.get("key_dim")):
                        raise UnsupportedKerasConfigurationException(
                            "MultiHeadAttention: value_dim != key_dim "
                            "unsupported")
                    if lcfg.get("output_shape"):
                        raise UnsupportedKerasConfigurationException(
                            "MultiHeadAttention: custom output_shape "
                            "unsupported")
                    if len(set(srcs)) == 1:
                        lyr = L.SelfAttentionLayer(
                            name=name, n_heads=int(lcfg["num_heads"]),
                            head_size=int(lcfg["key_dim"]),
                            qkv_bias=bool(lcfg.get("use_bias", True)))
                        g.add_layer(name, lyr, srcs[0])
                    else:
                        # cross form: Keras call order (query, value[, key])
                        lyr = L.CrossAttentionLayer(
                            name=name, n_heads=int(lcfg["num_heads"]),
                            head_size=int(lcfg["key_dim"]),
                            qkv_bias=bool(lcfg.get("use_bias", True)))
                        g.add_layer(name, lyr, *srcs)
                    mapped[name] = lyr
                else:
                    out = _map_layer(cls, lcfg)
                    if out is None:
                        name_of[name] = srcs[0]
                        continue
                    if isinstance(out, tuple) and out[0] == "__masking__":
                        raise UnsupportedKerasConfigurationException(
                            "Masking in functional graphs unsupported — "
                            "wrap the consumer in MaskZeroLayer instead")
                    lyrs = out if isinstance(out, list) else [out]
                    prev = srcs
                    for j, lyr in enumerate(lyrs):
                        vname = name if j == 0 else f"{name}__{j}"
                        g.add_layer(vname, lyr, *prev)
                        prev = [vname]
                        if j == 0:
                            mapped[name] = lyr
                    name_of[name] = prev[0]
                    continue
                name_of[name] = name
            g.add_inputs(*input_names)
            g.set_input_types(*input_types)
            outputs = [name_of[o] for o in _output_names(cfg)]
            g.set_outputs(*outputs)
            conf = g.build()
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
            net = ComputationGraph(conf, device=device).init()
            for kname, lyr in mapped.items():
                _load_weights_into(
                    lyr, weights.get(kname, allow_ambiguous_leaves=isinstance(
                        lyr, (L.Bidirectional, L.SelfAttentionLayer))),
                    net._params, net._states, kname)
            return _placed(net)

    importKerasModelAndWeights = import_keras_model_and_weights


def _placed(net):
    """``net`` with its loaded trees on its device and its updater state
    made anew over the loaded params."""
    net.set_param_tree(net._params)
    net.set_state_tree(net._states)
    net._opt_state = net._opt.init(net._leaves())
    return net


def _inbound_layer_names(inbound_nodes) -> List[str]:
    """Source layer names from inbound_nodes, across Keras 2
    (``[[["name", 0, 0, {}], ...]]``) and Keras 3
    (``[{"args": [{"config": {"keras_history": ["name", 0, 0]}}]}]``)."""
    names: List[str] = []

    def walk(obj):
        if isinstance(obj, dict):
            hist = obj.get("keras_history")
            if isinstance(hist, list) and hist and isinstance(hist[0], str):
                names.append(hist[0])
            for k, v in obj.items():
                if k != "keras_history":
                    walk(v)
        elif isinstance(obj, list):
            # keras2 node: ["layer_name", node_idx, tensor_idx, {kwargs}]
            if (len(obj) >= 3 and isinstance(obj[0], str)
                    and isinstance(obj[1], int) and isinstance(obj[2], int)):
                names.append(obj[0])
                # call-KWARG tensors ride the 4th slot (Keras 2 saves
                # MultiHeadAttention's value/key as {"value": [name,0,0]})
                # — in insertion order, preserving (query, value[, key])
                if len(obj) >= 4 and isinstance(obj[3], dict):
                    for v in obj[3].values():
                        walk(v)
            else:
                for v in obj:
                    walk(v)

    walk(inbound_nodes or [])
    return names


def _output_names(cfg) -> List[str]:
    outs = cfg.get("output_layers", [])
    # flat single output ["name", 0, 0] vs list of such triples
    if (len(outs) >= 1 and isinstance(outs[0], str)):
        return [outs[0]]
    return [o[0] for o in outs if isinstance(o, (list, tuple)) and o]
