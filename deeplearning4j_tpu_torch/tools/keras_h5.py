"""Keras H5 files authored without Keras: a minimal HDF5 writer and two
model authors, for the port's tests and ``chip_smoke.py``'s Keras phase.

The writer emits what ``h5py`` writes by default: superblock v0, version-1
object headers, symbol-table groups (a v1 B-tree over SNOD leaves and a
local heap; leaf K 4, internal K 16, as many B-tree levels as the
children need), contiguous datasets, and attributes of numbers, of
fixed-length strings (numpy ``'S'``) and of variable-length strings (a
``str`` is UTF-8, ``bytes`` ASCII, as ``h5py`` stores them) in global heap
collections.

The authors write a model the way Keras 3's legacy H5 save does
(``keras/src/legacy/saving/legacy_h5_format.py``): the root's
``model_config`` (the JSON config, as bytes), ``keras_version`` and
``backend``; ``model_weights`` with ``layer_names`` (split into
``layer_names0``, ``layer_names1``, ... past 64512 bytes), and a group per
layer, in name order, holding ``weight_names`` and the weights at their
variable paths. Weights are drawn from a seed with numpy.

- :func:`resnet50_config` / :func:`write_resnet50`: ``keras.applications
  .ResNet50``'s functional model (layer names, order and inbound nodes as
  Keras saves them), its input size and class count as arguments.
- :func:`char_lstm_config` / :func:`write_char_lstm`: a ``Sequential``
  char-LSTM, ``Input((50, 47))``, two ``LSTM(256, return_sequences=True)``
  and ``TimeDistributed(Dense(47, softmax))``.

Run as a script it writes the ResNet-50: ``python -m
deeplearning4j_tpu_torch.tools.keras_h5 out.h5 --size 224 --classes 1000``.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

KERAS_VERSION = "3.13.1"
HDF5_OBJECT_HEADER_LIMIT = 64512
_UNDEF = (1 << 64) - 1
_LEAF_K, _INTERNAL_K = 4, 16


# ------------------------------------------------------------------ writer
class Group:
    """An HDF5 group being built: ``attrs`` and ``members`` by name."""

    def __init__(self):
        self.attrs: Dict[str, object] = {}
        self.members: Dict[str, object] = {}

    def create_group(self, path: str) -> "Group":
        node = self
        for part in [p for p in path.split("/") if p]:
            child = node.members.get(part)
            if child is None:
                child = node.members[part] = Group()
            elif not isinstance(child, Group):
                raise ValueError(f"{part!r} is a dataset")
            node = child
        return node

    def create_dataset(self, path: str, data) -> "Dataset":
        head, _, leaf = path.rpartition("/")
        group = self.create_group(head) if head else self
        if leaf in group.members:
            raise ValueError(f"{path!r} exists")
        ds = group.members[leaf] = Dataset(data)
        return ds


class Dataset:
    """An HDF5 dataset being built: a numpy array and ``attrs``."""

    def __init__(self, data):
        self.data = np.ascontiguousarray(data)
        self.attrs: Dict[str, object] = {}


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _u(v: int, n: int) -> bytes:
    return int(v).to_bytes(n, "little")


def _datatype(dtype: np.dtype) -> bytes:
    """The datatype message of a numpy dtype (little-endian numbers and
    ``'S'`` strings)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        layout = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
                  8: (63, 52, 11, 52, 1023)}
        if dtype.itemsize not in layout or dtype.byteorder == ">":
            raise TypeError(f"unsupported float dtype {dtype}")
        sign, exp_at, exp_size, mant_size, bias = layout[dtype.itemsize]
        return (bytes([0x11, 0x20, sign, 0]) + _u(dtype.itemsize, 4)
                + _u(0, 2) + _u(8 * dtype.itemsize, 2)
                + bytes([exp_at, exp_size, 0, mant_size]) + _u(bias, 4))
    if dtype.kind in "iu":
        if dtype.byteorder == ">":
            raise TypeError(f"unsupported integer dtype {dtype}")
        return (bytes([0x10, 0x08 if dtype.kind == "i" else 0, 0, 0])
                + _u(dtype.itemsize, 4) + _u(0, 2)
                + _u(8 * dtype.itemsize, 2))
    if dtype.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + _u(dtype.itemsize, 4)
    raise TypeError(f"unsupported dtype {dtype}")


def _vlen_string_type(utf8: bool) -> bytes:
    base = bytes([0x10, 0, 0, 0]) + _u(1, 4) + _u(0, 2) + _u(8, 2)
    return bytes([0x19, 0x01, 1 if utf8 else 0, 0]) + _u(16, 4) + base


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    return (bytes([1, len(shape), 0, 0]) + _u(0, 4)
            + b"".join(_u(d, 8) for d in shape))


class _File:
    """The bytes being laid out, and the global heap strings."""

    def __init__(self):
        self.out = bytearray(b"\0" * 96)         # the superblock, last

    def put(self, data: bytes) -> int:
        at = len(self.out)
        self.out += _pad8(bytes(data))
        return at

    def strings(self, values: List[bytes]) -> List[Tuple[int, int]]:
        """Write ``values`` to a global heap collection: [(address,
        index)] of each."""
        body = bytearray()
        for i, v in enumerate(values, start=1):
            body += _pad8(_u(i, 2) + _u(1, 2) + _u(0, 4) + _u(len(v), 8)
                          + v)
        size = max(4096, 16 + len(body) + 16)
        free = size - 16 - len(body)
        body += _u(0, 2) + _u(0, 2) + _u(0, 4) + _u(free, 8)
        body += b"\0" * (free - 16)
        at = self.put(b"GCOL" + bytes([1, 0, 0, 0]) + _u(size, 8) + body)
        return [(at, i) for i in range(1, len(values) + 1)]

    def attribute(self, name: str, value) -> bytes:
        """An attribute message (version 1) for ``value``, as ``h5py``
        stores it."""
        if isinstance(value, (str, bytes)):
            value = np.array([value], dtype=object).reshape(())
        elif isinstance(value, (list, tuple)):
            value = (np.array(list(value), dtype=object) if value
                     and all(isinstance(v, (str, bytes)) for v in value)
                     else np.asarray(value))
        else:
            value = np.asarray(value)
        if value.dtype == object:
            items = value.reshape(-1).tolist()
            utf8 = any(isinstance(v, str) for v in items)
            raw = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
                   for v in items]
            refs = self.strings(raw) if raw else []
            dtype = _vlen_string_type(utf8)
            data = b"".join(_u(len(v), 4) + _u(at, 8) + _u(i, 4)
                            for v, (at, i) in zip(raw, refs))
        else:
            dtype = _datatype(value.dtype)
            data = value.tobytes()
        space = _dataspace(value.shape)
        encoded = name.encode("utf-8") + b"\0"
        msg = (bytes([1, 0]) + _u(len(encoded), 2) + _u(len(dtype), 2)
               + _u(len(space), 2) + _pad8(encoded) + _pad8(dtype)
               + _pad8(space) + data)
        return _pad8(msg)

    def header(self, messages: List[Tuple[int, bytes]]) -> int:
        """A version-1 object header holding ``messages`` [(type,
        data)]."""
        body = b"".join(_u(t, 2) + _u(len(_pad8(d)), 2) + bytes(4)
                        + _pad8(d) for t, d in messages)
        if any(len(_pad8(d)) >= 1 << 16 for _, d in messages):
            raise ValueError("an object header message of 64 KiB or more")
        return self.put(bytes([1, 0]) + _u(len(messages), 2) + _u(1, 4)
                        + _u(len(body), 4) + bytes(4) + body)

    def dataset(self, ds: Dataset) -> int:
        arr = ds.data
        nbytes = arr.nbytes
        addr = self.put(arr.tobytes()) if nbytes else _UNDEF
        layout = bytes([3, 1]) + _u(addr, 8) + _u(nbytes, 8)
        messages = [(0x01, _dataspace(arr.shape)),
                    (0x03, _datatype(arr.dtype)), (0x08, layout)]
        messages += [(0x0C, self.attribute(k, v))
                     for k, v in ds.attrs.items()]
        return self.header(messages)

    def group(self, g: Group) -> int:
        names = sorted(g.members, key=lambda s: s.encode("utf-8"))
        addrs = {n: (self.group(m) if isinstance(m, Group)
                     else self.dataset(m)) for n, m in g.members.items()}
        # the local heap: "" at 0, then each name, 8-byte aligned
        heap, offset = bytearray(8), {}
        for n in names:
            offset[n] = len(heap)
            heap += _pad8(n.encode("utf-8") + b"\0")
        heap_at = len(self.out)
        self.put(b"HEAP" + bytes(4) + _u(len(heap), 8) + _u(1, 8)
                 + _u(heap_at + 32, 8) + bytes(heap))
        # the leaves: 2K entries each, filled in order
        leaves = []
        per_leaf = 2 * _LEAF_K
        for i in range(0, len(names), per_leaf):
            chunk = names[i:i + per_leaf]
            entries = b"".join(_u(offset[n], 8) + _u(addrs[n], 8)
                               + bytes(24) for n in chunk)
            entries += bytes(40 * (per_leaf - len(chunk)))
            at = self.put(b"SNOD" + bytes([1, 0]) + _u(len(chunk), 2)
                          + entries)
            leaves.append((at, offset[chunk[-1]]))
        # the B-tree, level by level up to one root
        level, nodes = 0, leaves
        while True:
            parents = []
            fan = 2 * _INTERNAL_K
            groups = ([nodes[i:i + fan] for i in range(0, len(nodes), fan)]
                      or [[]])
            addrs_at = []
            for kids in groups:
                body = _u(0, 8) + b"".join(_u(a, 8) + _u(k, 8)
                                           for a, k in kids)
                body += bytes(16 * (fan - len(kids)))
                addrs_at.append((body, kids))
            node_size = 24 + 8 + 16 * fan
            starts = [len(self.out) + j * node_size
                      for j in range(len(addrs_at))]
            for j, (body, kids) in enumerate(addrs_at):
                left = starts[j - 1] if j else _UNDEF
                right = starts[j + 1] if j + 1 < len(starts) else _UNDEF
                at = self.put(b"TREE" + bytes([0, level]) + _u(len(kids), 2)
                              + _u(left, 8) + _u(right, 8) + body)
                assert at == starts[j]
                parents.append((at, kids[-1][1] if kids else 0))
            if len(parents) == 1:
                root = parents[0][0]
                break
            nodes, level = parents, level + 1
        messages = [(0x11, _u(root, 8) + _u(heap_at, 8))]
        messages += [(0x0C, self.attribute(k, v))
                     for k, v in g.attrs.items()]
        return self.header(messages)


def write(path: str, root: Group) -> int:
    """Write the tree under ``root`` to ``path``; returns the file's
    size in bytes."""
    f = _File()
    root_at = f.group(root)
    sb = (b"\x89HDF\r\n\x1a\n" + bytes([0, 0, 0, 0, 0, 8, 8, 0])
          + _u(_LEAF_K, 2) + _u(_INTERNAL_K, 2) + _u(0, 4)
          + _u(0, 8) + _u(_UNDEF, 8) + _u(len(f.out), 8) + _u(_UNDEF, 8)
          + _u(0, 8) + _u(root_at, 8) + _u(0, 4) + bytes(4) + bytes(16))
    f.out[:96] = sb
    with open(path, "wb") as fh:
        fh.write(f.out)
    return len(f.out)


def save_attributes(group: Group, name: str, data: List[bytes]):
    """Keras's ``save_attributes_to_hdf5_group``: the list as one
    attribute (variable-length strings), or split into ``name0``,
    ``name1``, ... (fixed-length arrays) where it passes 64512 bytes."""
    data_npy = np.asarray(data)
    chunks, n = [data_npy], 1
    while any(c.nbytes > HDF5_OBJECT_HEADER_LIMIT for c in chunks):
        n += 1
        chunks = np.array_split(data_npy, n)
    if n > 1:
        for i, c in enumerate(chunks):
            group.attrs[f"{name}{i}"] = c
    else:
        group.attrs[name] = list(data) if data else np.asarray(data)


def save_model(path: str, config: dict,
               weights: Dict[str, List[Tuple[str, np.ndarray]]]) -> int:
    """Write a model the way Keras's legacy H5 save does: ``weights`` maps
    each layer name (in ``config``'s order) to its (variable path,
    array) list."""
    root = Group()
    root.attrs["keras_version"] = KERAS_VERSION
    root.attrs["backend"] = "tensorflow"
    root.attrs["model_config"] = json.dumps(config).encode("utf8")
    mw = root.create_group("model_weights")
    save_attributes(mw, "layer_names", [n.encode("utf8") for n in weights])
    mw.attrs["backend"] = b"tensorflow"
    mw.attrs["keras_version"] = KERAS_VERSION.encode("utf8")
    for lname in sorted(weights):
        g = mw.create_group(lname)
        save_attributes(g, "weight_names",
                        [p.encode("utf8") for p, _ in weights[lname]])
        for p, arr in weights[lname]:
            g.create_dataset(p, arr)
    save_attributes(mw.create_group("top_level_model_weights"),
                    "weight_names", [])
    return write(path, root)


# --------------------------------------------------------- layer configs
_DTYPE = {"module": "keras", "class_name": "DTypePolicy",
          "config": {"name": "float32"}, "registered_name": None}


def _init(name, **config):
    return {"module": "keras.initializers", "class_name": name,
            "config": config, "registered_name": None}


def _node(*sources, shape=None):
    """Keras 3's inbound node over ``sources`` (one tensor, or a list for
    a merge)."""
    tensors = [{"class_name": "__keras_tensor__",
                "config": {"shape": shape, "dtype": "float32",
                           "keras_history": [s, 0, 0]}} for s in sources]
    args = [tensors] if len(tensors) > 1 else tensors
    return [{"args": args, "kwargs": {}}]


def _layer(cls, name, sources, **config):
    return {"class_name": cls,
            "config": {"name": name, "trainable": True, "dtype": _DTYPE,
                       **config},
            "name": name, "inbound_nodes": _node(*sources) if sources
            else []}


def _conv(name, src, filters, kernel, strides=1, padding="valid"):
    return _layer("Conv2D", name, [src], filters=filters,
                  kernel_size=[kernel, kernel], strides=[strides, strides],
                  padding=padding, data_format="channels_last",
                  dilation_rate=[1, 1], groups=1, activation="linear",
                  use_bias=True, kernel_initializer=_init("GlorotUniform",
                                                          seed=None),
                  bias_initializer=_init("Zeros"), kernel_regularizer=None,
                  bias_regularizer=None, activity_regularizer=None,
                  kernel_constraint=None, bias_constraint=None)


def _bn(name, src):
    return _layer("BatchNormalization", name, [src], axis=3, momentum=0.99,
                  epsilon=1.001e-5, center=True, scale=True,
                  beta_initializer=_init("Zeros"),
                  gamma_initializer=_init("Ones"),
                  moving_mean_initializer=_init("Zeros"),
                  moving_variance_initializer=_init("Ones"),
                  beta_regularizer=None, gamma_regularizer=None,
                  beta_constraint=None, gamma_constraint=None,
                  synchronized=False)


def _relu(name, src):
    return _layer("Activation", name, [src], activation="relu")


def _block(layers, x, filters, name, stride=1, shortcut=True):
    """``keras.applications.resnet.block1``, in the order Keras saves its
    layers; returns the block's output name."""
    n = name
    layers += [_conv(f"{n}_1_conv", x, filters, 1, stride),
               _bn(f"{n}_1_bn", f"{n}_1_conv"),
               _relu(f"{n}_1_relu", f"{n}_1_bn"),
               _conv(f"{n}_2_conv", f"{n}_1_relu", filters, 3,
                     padding="same"),
               _bn(f"{n}_2_bn", f"{n}_2_conv"),
               _relu(f"{n}_2_relu", f"{n}_2_bn")]
    if shortcut:
        layers += [_conv(f"{n}_0_conv", x, 4 * filters, 1, stride),
                   _conv(f"{n}_3_conv", f"{n}_2_relu", 4 * filters, 1),
                   _bn(f"{n}_0_bn", f"{n}_0_conv"),
                   _bn(f"{n}_3_bn", f"{n}_3_conv")]
        skip = f"{n}_0_bn"
    else:
        layers += [_conv(f"{n}_3_conv", f"{n}_2_relu", 4 * filters, 1),
                   _bn(f"{n}_3_bn", f"{n}_3_conv")]
        skip = x
    layers += [_layer("Add", f"{n}_add", [skip, f"{n}_3_bn"]),
               _relu(f"{n}_out", f"{n}_add")]
    return f"{n}_out"


RESNET50_STAGES = (("conv2", 64, 3, 1), ("conv3", 128, 4, 2),
                   ("conv4", 256, 6, 2), ("conv5", 512, 3, 2))


def resnet50_config(input_shape=(224, 224, 3), classes: int = 1000) -> dict:
    """``keras.applications.ResNet50(weights=None, input_shape=...,
    classes=...)``'s model config, as Keras 3's legacy H5 save writes
    it."""
    layers = [{"class_name": "InputLayer",
               "config": {"batch_shape": [None, *input_shape],
                          "dtype": "float32", "sparse": False,
                          "ragged": False, "name": "input_layer",
                          "optional": False},
               "name": "input_layer", "inbound_nodes": []},
              _layer("ZeroPadding2D", "conv1_pad", ["input_layer"],
                     padding=[[3, 3], [3, 3]], data_format="channels_last"),
              _conv("conv1_conv", "conv1_pad", 64, 7, 2),
              _bn("conv1_bn", "conv1_conv"), _relu("conv1_relu", "conv1_bn"),
              _layer("ZeroPadding2D", "pool1_pad", ["conv1_relu"],
                     padding=[[1, 1], [1, 1]], data_format="channels_last"),
              _layer("MaxPooling2D", "pool1_pool", ["pool1_pad"],
                     pool_size=[3, 3], padding="valid", strides=[2, 2],
                     data_format="channels_last")]
    x = "pool1_pool"
    for stage, filters, blocks, stride in RESNET50_STAGES:
        x = _block(layers, x, filters, f"{stage}_block1", stride)
        for i in range(2, blocks + 1):
            x = _block(layers, x, filters, f"{stage}_block{i}",
                       shortcut=False)
    layers += [_layer("GlobalAveragePooling2D", "avg_pool", [x],
                      data_format="channels_last", keepdims=False),
               _layer("Dense", "predictions", ["avg_pool"], units=classes,
                      activation="softmax", use_bias=True,
                      kernel_initializer=_init("GlorotUniform", seed=None),
                      bias_initializer=_init("Zeros"),
                      kernel_regularizer=None, bias_regularizer=None,
                      kernel_constraint=None, bias_constraint=None,
                      quantization_config=None)]
    return {"class_name": "Functional",
            "config": {"name": "resnet50", "trainable": True,
                       "layers": layers,
                       "input_layers": ["input_layer", 0, 0],
                       "output_layers": ["predictions", 0, 0]}}


def resnet50_weights(config: dict, seed: int = 0
                     ) -> Dict[str, List[Tuple[str, np.ndarray]]]:
    """Weights for :func:`resnet50_config`, drawn from ``seed``: He-normal
    kernels, small biases, BN scales near 1 (near 0.2 on each residual
    branch's last BN, so the residual stream stays tame at init), shifts
    and moving means near 0, moving variances in [0.8, 1.2], a
    Glorot-uniform classifier."""
    rng = np.random.default_rng(seed)
    channels = {"input_layer": config["config"]["layers"][0]["config"][
        "batch_shape"][-1]}
    out: Dict[str, List[Tuple[str, np.ndarray]]] = {}
    for ld in config["config"]["layers"]:
        name, cfg, cls = ld["name"], ld["config"], ld["class_name"]
        src = (ld["inbound_nodes"][0]["args"][0]
               if ld["inbound_nodes"] else None)
        src = src[0] if isinstance(src, list) else src
        cin = channels.get(src["config"]["keras_history"][0]) if src else None
        weights: List[Tuple[str, np.ndarray]] = []
        if cls == "Conv2D":
            k = cfg["kernel_size"][0]
            f = cfg["filters"]
            std = np.sqrt(2.0 / (k * k * cin))
            weights = [(f"{name}/kernel", (rng.standard_normal(
                (k, k, cin, f)) * std).astype(np.float32)),
                       (f"{name}/bias", (0.01 * rng.standard_normal(f))
                        .astype(np.float32))]
            channels[name] = f
        elif cls == "BatchNormalization":
            scale = 0.2 if name.endswith("_3_bn") else 1.0
            weights = [(f"{name}/gamma", (scale * rng.uniform(
                0.8, 1.2, cin)).astype(np.float32)),
                       (f"{name}/beta", (0.05 * rng.standard_normal(cin))
                        .astype(np.float32)),
                       (f"{name}/moving_mean", (0.05 * rng.standard_normal(
                           cin)).astype(np.float32)),
                       (f"{name}/moving_variance", rng.uniform(
                           0.8, 1.2, cin).astype(np.float32))]
            channels[name] = cin
        elif cls == "Dense":
            units = cfg["units"]
            lim = np.sqrt(6.0 / (cin + units))
            weights = [(f"{name}/kernel", rng.uniform(
                -lim, lim, (cin, units)).astype(np.float32)),
                       (f"{name}/bias", np.zeros(units, np.float32))]
        elif cls != "InputLayer":
            channels[name] = cin
        out[name] = weights
    return out


def write_resnet50(path: str, input_shape=(224, 224, 3), classes: int = 1000,
                   seed: int = 0) -> dict:
    """Author the ResNet-50 at ``path``; returns its config."""
    config = resnet50_config(input_shape, classes)
    save_model(path, config, resnet50_weights(config, seed))
    return config


def char_lstm_config(steps: int = 50, chars: int = 47,
                     units: int = 256) -> dict:
    """The char-LSTM ``Sequential``'s model config, as Keras 3's legacy H5
    save writes it."""
    def lstm(name):
        return {"class_name": "LSTM", "config": {
            "name": name, "trainable": True, "dtype": _DTYPE,
            "return_sequences": True, "return_state": False,
            "go_backwards": False, "stateful": False, "unroll": False,
            "zero_output_for_mask": False, "units": units,
            "activation": "tanh", "recurrent_activation": "sigmoid",
            "use_bias": True,
            "kernel_initializer": _init("GlorotUniform", seed=None),
            "recurrent_initializer": _init("Orthogonal", seed=None,
                                           gain=1.0),
            "bias_initializer": _init("Zeros"), "unit_forget_bias": True,
            "kernel_regularizer": None, "recurrent_regularizer": None,
            "bias_regularizer": None, "activity_regularizer": None,
            "kernel_constraint": None, "recurrent_constraint": None,
            "bias_constraint": None, "dropout": 0.0,
            "recurrent_dropout": 0.0, "seed": None}}

    dense = {"module": "keras.layers", "class_name": "Dense", "config": {
        "name": "dense", "trainable": True, "dtype": _DTYPE, "units": chars,
        "activation": "softmax", "use_bias": True,
        "kernel_initializer": _init("GlorotUniform", seed=None),
        "bias_initializer": _init("Zeros"), "kernel_regularizer": None,
        "bias_regularizer": None, "kernel_constraint": None,
        "bias_constraint": None, "quantization_config": None},
        "registered_name": None, "build_config": {"input_shape": [None,
                                                                  units]}}
    layers = [{"class_name": "InputLayer",
               "config": {"batch_shape": [None, steps, chars],
                          "dtype": "float32", "sparse": False,
                          "ragged": False, "name": "input_layer",
                          "optional": False}},
              lstm("lstm"), lstm("lstm_1"),
              {"class_name": "TimeDistributed",
               "config": {"name": "time_distributed", "trainable": True,
                          "dtype": _DTYPE, "layer": dense}}]
    return {"class_name": "Sequential",
            "config": {"name": "sequential", "trainable": True,
                       "dtype": _DTYPE, "layers": layers,
                       "build_input_shape": [None, steps, chars]}}


def char_lstm_weights(seed: int = 0, chars: int = 47, units: int = 256
                      ) -> Dict[str, List[Tuple[str, np.ndarray]]]:
    """Keras's initializers drawn from ``seed``: Glorot-uniform kernels,
    orthogonal recurrent kernels, zero biases with the forget gate's at 1
    (``unit_forget_bias``)."""
    rng = np.random.default_rng(seed)

    def glorot(shape):
        lim = np.sqrt(6.0 / sum(shape))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    def orthogonal(n, m):
        q, r = np.linalg.qr(rng.standard_normal((m, n)))
        return (q * np.sign(np.diag(r))).T.astype(np.float32)

    def lstm(name, n_in):
        bias = np.zeros(4 * units, np.float32)
        bias[units:2 * units] = 1.0
        cell = f"sequential/{name}/lstm_cell"
        return [(f"{cell}/kernel", glorot((n_in, 4 * units))),
                (f"{cell}/recurrent_kernel", orthogonal(units, 4 * units)),
                (f"{cell}/bias", bias)]

    return {"lstm": lstm("lstm", chars), "lstm_1": lstm("lstm_1", units),
            "time_distributed": [
                ("sequential/time_distributed/dense/kernel",
                 glorot((units, chars))),
                ("sequential/time_distributed/dense/bias",
                 np.zeros(chars, np.float32))]}


def write_char_lstm(path: str, seed: int = 0, steps: int = 50,
                    chars: int = 47, units: int = 256) -> dict:
    """Author the char-LSTM at ``path``; returns its config."""
    config = char_lstm_config(steps, chars, units)
    save_model(path, config, char_lstm_weights(seed, chars, units))
    return config


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="author a Keras ResNet-50 H5")
    p.add_argument("path")
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    write_resnet50(a.path, (a.size, a.size, 3), a.classes, a.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
