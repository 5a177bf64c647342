"""GraphDef skeletons: a frozen TF graph with its large weights stripped,
filled from a seed where it runs.

A frozen BERT-base GraphDef is 438 MB, nearly all of it the weights of
~200 constants; the machine with the card has no TF and no network. A
skeleton keeps the graph whole but empties every float constant over
``MIN_ELEMENTS`` elements and marks it with its initializer (an attr
``SKELETON_ATTR`` on the Const node: "normal MEAN STD", "ones" or
"zeros"); the constant's dtype and shape stay in its TensorProto. The
skeletons the repo carries are written by ``tools/bert_skeleton.py``
(which needs TF and transformers) with ``tf_proto``'s writer, gzipped.

:func:`fill_skeleton` draws every marked constant from a seed and clears
the mark. The importer refuses a marked Const, so an unfilled weight can
never import as zeros (an empty TensorProto reads as zeros).
"""
from __future__ import annotations

import os

import numpy as np

SKELETON_ATTR = "_dl4j_skeleton_init"
MIN_ELEMENTS = 512

#: the skeletons shipped with the package
SKELETON_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "skeletons")


def skeleton_path(name: str) -> str:
    """The path of a shipped skeleton, e.g. ``"bert_base_b32_t128"``."""
    return os.path.join(SKELETON_DIR, f"{name}.pb.gz")


def load_skeleton(name_or_path: str):
    """A shipped skeleton by name, or any skeleton file, as a GraphDef."""
    from deeplearning4j_tpu_torch.modelimport import tf_proto

    path = name_or_path if os.path.exists(name_or_path) \
        else skeleton_path(name_or_path)
    return tf_proto.read_graph_def(path)


def marked_constants(graph_def):
    """The skeleton's stripped constants: [(node, initializer string)]."""
    return [(n, n.attr[SKELETON_ATTR].s.decode())
            for n in graph_def.node
            if n.op == "Const" and SKELETON_ATTR in n.attr]


def _shape(node):
    return tuple(int(d.size) for d in node.attr["value"].tensor.tensor_shape.dim)


def strip(graph_def, initializer_of, min_elements: int = MIN_ELEMENTS) -> int:
    """Strip, in place, every float32 Const over ``min_elements`` elements,
    marking it with ``initializer_of(node) -> str``. Returns the count."""
    n = 0
    for node in graph_def.node:
        if node.op != "Const":
            continue
        tensor = node.attr["value"].tensor
        if int(tensor.dtype) != 1 or int(np.prod(_shape(node))) <= \
                min_elements:
            continue
        init = initializer_of(node)
        _parse_init(init)
        tensor.tensor_content = b""
        tensor.float_val = []
        mark = type(node.attr["value"])()
        mark.s = init.encode()
        node.attr[SKELETON_ATTR] = mark
        n += 1
    return n


def _parse_init(init: str):
    parts = init.split()
    if parts[0] == "normal" and len(parts) == 3:
        return "normal", float(parts[1]), float(parts[2])
    if parts == ["ones"] or parts == ["zeros"]:
        return parts[0], None, None
    raise ValueError(f"unknown skeleton initializer {init!r}")


def fill_skeleton(graph_def, seed: int):
    """Fill, in place, every marked constant from numpy's
    ``default_rng(seed)`` and clear its mark; returns ``graph_def``.
    Raises if a marked constant is left without its values."""
    consts = marked_constants(graph_def)
    rng = np.random.default_rng(seed)
    for node, init in consts:
        kind, mean, std = _parse_init(init)
        count = int(np.prod(_shape(node)))
        if kind == "ones":
            arr = np.ones(count, np.float32)
        elif kind == "zeros":
            arr = np.zeros(count, np.float32)
        else:
            arr = (rng.standard_normal(count, dtype=np.float32) * std
                   + mean).astype(np.float32)
        node.attr["value"].tensor.tensor_content = arr.tobytes()
        del node.attr[SKELETON_ATTR]
    left = [n.name for n, _init in consts
            if len(n.attr["value"].tensor.tensor_content)
            != 4 * int(np.prod(_shape(n)))]
    left += [n.name for n, _init in marked_constants(graph_def)]
    if left:
        raise ValueError(f"skeleton constants left unfilled: {left[:5]}")
    return graph_def
