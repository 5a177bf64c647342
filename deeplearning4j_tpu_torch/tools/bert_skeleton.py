"""Write a GraphDef skeleton of a HuggingFace TF BERT (``tf_skeleton.py``).

Needs tensorflow and transformers, which the port never imports: both are
imported inside :func:`main`. It freezes ``TFBertModel`` (dropout 0;
inputs ``input_ids`` and ``attention_mask``, int32, at the given batch and
sequence length; output ``last_hidden_state``) as the JAX package's BERT
tests do, parses the GraphDef with the port's ``tf_proto``, strips every
float constant over 512 elements, marking each with the initializer of
the variable it froze (HF's: normal(0, initializer_range) for kernels and
embeddings, ones for LayerNorm gamma, zeros for biases and beta), and
writes the skeleton with ``tf_proto``'s writer, gzipped.

Run from the repo root::

    python -m deeplearning4j_tpu_torch.tools.bert_skeleton --preset base \\
        --batch 32 --seq 128

which writes ``deeplearning4j_tpu_torch/modelimport/skeletons/
bert_base_b32_t128.pb.gz``. ``--preset mini`` is the tests' 2-layer,
width-32 BERT (vocab 100, 2 heads, intermediate 64, 64 positions).
"""
from __future__ import annotations

import argparse
import gzip
import os
import sys

import numpy as np

PRESETS = {
    "base": {},
    "mini": dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=64),
}


def initializer_for(var_name: str, initializer_range: float) -> str:
    """HF BERT's initializer of a variable, by its name."""
    leaf = var_name.split(":")[0]
    if leaf.endswith("LayerNorm/gamma"):
        return "ones"
    if leaf.endswith("LayerNorm/beta") or leaf.endswith("/bias"):
        return "zeros"
    return f"normal 0.0 {initializer_range!r}"


def freeze(preset: str, batch: int, seq: int):
    """(serialized frozen GraphDef, {value bytes: variable name}, config)."""
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    from transformers import BertConfig, TFBertModel

    cfg = BertConfig(hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, **PRESETS[preset])
    model = TFBertModel(cfg)

    @tf.function
    def f(input_ids, attention_mask):
        return model(input_ids=input_ids,
                     attention_mask=attention_mask).last_hidden_state

    frozen = convert_variables_to_constants_v2(f.get_concrete_function(
        tf.TensorSpec((batch, seq), tf.int32, name="input_ids"),
        tf.TensorSpec((batch, seq), tf.int32, name="attention_mask")))
    by_value = {}
    for v in model.variables:
        arr = np.ascontiguousarray(v.numpy())
        by_value[(arr.shape, arr.tobytes())] = v.name
    return frozen.graph.as_graph_def().SerializeToString(), by_value, cfg


def skeleton_bytes(preset: str, batch: int, seq: int) -> bytes:
    from deeplearning4j_tpu_torch.modelimport import tf_proto, tf_skeleton

    data, by_value, cfg = freeze(preset, batch, seq)
    gd = tf_proto.parse_graph_def(data)

    def init_of(node):
        t = node.attr["value"].tensor
        shape = tuple(int(d.size) for d in t.tensor_shape.dim)
        name = by_value.get((shape, bytes(t.tensor_content)))
        if name is None:
            raise ValueError(f"constant {node.name!r} {shape} matches no "
                             f"model variable")
        return initializer_for(name, cfg.initializer_range)

    n = tf_skeleton.strip(gd, init_of)
    print(f"{preset} ({batch}, {seq}): {len(gd.node)} nodes, {n} constants "
          f"stripped", file=sys.stderr)
    return gd.SerializeToString()


def main(argv=None):
    from deeplearning4j_tpu_torch.modelimport import tf_skeleton

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="base")
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--out", default=None,
                    help="output path (default: the package's skeletons)")
    args = ap.parse_args(argv)
    out = args.out or tf_skeleton.skeleton_path(
        f"bert_{args.preset}_b{args.batch}_t{args.seq}")
    raw = skeleton_bytes(args.preset, args.batch, args.seq)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "wb") as f, gzip.GzipFile(filename="", fileobj=f,
                                             mode="wb", mtime=0) as gz:
        gz.write(raw)
    print(out)


if __name__ == "__main__":
    main()
