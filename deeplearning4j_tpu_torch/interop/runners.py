"""Live-session runners: counterpart of
``deeplearning4j_tpu/interop/runners.py`` (ref:
``org.nd4j.tensorflow.conversion.graphrunner.GraphRunner`` and
``nd4j-onnxruntime``'s session wrapper).

They keep the reference's gates: each raises ``ImportError`` with the
reference's message where ``tensorflow`` or ``onnxruntime`` is not
installed (neither is on the card's machine). Inputs cross as numpy;
outputs are the port's NDArrays, on the default device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray


def _host(v):
    return v.toNumpy() if isinstance(v, NDArray) else (
        v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))


class GraphRunner:
    """Executes a frozen TensorFlow GraphDef with the live TF runtime.

    ref API: ``GraphRunner(graphBytes, inputNames, outputNames)`` + ``#run``.
    """

    def __init__(self, graph_def=None, path: Optional[str] = None,
                 input_names: Sequence[str] = (),
                 output_names: Sequence[str] = ()):
        try:
            import tensorflow as tf
        except ImportError as e:   # pragma: no cover - env-dependent
            raise ImportError("tensorflow is required for GraphRunner "
                              "(nd4j-tensorflow interop analog)") from e
        self._tf = tf
        if path is not None:
            gd = tf.compat.v1.GraphDef()
            with open(path, "rb") as f:
                gd.ParseFromString(f.read())
        elif isinstance(graph_def, (bytes, bytearray)):
            gd = tf.compat.v1.GraphDef()
            gd.ParseFromString(bytes(graph_def))
        else:
            gd = graph_def
        self.graph_def = gd
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        if not self.output_names:
            # default: terminal nodes (no node consumes them)
            consumed = {i.split(":")[0].lstrip("^")
                        for n in gd.node for i in n.input}
            self.output_names = [n.name for n in gd.node
                                 if n.name not in consumed]
        self._graph = tf.Graph()
        with self._graph.as_default():
            tf.graph_util.import_graph_def(gd, name="")
        self._session = tf.compat.v1.Session(graph=self._graph)

    def run(self, inputs: Dict[str, object]) -> Dict[str, NDArray]:
        """{input_name: array} → {output_name: NDArray} (ref: #run)."""
        feed = {f"{k.split(':')[0]}:0": _host(v) for k, v in inputs.items()}
        fetches = [f"{n.split(':')[0]}:0" for n in self.output_names]
        outs = self._session.run(fetches, feed_dict=feed)
        return {name: NDArray(np.asarray(o))
                for name, o in zip(self.output_names, outs)}

    def close(self):
        self._session.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class OnnxRuntimeRunner:
    """Executes an ONNX model with onnxruntime (ref: nd4j-onnxruntime).
    Gated: raises ImportError with a clear message when onnxruntime is not
    installed."""

    def __init__(self, path: str, providers: Optional[List[str]] = None):
        try:
            import onnxruntime as ort
        except ImportError as e:   # pragma: no cover - env-dependent
            raise ImportError("onnxruntime is required for OnnxRuntimeRunner "
                              "(nd4j-onnxruntime interop analog); it is not "
                              "bundled in this environment") from e
        self._sess = ort.InferenceSession(path, providers=providers)
        self.input_names = [i.name for i in self._sess.get_inputs()]
        self.output_names = [o.name for o in self._sess.get_outputs()]

    def run(self, inputs: Dict[str, object]) -> Dict[str, NDArray]:
        feed = {k: _host(v) for k, v in inputs.items()}
        outs = self._sess.run(self.output_names, feed)
        return {n: NDArray(np.asarray(o))
                for n, o in zip(self.output_names, outs)}
