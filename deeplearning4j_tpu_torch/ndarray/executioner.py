"""OpExecutioner facade: counterpart of
``deeplearning4j_tpu/ndarray/executioner.py`` (ref:
``org.nd4j.linalg.api.ops.executioner.OpExecutioner`` reached via
``Nd4j.getExecutioner()``).

``exec`` unwraps its NDArrays into the port's op registry
(``ops/registry.exec_op``) and wraps what comes back, so
``Nd4j.getExecutioner().exec("dot_product_attention", q, k, v, mask)``
runs the registry's routed attention: the flash kernels on the card.
Profiling goes through the port's ``profiler/op_profiler.py``;
``commit()`` waits for the card.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray, _unwrap
from deeplearning4j_tpu_torch.ops import registry


class OpExecutioner:
    """Eager op execution + profiling knobs (ref: DefaultOpExecutioner /
    NativeOpExecutioner surface)."""

    def exec(self, op_name: str, *arrays, **attrs):
        """Run a registry op on NDArrays/arrays eagerly; NDArray out."""
        args = [_unwrap(a) for a in arrays]
        out = registry.exec_op(op_name, *args, **attrs)
        if isinstance(out, (tuple, list)):
            return tuple(NDArray(o) for o in out)
        return NDArray(out)

    # camelCase parity
    execAndReturn = exec

    def setProfilingConfig(self, config) -> None:
        """ref: OpExecutioner#setProfilingConfig(ProfilerConfig)."""
        from deeplearning4j_tpu_torch.profiler.op_profiler import OpProfiler
        OpProfiler.get_instance().set_config(config)

    set_profiling_config = setProfilingConfig

    def profilingConfig(self):
        """Returns a COPY: mutate it and pass back via setProfilingConfig
        (mutating the live object would bypass hook install/uninstall)."""
        import dataclasses as _dc

        from deeplearning4j_tpu_torch.profiler.op_profiler import OpProfiler
        return _dc.replace(OpProfiler.get_instance().config)

    def commit(self, *arrays) -> None:
        """ref: OpExecutioner#commit — a barrier until queued work lands:
        the arrays' cards (the current card with no arrays) are
        synchronized; the CPU has nothing queued."""
        devices = {_unwrap(a).device for a in arrays
                   if isinstance(_unwrap(a), torch.Tensor)}
        if not arrays and torch.cuda.is_available() \
                and torch.cuda.is_initialized():
            devices = {torch.device("cuda", torch.cuda.current_device())}
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def enableDebugMode(self, flag: bool = True) -> None:
        """ref: Environment::setDebug — here: eager per-op prints."""
        self.enableVerboseMode(flag)

    def enableVerboseMode(self, flag: bool = True) -> None:
        from deeplearning4j_tpu_torch.profiler.op_profiler import OpProfiler
        prof = OpProfiler.get_instance()
        prof.config.verbose = bool(flag)
        prof.set_config(prof.config)


_EXECUTIONER = OpExecutioner()


def get_executioner() -> OpExecutioner:
    return _EXECUTIONER
