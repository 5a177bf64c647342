"""Op and device profiling and throughput tracking of the port.

Counterpart of ``deeplearning4j_tpu/profiler/``: :class:`OpProfiler` /
:class:`ProfilerConfig` (``op_profiler.py``: per-op timing and NaN/Inf
panic on the op registry's ``exec_op``), :class:`DeviceProfiler`
(``xprof.py``, over ``torch.profiler``) and :class:`PerformanceTracker`
(``performance.py``).
"""
from deeplearning4j_tpu_torch.profiler.op_profiler import (OpProfiler,
                                                           ProfilerConfig)
from deeplearning4j_tpu_torch.profiler.performance import PerformanceTracker
from deeplearning4j_tpu_torch.profiler.xprof import (DeviceProfiler,
                                                     profile_step)

__all__ = ["OpProfiler", "ProfilerConfig", "PerformanceTracker",
           "DeviceProfiler", "profile_step"]
