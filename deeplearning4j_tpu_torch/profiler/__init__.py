"""Device profiling and throughput tracking of the port.

Counterpart of ``deeplearning4j_tpu/profiler/``: :class:`DeviceProfiler`
(``xprof.py``, over ``torch.profiler``) and :class:`PerformanceTracker`
(``performance.py``). The eager-op ``OpProfiler`` / ``ProfilerConfig``
instrument the ops registry's ``exec_op``, which comes with the importers
(ROADMAP queue 1 item 9).
"""
from deeplearning4j_tpu_torch.profiler.performance import PerformanceTracker
from deeplearning4j_tpu_torch.profiler.xprof import (DeviceProfiler,
                                                     profile_step)

__all__ = ["PerformanceTracker", "DeviceProfiler", "profile_step"]
