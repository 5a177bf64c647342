"""The port's op profiler (``profiler/op_profiler.py``) against the JAX
package's, on the CPU: twins of ``tests/test_observability.py``'s two
profiler tests, and the profiler over a SameDiff graph's eager walk.

Counts and op names are held equal; times are only positive (they are
host clocks of two different programs).
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.observability import (metrics,
                                                    reset_global_registry)
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.profiler import OpProfiler, ProfilerConfig


@pytest.fixture
def prof():
    raw = registry.exec_op
    reset_global_registry()
    p = OpProfiler.get_instance()
    p.reset()
    yield p
    p.set_config(ProfilerConfig())
    assert registry.exec_op is raw
    reset_global_registry()


def _reference_counts(calls):
    """The JAX package's profiler over the same exec_op calls."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.ops import registry as jreg
    from deeplearning4j_tpu.profiler import OpProfiler as JP
    from deeplearning4j_tpu.profiler import ProfilerConfig as JC

    p = JP.get_instance()
    p.reset()
    p.set_config(JC(op_timing=True))
    try:
        for name, arg in calls:
            jreg.exec_op(name, jnp.asarray(arg))
    finally:
        p.set_config(JC())
    return {name: p.stats[name].invocations for name, _a in calls}


def test_timing_and_panic_match_reference(prof):
    calls = [("relu", [-1.0, 2.0]), ("relu", [3.0]), ("exp", [0.5])]
    prof.set_config(ProfilerConfig(op_timing=True))
    for name, arg in calls:
        registry.exec_op(name, torch.tensor(arg))
    got = {name: prof.stats[name].invocations for name, _a in calls}
    assert got == _reference_counts(calls) == {"relu": 2, "exp": 1}
    assert prof.stats["relu"].total_seconds > 0
    assert prof.stats["relu"].average_ms > 0
    assert "relu" in prof.print_results()
    prof.set_config(ProfilerConfig(check_for_inf=True))
    with pytest.raises(FloatingPointError, match="INF_PANIC"):
        registry.exec_op("log", torch.tensor([0.0]))
    prof.set_config(ProfilerConfig(check_for_nan=True))
    with pytest.raises(FloatingPointError, match="NAN_PANIC"):
        registry.exec_op("sqrt", torch.tensor([-1.0]))
    registry.exec_op("argmax", torch.tensor([1.0, 3.0]))   # ints pass


def test_publishes_into_the_registry_and_rebases(prof):
    prof.set_config(ProfilerConfig(op_timing=True))
    registry.exec_op("relu", torch.tensor([-1.0, 2.0]))
    registry.exec_op("relu", torch.tensor([1.0]))
    prof.set_config(ProfilerConfig())
    hist = metrics().get("dl4j_eager_op_seconds")
    assert hist.labels(op="relu").count == 2
    assert prof.stats["relu"].invocations == 2
    prof.reset()
    assert prof.stats["relu"].invocations == 0
    assert hist.labels(op="relu").count == 2


def test_profiles_every_op_of_a_samediff_walk(prof):
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    sd = SameDiff.create("cpu")
    x = sd.placeholder("x", (2, 3))
    w = sd.var("w", init=np.ones((3, 4), np.float32))
    sd.nn.softmax(sd.nn.relu(x.mmul(w))).rename("out")
    prof.set_config(ProfilerConfig(op_timing=True))
    sd.output({"x": np.ones((2, 3), np.float32)}, "out")
    assert {n: prof.stats[n].invocations for n in ("matmul", "relu",
                                                   "softmax")} == {
        "matmul": 1, "relu": 1, "softmax": 1}
    prof.set_config(ProfilerConfig(check_for_nan=True))
    sd2 = SameDiff.create("cpu")
    y = sd2.placeholder("y", (2,))
    sd2.math.sqrt(y).rename("r")
    with pytest.raises(FloatingPointError, match="NAN_PANIC: op 'sqrt'"):
        sd2.output({"y": np.array([-1.0, 4.0], np.float32)}, "r")
