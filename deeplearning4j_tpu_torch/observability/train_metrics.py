"""Shared fit-loop instrumentation for both network runtimes.

One :class:`TrainingMetrics` instance per model kind (MultiLayerNetwork /
ComputationGraph) publishes the step-time decomposition into the global
registry. The decomposition follows the distributed-training
characterization playbook (Awan et al. arXiv:1810.11112): a step is

- ``data_wait``       — host time blocked on the input iterator
- ``device_compute``  — dispatch + XLA execution of the jitted train step,
  bounded by the blocking ``float(loss)`` device sync the fit loop already
  performs (no extra sync is added to measure)
- ``host_callback``   — listener bus dispatch (stats, checkpoints, UI)

plus a straggler check of the whole-step duration against the rolling
median. All instruments are cheap no-ops under ``DL4J_TPU_METRICS=0``.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from deeplearning4j_tpu_torch.observability import device_memory
from deeplearning4j_tpu_torch.observability.registry import (global_registry,
                                                             on_registry_reset)
from deeplearning4j_tpu_torch.observability.straggler import StragglerDetector

_instances: Dict[str, "TrainingMetrics"] = {}
_lock = threading.Lock()


def total_iterations() -> int:
    """THE process-wide fit-iteration clock: completed iterations summed
    over model kinds. The observatory (compile_watch's retrace-storm
    window, numerics' divergence window) ages events against this one
    definition — do not reimplement it per consumer."""
    inst = global_registry().get("dl4j_training_iterations_total")
    if inst is None:
        return 0
    return int(sum(child.value for _, child in inst.series()))


class TrainingMetrics:
    """Label-bound handles for one model kind; get via :func:`for_model`."""

    def __init__(self, model_kind: str):
        reg = global_registry()
        self.model_kind = model_kind
        self.step_seconds = reg.histogram(
            "dl4j_training_step_seconds",
            "wall time of one fit iteration (all phases)",
            label_names=("model",)).labels(model=model_kind)
        phase_h = reg.histogram(
            "dl4j_training_phase_seconds",
            "fit iteration decomposed: data_wait | device_compute | "
            "host_callback",
            label_names=("model", "phase"))
        self.data_wait = phase_h.labels(model=model_kind, phase="data_wait")
        self.device_compute = phase_h.labels(model=model_kind,
                                             phase="device_compute")
        self.host_callback = phase_h.labels(model=model_kind,
                                            phase="host_callback")
        self.iterations = reg.counter(
            "dl4j_training_iterations_total",
            "completed fit iterations",
            label_names=("model",)).labels(model=model_kind)
        # incremented by the resilience layer (ResilientTrainer) when a
        # step raises past its in-place retries — the training analog of
        # dl4j_inference_errors_total
        self.step_failures = reg.counter(
            "dl4j_training_step_failures_total",
            "fit iterations that raised (after any in-place retries)",
            label_names=("model",)).labels(model=model_kind)
        self.examples = reg.counter(
            "dl4j_training_examples_total",
            "training examples consumed",
            label_names=("model",)).labels(model=model_kind)
        self.epochs = reg.counter(
            "dl4j_training_epochs_total",
            "completed training epochs",
            label_names=("model",)).labels(model=model_kind)
        self.score = reg.gauge(
            "dl4j_training_score",
            "last minibatch score (loss)",
            label_names=("model",)).labels(model=model_kind)
        self.straggler = StragglerDetector(phase=f"train_step:{model_kind}")

    def record_step(self, batch_size: int, score: float,
                    compute_seconds: float, callback_seconds: float,
                    data_wait_seconds: Optional[float] = None,
                    pipelined: bool = False):
        total = compute_seconds + callback_seconds
        if data_wait_seconds is not None:
            self.data_wait.observe(data_wait_seconds)
            total += data_wait_seconds
        self.device_compute.observe(compute_seconds)
        self.host_callback.observe(callback_seconds)
        self.step_seconds.observe(total)
        self.iterations.inc()
        if batch_size:
            self.examples.inc(batch_size)
        if score == score:                      # skip NaN
            self.score.set(score)
        if not pipelined:
            # under the async runtime's deferred loss fetch, per-call wall
            # time is dispatch-only for most steps and a whole window of
            # queued device work at sync points — every sync step would
            # read as a straggler against the dispatch-time median, so the
            # detector only sees honestly per-step-synchronous loops
            self.straggler.observe(total)
        # step boundary = the safe moment to read the PJRT allocator
        # (throttled internally; no-op latch on stat-less CPU backends)
        device_memory.sample()


def for_model(model) -> TrainingMetrics:
    """Per-model-kind singleton (instruments are label-bound, so two nets of
    the same kind share series — the process-wide registry contract)."""
    kind = type(model).__name__
    inst = _instances.get(kind)
    if inst is None:
        with _lock:
            inst = _instances.get(kind)
            if inst is None:
                inst = _instances[kind] = TrainingMetrics(kind)
    return inst


@on_registry_reset
def reset():
    """Forget cached handles (tests reset the global registry under us)."""
    with _lock:
        _instances.clear()
