"""Training listener bus: a copy of ``deeplearning4j_tpu/optim/listeners.py``,
analog of
``org.deeplearning4j.optimize.api.TrainingListener`` and impls
(ScoreIterationListener, PerformanceListener, EvaluativeListener,
CheckpointListener, TimeIterationListener — SURVEY §5.5).

Listeners fire at iteration granularity on the host, after each step.
"""
from __future__ import annotations

import logging
import time

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    def iteration_done(self, model, iteration: int, epoch: int, score: float):
        pass

    def on_epoch_start(self, model, epoch: int):
        pass

    def on_epoch_end(self, model, epoch: int):
        pass

    def on_forward_pass(self, model, activations):
        pass

    def on_backward_pass(self, model):
        pass

    def on_gradient_calculation(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (ref: ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %.6f", iteration, score)


class PerformanceListener(TrainingListener):
    """Examples/sec + iterations/sec (ref: PerformanceListener)."""

    def __init__(self, frequency: int = 10, report_batch: bool = True):
        self.frequency = max(1, frequency)
        self.report_batch = report_batch
        self._last_time = None
        self._last_iter = None
        self._examples = 0

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        batch = getattr(model, "_last_batch_size", 0)
        self._examples += batch
        if iteration % self.frequency == 0:
            if self._last_time is not None:
                dt = now - self._last_time
                iters = iteration - self._last_iter
                if dt > 0:
                    log.info("iteration %d: %.1f iters/sec, %.1f examples/sec, score=%.6f",
                             iteration, iters / dt, self._examples / dt, score)
            self._last_time = now
            self._last_iter = iteration
            self._examples = 0


class TimeIterationListener(TrainingListener):
    """ETA logging (ref: TimeIterationListener)."""

    def __init__(self, total_iterations: int):
        self.total = total_iterations
        self.start = time.perf_counter()

    def iteration_done(self, model, iteration, epoch, score):
        elapsed = time.perf_counter() - self.start
        if iteration > 0:
            remaining = elapsed / iteration * (self.total - iteration)
            log.info("iteration %d/%d, ETA %.0fs", iteration, self.total, remaining)


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator (ref: EvaluativeListener)."""

    def __init__(self, iterator, frequency: int = 100):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.last_evaluation = None

    def iteration_done(self, model, iteration, epoch, score):
        if iteration > 0 and iteration % self.frequency == 0:
            self.iterator.reset()
            self.last_evaluation = model.evaluate(self.iterator)
            log.info("Evaluation at iteration %d:\n%s", iteration, self.last_evaluation.stats())


class CollectScoresListener(TrainingListener):
    """Score history in memory (ref: CollectScoresIterationListener)."""

    def __init__(self):
        self.scores = []
        self.iterations = []

    def iteration_done(self, model, iteration, epoch, score):
        self.iterations.append(iteration)
        self.scores.append(float(score))


class MetricsReportingListener(TrainingListener):
    """Bridge the TrainingListener bus into the observability registry.

    The built-in fit loops already publish the step-time decomposition;
    this listener covers everything that drives models through the
    *listener* contract instead — external training loops (arbiter
    hyperparameter search, RL), imported-graph trainers, custom solvers —
    so their iterations/scores land in the same ``/metrics`` series. An
    optional ``prefix`` namespaces a run (e.g. per arbiter candidate).
    """

    def __init__(self, prefix: str = "dl4j_listener"):
        from deeplearning4j_tpu_torch.observability import global_registry
        reg = global_registry()
        self._iters = reg.counter(
            f"{prefix}_iterations_total",
            "iterations observed on the TrainingListener bus",
            label_names=("model",))
        self._score = reg.gauge(
            f"{prefix}_score", "last score seen on the listener bus",
            label_names=("model",))
        self._epochs = reg.counter(
            f"{prefix}_epochs_total",
            "epochs completed on the TrainingListener bus",
            label_names=("model",))
        # per model KIND, matching the label: one listener attached to
        # several models (arbiter candidates, RL actors) must not record
        # cross-model gaps as either model's iteration time
        self._last_t: dict = {}
        self._iter_seconds = reg.histogram(
            f"{prefix}_iteration_seconds",
            "wall time between consecutive iteration_done callbacks",
            label_names=("model",))
        # divergence visibility for EXTERNAL loops: the built-in fit loops
        # detect non-finite loss/grads in the step (observability/numerics),
        # but a custom solver driving the bus only hands us its score —
        # count the non-finite ones so those runs page too
        self._nonfinite = reg.counter(
            f"{prefix}_nonfinite_scores_total",
            "non-finite scores observed on the TrainingListener bus",
            label_names=("model",))

    def iteration_done(self, model, iteration, epoch, score):
        kind = type(model).__name__
        self._iters.labels(model=kind).inc()
        if score == score and abs(score) != float("inf"):
            self._score.labels(model=kind).set(float(score))
        else:
            self._nonfinite.labels(model=kind).inc()
        now = time.perf_counter()
        last = self._last_t.get(kind)
        if last is not None:
            self._iter_seconds.labels(model=kind).observe(now - last)
        self._last_t[kind] = now

    def on_epoch_end(self, model, epoch):
        self._epochs.labels(model=type(model).__name__).inc()


class CheckpointListener(TrainingListener):
    """Periodic rotating checkpoints with a retention policy
    (ref: org.deeplearning4j.optimize.listeners.CheckpointListener, SURVEY 5.4).

    Saves ``checkpoint_<n>_<Model>.zip`` into ``directory`` every N
    iterations / epochs / minutes through ``save_model_atomic``, under the
    ``checkpoint.save`` span and fault point, keeping the last
    ``keep_last`` (plus every ``keep_every``-th) like the reference's
    builder options. Each save's wall time goes to the
    ``dl4j_checkpoint_save_seconds`` histogram.
    """

    def __init__(self, directory, save_every_n_iterations=None,
                 save_every_n_epochs=None, save_every_n_minutes=None,
                 keep_last=3, keep_every=None):
        import os
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.every_iters = save_every_n_iterations
        self.every_epochs = save_every_n_epochs
        self.every_secs = (save_every_n_minutes * 60.0
                           if save_every_n_minutes else None)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self._count = 0
        self._saved = []          # [(count, path)]
        self._last_time = None

    def _save(self, model):
        import os

        from deeplearning4j_tpu_torch.observability import (global_registry,
                                                            span)
        from deeplearning4j_tpu_torch.resilience import faults as _faults
        from deeplearning4j_tpu_torch.utils.serialization import (
            save_model_atomic)
        self._count += 1
        name = f"checkpoint_{self._count}_{type(model).__name__}.zip"
        path = os.path.join(self.directory, name)
        t0 = time.perf_counter()
        with span("checkpoint.save", path=name):
            _faults.check("checkpoint.save")
            save_model_atomic(model, path)
        reg = global_registry()
        reg.histogram("dl4j_checkpoint_save_seconds",
                      "wall time of one checkpoint save").observe(
            time.perf_counter() - t0)
        reg.counter("dl4j_checkpoints_total",
                    "checkpoints written by CheckpointListener").inc()
        try:
            reg.counter("dl4j_checkpoint_bytes_total",
                        "bytes written to checkpoint files").inc(
                os.path.getsize(path))
        except OSError:
            pass
        self._saved.append((self._count, path))
        # retention: keep last N + every keep_every-th
        removable = self._saved[:-self.keep_last] if self.keep_last else []
        for cnt, p in list(removable):
            if self.keep_every and cnt % self.keep_every == 0:
                continue
            if os.path.exists(p):
                os.remove(p)
            self._saved.remove((cnt, p))

    def iteration_done(self, model, iteration, epoch, score):
        if self.every_iters and iteration > 0 and \
                iteration % self.every_iters == 0:
            self._save(model)
        if self.every_secs is not None:
            now = time.time()
            if self._last_time is None:
                self._last_time = now
            elif now - self._last_time >= self.every_secs:
                self._save(model)
                self._last_time = now

    def on_epoch_end(self, model, epoch):
        if self.every_epochs and (epoch + 1) % self.every_epochs == 0:
            self._save(model)

    def last_checkpoint(self):
        return self._saved[-1][1] if self._saved else None

    def available_checkpoints(self):
        return [p for _, p in self._saved]
