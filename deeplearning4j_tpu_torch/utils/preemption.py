"""Preemption-safe training: checkpoint-on-signal + resume.

Counterpart of ``deeplearning4j_tpu/utils/preemption.py``. Preemptible
machines deliver SIGTERM with a grace window (maintenance events, spot
reclaims); this module handles that path first-class:

- ``PreemptionHandler``   — process-wide signal latch (SIGTERM by default);
  safe to install in the main thread, queryable from anywhere.
- ``PreemptionSafeListener`` — listener that, at the first step boundary
  after the signal, writes a final checkpoint (model + updater state +
  iteration/epoch counters) and raises ``TrainingPreempted`` so the training
  loop unwinds cleanly while the params are whole.
- ``resume_or_new``       — restart entry point: restores the newest
  checkpoint if one exists, else builds a fresh net.

Checkpointing at a step boundary (not inside the signal handler) matters:
mid-step the optimizer's foreach updates may be half applied, and a dump
there would serialize a state no step ever produced. The signal only sets
a flag; persistence happens on the host thread between steps — the same
reason the reference's CheckpointListener hooks iterationDone. Restores
land on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import os
import signal
import threading
from typing import Optional

from deeplearning4j_tpu_torch.optim.listeners import TrainingListener


class TrainingPreempted(Exception):
    """Raised at the step boundary after a preemption signal; carries the
    checkpoint path written before unwinding. ``checkpoint_ready`` is False
    on ranks that did not write the file themselves (rank 0 writes; the
    write may still be in flight when other ranks unwind) — the
    reference's multi-host surface, kept for its callers."""

    def __init__(self, checkpoint_path: str, iteration: int,
                 checkpoint_ready: bool = True):
        state = ("state saved to" if checkpoint_ready
                 else "state being saved by rank 0 to")
        super().__init__(f"training preempted at iteration {iteration}; "
                         f"{state} {checkpoint_path}")
        self.checkpoint_path = checkpoint_path
        self.iteration = iteration
        self.checkpoint_ready = checkpoint_ready


class PreemptionHandler:
    """Latches preemption signals (default SIGTERM). Install once per
    process; ``preempted`` is readable from any thread."""

    _installed: Optional["PreemptionHandler"] = None

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}

    def install(self) -> "PreemptionHandler":
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        PreemptionHandler._installed = self
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}
        if PreemptionHandler._installed is self:
            PreemptionHandler._installed = None

    def _on_signal(self, signum, frame):
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def request_preemption(self):
        """Programmatic trigger (tests; cooperative shutdown)."""
        self._event.set()

    def clear(self):
        self._event.clear()


class PreemptionSafeListener(TrainingListener):
    """Write a final checkpoint and stop cleanly when preempted.

    Usage::

        handler = PreemptionHandler().install()
        net.addListeners(PreemptionSafeListener(handler, "/ckpt/dir"))
        try:
            net.fit(iterator, epochs=100)
        except TrainingPreempted as p:
            ...  # exit; next start resumes via resume_or_new
    """

    FINAL_NAME = "preempt_final_{model}.zip"

    def __init__(self, handler: PreemptionHandler, directory: str,
                 raise_on_preempt: bool = True):
        self.handler = handler
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.raise_on_preempt = raise_on_preempt
        self.checkpoint_path: Optional[str] = None

    def iteration_done(self, model, iteration, epoch, score):
        if not self.handler.preempted:
            return
        from deeplearning4j_tpu_torch.resilience import faults as _faults
        from deeplearning4j_tpu_torch.utils.serialization import (
            save_model_atomic)
        path = os.path.join(self.directory,
                            self.FINAL_NAME.format(model=type(model).__name__))
        _faults.check("checkpoint.save")
        # atomic: a crash mid-save (the grace window running out) must
        # never leave a torn preempt_final_*.zip that the next start
        # would trust
        save_model_atomic(model, path)
        self.checkpoint_path = path
        if self.raise_on_preempt:
            raise TrainingPreempted(path, iteration)


def _final_checkpoints(directory: str):
    """``preempt_final_*`` checkpoints, NEWEST first — the shared
    ``checkpoint_candidates`` ranking (mtime, skip ``.tmp``/torn files),
    so this resume path and ResilientTrainer's can never disagree about
    the same directory. A directory holding checkpoints for several model
    kinds resumes from the latest run, not the alphabetically-first file."""
    from deeplearning4j_tpu_torch.utils.serialization import (
        checkpoint_candidates)
    return checkpoint_candidates(directory, prefix="preempt_final_")


def find_final_checkpoint(directory: str) -> Optional[str]:
    paths = _final_checkpoints(directory)
    return paths[0] if paths else None


def resume_or_new(directory: str, conf_factory, device=None):
    """Restart entry point: restore the newest preemption checkpoint
    (with updater state, so Adam moments and the iteration counter
    survive) onto ``device`` (``None`` = the card), else build fresh from
    ``conf_factory()`` there. Unreadable/torn checkpoints are skipped
    with a warning — a corrupt file must degrade to the next-newest (or a
    fresh start), never crash the restart. Returns (net, resumed)."""
    import logging

    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    log = logging.getLogger("deeplearning4j_tpu_torch")
    for path in _final_checkpoints(directory):
        try:
            return MultiLayerNetwork.load(path, load_updater=True,
                                          device=device), True
        except Exception as e:
            log.warning("skipping unreadable checkpoint %s: %r", path, e)
    net = MultiLayerNetwork(conf_factory(), device=device)
    net.init()
    return net, False
