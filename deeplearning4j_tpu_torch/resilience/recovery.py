"""Self-healing training: checkpoint-restore-resume under a restart budget.

Counterpart of ``deeplearning4j_tpu/resilience/recovery.py``.
:class:`ResilientTrainer` wraps a ``MultiLayerNetwork`` /
``ComputationGraph`` ``fit`` and, when a step fails,

1. retries **in place** if the failure is transient (injected ``error``
   faults, :class:`~deeplearning4j_tpu_torch.resilience.policy.TransientError`)
   and the iteration counter proves the update never landed — the
   ``train.step`` fault point fires before the step touches any param;
2. otherwise **restores the newest checkpoint** (written by the
   :class:`~deeplearning4j_tpu_torch.optim.listeners.CheckpointListener`
   the trainer attaches, or the epoch-boundary checkpoint), **fast-
   forwards** the data iterator to the restored iteration, and resumes —
   bounded by ``max_restarts`` per ``fit`` call
   (:class:`~deeplearning4j_tpu_torch.resilience.policy.RestartBudgetExhausted`
   beyond it). A real device error mid-step can leave the eager
   optimizer's foreach updates half applied; only this path recovers
   from that, since it replaces every param, state and updater leaf;
3. batches that fail ``quarantine_after`` times are **quarantined** by
   :class:`SkippingIterator` (``dl4j_data_quarantined_total``) instead of
   aborting the epoch — one poisoned shard must not kill the run.

Every restart/restore/quarantine lands in the resilience event ring (→
flight-recorder ``resilience.json``) and the metrics registry. Under
``DL4J_TPU_RESILIENCE=0`` the trainer delegates straight to the wrapped
``fit``. Restores land on the net's own device.

The reference's elastic posture (async sharded manifests, shrinking and
re-expanding a ``ShardedTrainer``'s mesh on host loss) needs several
GPUs: it comes with ROADMAP queue 1 item 7B, and ``elastic=True`` raises
until then.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience.policy import (
    RestartBudgetExhausted, RetryPolicy, is_transient)
from deeplearning4j_tpu_torch.utils.preemption import TrainingPreempted

log = logging.getLogger("deeplearning4j_tpu_torch")


class SkippingIterator(DataSetIterator):
    """Quarantining wrapper: positions that fail ``quarantine_after``
    times are pulled-and-discarded on later passes instead of re-poisoning
    the epoch. Positions are epoch-relative batch indices, so quarantine
    persists across epochs only while the order is stable: a backing
    iterator advertising ``shuffle`` truthy re-permutes per epoch, and
    ``reset()`` then drops the quarantine state (the old positions name
    different batches; a still-poisoned batch re-earns quarantine at its
    new position)."""

    def __init__(self, backing: DataSetIterator, quarantine_after: int = 2):
        self._backing = backing
        self.quarantine_after = max(1, int(quarantine_after))
        self._failures: Dict[int, int] = {}
        self._quarantined: set = set()
        self._pos = 0                      # next position to pull

    def reset(self):
        self._backing.reset()
        if getattr(self._backing, "shuffle", False):
            # positions are epoch-relative: after a reshuffle they name
            # DIFFERENT batches, so carried-over quarantine would discard
            # healthy data and re-admit the poisoned batch. Start over —
            # a still-poisoned batch re-earns quarantine at its new
            # position. (reset_replay keeps state: same permutation.)
            self._failures.clear()
            self._quarantined.clear()
        self._pos = 0

    def reset_replay(self):
        """Rewind for a SAME-epoch replay after a restore: the fast-
        forward must see the exact batch order already applied, so
        delegate to the backing iterator's ``reset_replay`` (shuffling
        iterators re-present the interrupted pass's permutation; the
        base-class default is a plain ``reset()``, correct for any
        iterator deterministic across resets — see class doc)."""
        b = self._backing
        if hasattr(b, "reset_replay"):
            b.reset_replay()
        else:
            b.reset()
        self._pos = 0

    def has_next(self) -> bool:
        return self._backing.has_next()

    def next(self):
        while True:
            if not self._backing.has_next():
                raise StopIteration("SkippingIterator exhausted")
            ds = self._backing.next()
            pos = self._pos
            self._pos += 1
            if pos in self._quarantined:
                continue                   # pull-and-discard
            return ds

    def batch(self) -> int:
        return self._backing.batch()

    def position(self) -> int:
        """Epoch-relative index of the most recently pulled batch."""
        return self._pos - 1

    def note_failure(self, pos: int):
        if pos < 0:
            return
        n = self._failures.get(pos, 0) + 1
        self._failures[pos] = n
        if n >= self.quarantine_after and pos not in self._quarantined:
            self._quarantined.add(pos)
            _quarantined_counter().inc()
            _faults.record_event("quarantine", position=pos, failures=n)
            log.warning("quarantining batch %d after %d failures", pos, n)

    def quarantined(self):
        return sorted(self._quarantined)


def newest_checkpoint(directory: str) -> Optional[str]:
    """Newest *readable* checkpoint zip in ``directory`` (mtime, then
    the CheckpointListener counter, then name — the shared
    ``checkpoint_candidates`` ranking; torn files are never trusted)."""
    from deeplearning4j_tpu_torch.utils.serialization import (
        checkpoint_candidates)
    paths = checkpoint_candidates(directory)
    return paths[0] if paths else None


class ResilientTrainer:
    """Wrap a net's ``fit`` with restore-resume healing.

    ``target`` is a MultiLayerNetwork or ComputationGraph (the reference
    also takes a ShardedTrainer: ROADMAP queue 1 item 7). Checkpoints
    go to ``checkpoint_dir`` every ``checkpoint_every_iterations`` steps
    (default 1: exact resume — raise it for large models and accept
    replaying up to a cadence's worth of batches after a restore).

    Deliberate tradeoff: the resilient loop drives batches synchronously
    (no :class:`DevicePrefetchIterator` wrap) — a prefetch thread holding
    in-flight device batches across a restore would make the replayed
    batch order unverifiable, and restore-resume's exactness guarantee is
    the point of this class. Wrap the plain ``fit`` when overlap matters
    more than self-healing.
    """

    def __init__(self, target, checkpoint_dir: str, max_restarts: int = 3,
                 checkpoint_every_iterations: int = 1,
                 keep_checkpoints: int = 3,
                 retry_policy: Optional[RetryPolicy] = None,
                 quarantine_after: int = 2,
                 elastic: bool = False):
        #: elastic mode (sharded manifests, mesh shrink / re-expand) needs
        #: a multi-GPU target: refused, never silently ignored
        if elastic:
            raise NotImplementedError(
                "elastic=True: elastic checkpoints and mesh reshaping wait "
                "are not ported yet (ROADMAP queue 1 item 7B)")
        self.target = target
        self.net = getattr(target, "net", target)
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.max_restarts = max(0, int(max_restarts))
        self.checkpoint_every = max(1, int(checkpoint_every_iterations))
        self.keep_checkpoints = max(1, int(keep_checkpoints))
        self.retry = retry_policy if retry_policy is not None \
            else RetryPolicy(max_retries=2, base_delay_seconds=0.01)
        self.quarantine_after = max(1, int(quarantine_after))
        self.restarts = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ fit
    def fit(self, data, labels=None, epochs: int = 1):
        """Iterator-driven resilient fit (mirrors the wrapped surface:
        ``fit(x, y)`` / ``fit(DataSet)`` / ``fit(iterator)``). Non-
        iterator inputs and the kill switch delegate to the wrapped
        ``fit`` unchanged — restore-resume needs a re-pullable iterator."""
        if (not _faults.resilience_enabled()
                or not isinstance(data, DataSetIterator)):
            return self.target.fit(data, labels, epochs=epochs)
        from deeplearning4j_tpu_torch.optim.listeners import (
            CheckpointListener)
        self.restarts = 0          # the budget is per fit() call
        net = self.net
        if not net._initialized:
            net.init()
        it = data if isinstance(data, SkippingIterator) \
            else SkippingIterator(data, quarantine_after=self.quarantine_after)
        from deeplearning4j_tpu_torch.observability import span as _span
        from deeplearning4j_tpu_torch.observability.flight_recorder import (
            global_flight_recorder as _flight)
        ckpt = CheckpointListener(
            self.checkpoint_dir,
            save_every_n_iterations=self.checkpoint_every,
            keep_last=self.keep_checkpoints)
        net.addListeners(ckpt)
        try:
            # ONE root span + flight-recorder arm for the whole fit (the
            # public per-batch fit would re-arm and open a new root trace
            # for every batch — see _fit_one, which enters below it)
            with _flight().arm(f"fit:{type(net).__name__}"), \
                    _span("fit", model=type(net).__name__, epochs=epochs,
                          resilient=True):
                self._fit_epochs(it, epochs)
        finally:
            net._listeners.remove(ckpt)
        # same return as the delegate branch above (the wrapped fit
        # returns its target) — callers chain identically in both postures
        return self.target

    def _fit_epochs(self, it: "SkippingIterator", epochs: int):
        net = self.net
        for _ in range(epochs):
            # the restore target must never predate the epoch about
            # to start: with cadence > 1 the newest cadence
            # checkpoint can sit mid-PREVIOUS-epoch, and a restore
            # past the boundary would silently drop that epoch's tail
            # (this epoch's replay loop cannot reach it)
            self._save_boundary_with_budget()
            for lst in net._listeners:
                lst.on_epoch_start(net, net._epoch)
            self._fit_epoch(it)
            net._sync_score()
            for lst in net._listeners:
                lst.on_epoch_end(net, net._epoch)
            net._epoch += 1
            _tm_for(net).epochs.inc()

    def _fit_epoch(self, it: SkippingIterator):
        net = self.net
        iter0 = net._iteration
        target = 0                 # next batch position still to apply
        first_pass = True
        while True:                # restart loop: re-enter after a restore
            if first_pass:
                it.reset()         # fresh epoch: shuffle may advance
                first_pass = False
            else:
                # replay: the SAME order as the interrupted pass, or the
                # fast-forward would skip a different permutation than
                # the batches actually applied
                it.reset_replay()
            step_iter0 = None      # iteration before the failing _step
            try:
                while True:
                    step_iter0 = None
                    try:
                        ds = next(it)
                    except StopIteration:
                        return
                    if it.position() < target:
                        continue   # fast-forward: already in the params
                    step_iter0 = net._iteration
                    self._step(ds)
                    target = it.position() + 1
            except (TrainingPreempted, KeyboardInterrupt,
                    RestartBudgetExhausted):
                raise
            except Exception as e:
                # if the iteration counter moved, the batch's update
                # LANDED and the failure came from the post-update tail
                # (e.g. a checkpoint.save error in a listener) — the
                # batch is innocent and must not be blamed/quarantined
                landed = (step_iter0 is not None
                          and net._iteration != step_iter0)
                target = self._recover(e, it, iter0, target,
                                       blame_batch=not landed)

    def _fit_one(self, ds):
        """One batch through the per-batch entry BELOW the public fit:
        ``net.fit(ds)`` would re-arm the flight recorder and open a fresh
        root ``fit`` trace for every batch — the single arm + root span in
        :meth:`fit` covers the whole run instead. (The ``train.step``
        fault point lives inside ``_fit_batch``, so chaos coverage is
        unchanged.)"""
        net = self.net
        net._fit_batch(*net._ds_args(ds))

    def _step(self, ds):
        """One batch through the wrapped fit, retrying transient failures
        in place — but ONLY while the iteration counter proves the update
        never landed (train.step faults fire before the step touches any
        param, so a rerun is exact; a transient
        failure AFTER the update — e.g. a checkpoint.save fault in the
        listener — must take the restore path or the batch would apply
        twice)."""
        net = self.net
        start_iter = net._iteration

        def retryable(e):
            return is_transient(e) and net._iteration == start_iter

        try:
            self.retry.call(lambda: self._fit_one(ds), op="train.step",
                            retry_on=retryable)
        except Exception as e:
            if is_transient(e) and net._iteration != start_iter:
                # the update landed and only the post-step tail (e.g. a
                # checkpoint.save fault in the listener) failed
                # transiently: keep the applied update — the next
                # iteration's cadence save checkpoints a newer state, and
                # a crash before then restores + replays exactly
                log.warning("post-update transient failure (%s); update "
                            "kept, not re-applied", type(e).__name__)
                return
            _tm_for(net).step_failures.inc()
            raise

    # ------------------------------------------------------------- recovery
    def _recover(self, error: BaseException, it: SkippingIterator,
                 iter0: int, target: int, blame_batch: bool = True) -> int:
        """Count the restart, mark the failing batch, restore the newest
        checkpoint; returns the batch position to fast-forward to."""
        self.restarts += 1
        log.warning("training step failed (%s: %s); restart %d/%d",
                    type(error).__name__, error, self.restarts,
                    self.max_restarts)
        if self.restarts > self.max_restarts:
            raise RestartBudgetExhausted(
                f"training failed {self.restarts} times; restart budget "
                f"({self.max_restarts}) exhausted") from error
        # counted only for restarts actually PERFORMED — the exhausting
        # attempt above restores nothing and must not inflate the metric
        _restarts_counter(self.net).inc()
        _faults.record_event("restart", restarts=self.restarts,
                             error=type(error).__name__,
                             detail=str(error)[:200])
        # only the batch actually being APPLIED can be at fault —
        # positions below ``target`` are already inside the params (a
        # flaky re-pull during fast-forward must not quarantine them:
        # _position_for assumes quarantined positions were never applied),
        # and a failure AFTER the update landed (blame_batch=False) came
        # from the post-update tail, not the batch
        if blame_batch and it.position() >= target:
            it.note_failure(it.position())
        restored_iter = self._restore_latest(min_iteration=iter0)
        if restored_iter < iter0:
            # should not happen (a boundary checkpoint is written at every
            # epoch start) — but if the directory was tampered with, say
            # so instead of silently losing the prior epoch's tail
            log.warning(
                "restored checkpoint (iteration %d) predates the epoch "
                "boundary (iteration %d); updates between them cannot be "
                "replayed by this epoch's loop", restored_iter, iter0)
        return self._position_for(it, max(0, restored_iter - iter0))

    @staticmethod
    def _position_for(it: SkippingIterator, applied: int) -> int:
        """Map a count of APPLIED batches back to the iterator position to
        resume from: quarantined positions never advanced the iteration
        counter, so they don't count toward ``applied``."""
        pos = seen = 0
        while seen < applied:
            if pos not in it._quarantined:
                seen += 1
            pos += 1
        return pos

    def _restore_latest(self, min_iteration: int = 0) -> int:
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer, checkpoint_candidates)
        paths = checkpoint_candidates(self.checkpoint_dir)
        if not paths:
            raise RestartBudgetExhausted(
                f"no readable checkpoint in {self.checkpoint_dir} to "
                "restore from")
        # newest candidate that does NOT predate the epoch boundary: the
        # mtime ranking can tie the boundary checkpoint with the previous
        # epoch's last cadence file on coarse-mtime filesystems, and the
        # zip's own iteration counter is the authoritative tiebreak
        restored = path = last_err = None
        for cand in paths:
            def _do(c=cand):
                _faults.check("checkpoint.restore")
                return ModelSerializer.restore(c, load_updater=True,
                                               device=self.net.device)
            try:
                r = self.retry.call(_do, op="checkpoint.restore")
            except (TrainingPreempted, KeyboardInterrupt):
                raise
            # graftlint: disable=typed-errors — documented fallback:
            # skip-to-next-newest instead of killing fit()
            except Exception as e:
                # structurally-valid-but-unrestorable zips (stray export,
                # different model class, content corruption) rank like any
                # other candidate — skip to the next-newest, as the
                # candidates docstring promises, instead of killing fit()
                last_err = e
                log.warning("checkpoint %s failed to restore (%s: %s); "
                            "trying next-newest", cand, type(e).__name__, e)
                continue
            if restored is None:
                restored, path = r, cand       # newest = the fallback
            if r._iteration >= min_iteration:
                restored, path = r, cand
                break
        if restored is None:
            raise RestartBudgetExhausted(
                f"no restorable checkpoint in {self.checkpoint_dir}"
            ) from last_err
        net = self.net
        # every param, state and updater leaf is replaced: a step that died
        # mid-update (half its foreach updates applied) leaves nothing
        # behind. The frozen set stays the trainer's (a zip carries none)
        net.set_param_tree(restored._params)
        net.set_state_tree(restored._states)
        net._opt_state = restored._opt_state
        net._iteration = restored._iteration
        # epoch bookkeeping stays ours (the checkpoint's epoch counter may
        # lag the restart loop); pending device-side fetches are stale
        net._pending_score = None
        net._pending_health = []
        _restores_counter().inc()
        _faults.record_event("restore", path=os.path.basename(path),
                             iteration=net._iteration)
        log.warning("restored checkpoint %s (iteration %d)", path,
                    net._iteration)
        return net._iteration

    def _save_boundary_checkpoint(self):
        """Snapshot the epoch-boundary state (one rotating file, atomic
        overwrite). Doubles as the initial checkpoint: batch 0 failing
        with an empty directory is recoverable too."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            save_model_atomic)
        net = self.net
        path = os.path.join(self.checkpoint_dir,
                            f"resilient_boundary_{type(net).__name__}.zip")

        def _do():
            _faults.check("checkpoint.save")
            save_model_atomic(net, path)

        self.retry.call(_do, op="checkpoint.save")

    def _save_boundary_with_budget(self):
        """Boundary saves get the same bounded-restart treatment as step
        failures: a non-transient (or retry-exhausting) save error must
        consume the restart budget and be re-attempted, not abort fit()
        on the spot — the identical failure one step later, inside
        CheckpointListener, is absorbed by _fit_epoch's recovery path.
        (Nothing to restore: the params are intact; only the save
        failed.)"""
        while True:
            try:
                self._save_boundary_checkpoint()
                return
            except (TrainingPreempted, KeyboardInterrupt,
                    RestartBudgetExhausted):
                raise
            except Exception as e:
                self.restarts += 1
                log.warning("boundary checkpoint save failed (%s: %s); "
                            "restart %d/%d", type(e).__name__, e,
                            self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise RestartBudgetExhausted(
                        f"boundary checkpoint save failed; restart budget "
                        f"({self.max_restarts}) exhausted") from e
                _faults.record_event("restart", restarts=self.restarts,
                                     error=type(e).__name__,
                                     detail=str(e)[:200])


# ------------------------------------------------------------ metric handles
# handles live in faults' shared cache (one reset hook for the layer)
def _quarantined_counter():
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_data_quarantined_total",
            "batches quarantined by SkippingIterator after repeated "
            "failures")
    return _faults.cached_metric_handle(("quarantine",), make)


def _restores_counter():
    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_checkpoint_restores_total",
            "checkpoint restores performed by ResilientTrainer")
    return _faults.cached_metric_handle(("restores",), make)


def _restarts_counter(net):
    kind = type(net).__name__

    def make():
        from deeplearning4j_tpu_torch.observability import global_registry
        return global_registry().counter(
            "dl4j_resilience_restarts_total",
            "restore-resume restarts performed by ResilientTrainer",
            label_names=("model",)).labels(model=kind)
    return _faults.cached_metric_handle(("restarts", kind), make)


def _tm_for(net):
    from deeplearning4j_tpu_torch.observability import train_metrics as _tm
    return _tm.for_model(net)
