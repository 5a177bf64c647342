"""DataSet iterators: counterpart of ``deeplearning4j_tpu/data/iterators.py``
(the reference's ``DataSetIterator``, ``ListDataSetIterator``,
``ArrayDataSetIterator``, ``AsyncDataSetIterator``, ``MultipleEpochsIterator``
and the device prefetch the fit loops wrap an iterator in).
``record_reader_iterator.py`` holds the DataVec bridges,
``RecordReaderDataSetIterator`` and ``SequenceRecordReaderDataSetIterator``."""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import async_runtime as _async
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.observability import global_registry, on_registry_reset
from deeplearning4j_tpu_torch.observability import span as _span
from deeplearning4j_tpu_torch.observability.tracing import (current_context,
                                                      trace_context)
from deeplearning4j_tpu_torch.resilience import faults as _faults

_obs_cache: dict = {}


def _data_obs(kind: str):
    """(batches counter, wait histogram) label-bound per iterator class."""
    handles = _obs_cache.get(kind)
    if handles is None:
        reg = global_registry()
        handles = _obs_cache[kind] = (
            reg.counter("dl4j_data_batches_total",
                        "minibatches produced by data iterators",
                        label_names=("iterator",)).labels(iterator=kind),
            reg.histogram("dl4j_data_wait_seconds",
                          "host time blocked waiting on the data pipeline",
                          label_names=("iterator",)).labels(iterator=kind))
    return handles


def _prefetch_obs(kind: str):
    """(ready counter, wait counter, overlap-ratio gauge) for the device
    prefetch stage, label-bound per BACKING iterator class — "ready" means
    the consumer found the next batch already on device (transfer fully
    overlapped with compute). Labeling follows _data_obs: per-class, so two
    pipelines (train + eval, two models) don't clobber one series."""
    handles = _obs_cache.get(("__prefetch__", kind))
    if handles is None:
        reg = global_registry()
        hit = reg.counter("dl4j_async_prefetch_total",
                          "prefetched-batch handoffs by outcome: ready = "
                          "batch was already on device, wait = consumer "
                          "blocked on the prefetch thread",
                          label_names=("outcome", "iterator"))
        handles = _obs_cache[("__prefetch__", kind)] = (
            hit.labels(outcome="ready", iterator=kind),
            hit.labels(outcome="wait", iterator=kind),
            reg.gauge("dl4j_async_overlap_ratio",
                      "fraction of batches whose device transfer fully "
                      "overlapped compute (ready / all handoffs, this "
                      "epoch)", label_names=("iterator",)).labels(
                          iterator=kind))
    return handles


@on_registry_reset
def _drop_data_obs():
    _obs_cache.clear()


class DataSetIterator:
    """Base iterator protocol (ref: DataSetIterator)."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds = self.next()
        if _faults.armed():
            # chaos injection point: a corrupt shard / flaky loader is an
            # error raised here; a nan fault poisons the yielded batch
            # (the caller's copy — the backing store is never mutated)
            _faults.check("data.next_batch")
            ds = _faults.corrupt_dataset("data.next_batch", ds)
        _data_obs(type(self).__name__)[0].inc()
        return ds

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def reset_replay(self):
        """Rewind for a SAME-epoch replay (restore-resume fast-forward):
        re-present the exact batch order of the pass in progress. The
        default is a plain ``reset()`` — correct for any iterator that is
        deterministic across resets; iterators that re-shuffle on reset
        must override to re-draw the interrupted pass's permutation."""
        self.reset()

    def batch(self) -> int:
        raise NotImplementedError

    # camelCase parity
    hasNext = has_next


class ListDataSetIterator(DataSetIterator):
    """Iterate over a pre-built list of DataSets (ref: ListDataSetIterator)."""

    def __init__(self, datasets: Sequence[DataSet], batch_size: Optional[int] = None):
        if batch_size is not None and len(datasets) == 1:
            datasets = datasets[0].batch_by(batch_size)
        self._list: List[DataSet] = list(datasets)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._list)

    def next(self) -> DataSet:
        ds = self._list[self._pos]
        self._pos += 1
        return ds

    def reset(self):
        self._pos = 0

    def batch(self) -> int:
        return self._list[0].num_examples() if self._list else 0


class ArrayDataSetIterator(DataSetIterator):
    """Minibatch over big arrays, optional shuffle per epoch."""

    def __init__(self, features, labels, batch_size: int, shuffle: bool = False, seed: int = 0,
                 features_mask=None, labels_mask=None, drop_last: bool = False):
        self._ds = DataSet(features, labels, features_mask, labels_mask)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self.drop_last = drop_last
        self._order = np.arange(self._ds.num_examples())
        self._pos = 0
        self._maybe_shuffle()

    def _maybe_shuffle(self):
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            self._order = rng.permutation(self._ds.num_examples())

    def has_next(self) -> bool:
        remaining = self._ds.num_examples() - self._pos
        return remaining >= (self.batch_size if self.drop_last else 1)

    def next(self) -> DataSet:
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        d = self._ds
        return DataSet(d.features[idx], d.labels[idx],
                       None if d.features_mask is None else d.features_mask[idx],
                       None if d.labels_mask is None else d.labels_mask[idx])

    def reset(self):
        self._pos = 0
        self._epoch += 1
        self._maybe_shuffle()

    def reset_replay(self):
        # no epoch bump, no re-shuffle: self._order still holds the
        # permutation the interrupted pass was walking
        self._pos = 0

    def batch(self) -> int:
        return self.batch_size


class _Failure:
    """An error a producer thread met, handed to the consumer in the
    queue so it surfaces at the batch it failed on."""
    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


class MultipleEpochsIterator(DataSetIterator):
    """(ref: MultipleEpochsIterator) — repeat a backing iterator N times."""

    def __init__(self, epochs: int, backing: DataSetIterator):
        self._backing = backing
        self._epochs = epochs
        self._cur = 0

    def has_next(self) -> bool:
        if self._backing.has_next():
            return True
        if self._cur + 1 < self._epochs:
            self._cur += 1
            self._backing.reset()
            return self._backing.has_next()
        return False

    def next(self) -> DataSet:
        return self._backing.next()

    def reset(self):
        self._cur = 0
        self._backing.reset()

    def batch(self) -> int:
        return self._backing.batch()


def _put_tree(v, put):
    """Apply ``put`` to every array in a (possibly tuple-valued) field."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return type(v)(_put_tree(e, put) for e in v)
    return put(v)


def _put_tree_all(ds, fn):
    """``fn`` over every tensor field of a placed DataSet."""
    for field in ("features", "labels", "features_mask", "labels_mask",
                  "features_masks", "labels_masks"):
        v = getattr(ds, field, None)
        for t in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(t, torch.Tensor):
                fn(t)


def _place_dataset(ds, put):
    """Shallow-copy a DataSet/MultiDataSet with every array field run
    through ``put`` (device placement). Unknown extra attributes survive
    because the copy starts from ``copy.copy``."""
    import copy

    out = copy.copy(ds)
    for field in ("features", "labels", "features_mask", "labels_mask",
                  "features_masks", "labels_masks"):
        if hasattr(out, field):
            setattr(out, field, _put_tree(getattr(out, field), put))
    return out


class _PrefetchIterator(DataSetIterator):
    """A daemon producer thread pulls batches from the backing iterator
    through ``_place`` into a bounded queue of ``depth``; the consumer
    takes them from the queue. The producer starts lazily, at the first
    ``has_next``/``next``; ``reset`` and ``close`` stop it and join it
    under a timeout, so a consumer that walks away never leaves a thread
    behind a full queue. An error the backing iterator raises reaches the
    consumer after the last good batch."""

    _SENTINEL = object()
    _THREAD_NAME = "dl4j-prefetch"
    #: seconds ``reset`` / ``close`` wait for the producer to exit
    JOIN_TIMEOUT = 5.0

    def __init__(self, backing: DataSetIterator, depth: int):
        self._backing = backing
        self._depth = max(1, depth)
        self._hits = 0
        self._waits = 0
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._next_item = None
        self._error: Optional[BaseException] = None
        # lazy start: fit loops call reset() (twice — fit + __iter__) before
        # consuming; spawning the thread on first access instead of here
        # avoids burning thread spawns and device transfers per reset

    def _place(self, ds):
        return ds

    def _hand_over(self, ds):
        return ds

    def _start(self):
        # q/stop are CLOSURE LOCALS, not self attributes: if close()'s join
        # times out (producer wedged in a long device_put), reset() replaces
        # self._queue/self._stop — a stale thread holding only its own
        # locals can never feed the new epoch's queue or miss its stop flag
        q = self._queue = queue.Queue(maxsize=self._depth)
        stop = self._stop = threading.Event()
        backing, place = self._backing, self._place
        # causal handoff: capture the CONSUMER's trace context (the fit
        # loop that first pulls a batch) so every prefetch span on the
        # producer thread parents into the fit trace — Perfetto then draws
        # the fit→prefetch arrows instead of orphan fragments
        ctx = current_context()
        kind = type(backing).__name__

        def put_stop_aware(item) -> bool:
            # never park forever on a consumer that went away mid-epoch:
            # close()/reset() set the stop flag, then drain
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with trace_context(ctx):
                try:
                    while not stop.is_set():
                        try:
                            # has_next() inside the try too: an iterator
                            # that raises probing for data (corrupt shard,
                            # IO error) must surface to the consumer, not
                            # be laundered into a clean end-of-epoch by
                            # the finally-sentinel
                            if not backing.has_next():
                                break
                            with _span("prefetch_place", iterator=kind):
                                item = place(backing.next())
                        except Exception as e:  # surface on consumer side
                            item = _Failure(e)
                        put_stop_aware(item)
                        if isinstance(item, _Failure):
                            return
                finally:
                    # the sentinel MUST be delivered (a full queue here is
                    # the normal case — the consumer still owes `depth`
                    # reads), so block for it; the stop flag keeps close()
                    # live
                    put_stop_aware(self._SENTINEL)

        self._thread = threading.Thread(target=producer, daemon=True,
                                        name=self._THREAD_NAME)
        self._thread.start()
        self._advance()

    def _ensure_started(self):
        if self._thread is None:
            self._start()

    def _advance(self):
        obs = _data_obs(type(self).__name__)
        hit, wait, ratio = _prefetch_obs(type(self._backing).__name__)
        t0 = time.perf_counter()
        try:
            item = self._queue.get_nowait()
            self._hits += 1
            hit.inc()
        except queue.Empty:
            item = self._queue.get()
            self._waits += 1
            wait.inc()
        obs[1].observe(time.perf_counter() - t0)
        total = self._hits + self._waits
        if total:
            ratio.set(self._hits / total)
        if isinstance(item, _Failure):
            # don't raise here: next() calls _advance AFTER taking the
            # (valid) current batch — raising now would drop it. Surface
            # the error on the NEXT has_next()/next() access instead.
            self._error = item.error
            self._next_item = None
            return
        self._next_item = None if item is self._SENTINEL else item

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def has_next(self) -> bool:
        self._ensure_started()
        self._raise_pending()
        return self._next_item is not None

    def next(self) -> DataSet:
        self._ensure_started()
        self._raise_pending()
        if self._next_item is None:
            # past the end there is no producer left to feed the queue —
            # blocking in _advance would hang forever (DL4J's next() throws
            # NoSuchElementException here)
            raise StopIteration(f"{type(self).__name__} exhausted")
        ds = self._next_item
        self._advance()
        return self._hand_over(ds)

    def close(self):
        """Stop the prefetch thread without restarting (terminal)."""
        if self._thread is None:
            return
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=self.JOIN_TIMEOUT)
        self._thread = None
        self._next_item = None

    def reset(self):
        self.close()
        self._error = None
        # per-epoch overlap accounting: a late-epoch transfer regression
        # should move the gauge, not be averaged into ancient history
        self._hits = 0
        self._waits = 0
        self._backing.reset()

    def batch(self) -> int:
        return self._backing.batch()

    def overlap_ratio(self) -> float:
        """Fraction of handoffs where the batch was already queued."""
        total = self._hits + self._waits
        return self._hits / total if total else 0.0


class DevicePrefetchIterator(_PrefetchIterator):
    """Double-buffered device prefetch. A background thread pulls batch
    *k+1* from the backing iterator and copies it to the card while step
    *k* runs, so the fit loop dequeues batches already on the card.

    On CUDA each array is copied into pinned host memory and sent by a
    non-blocking copy on a side stream; the batch carries an event
    recorded after its copies, and ``next()`` makes the consumer's stream
    wait on that event (a device-side wait, not a host block) and records
    the tensors' use on that stream for the caching allocator. On the CPU
    a batch becomes CPU tensors.

    ``device`` (default: the card) is where batches land. ``placement``
    (ref: the reference's ``placement`` hook) customizes what lands: a
    function of a DataSet run on the producer thread before the copy
    (``ShardedTrainer`` passes one that keeps its rank's rows).
    """

    _THREAD_NAME = "dl4j-device-prefetch"

    def __init__(self, backing: DataSetIterator, depth: Optional[int] = None,
                 device=None, placement=None):
        from deeplearning4j_tpu_torch._device import resolve_device
        super().__init__(backing, depth if depth is not None
                         else _async.prefetch_depth())
        self._device = resolve_device(device)
        self._side_stream = None
        self._placement = placement

    @classmethod
    def wrap(cls, iterator, depth: Optional[int] = None, device=None,
             placement=None):
        """Wrap a DataSetIterator for device prefetch when the async
        runtime is enabled; anything else (plain lists, generators,
        already-wrapped iterators, kill switch off) passes through."""
        if (not _async.async_enabled()
                or isinstance(iterator, DevicePrefetchIterator)
                or not isinstance(iterator, DataSetIterator)):
            return iterator
        return cls(iterator, depth=depth, device=device, placement=placement)

    def _place(self, ds):
        if self._placement is not None:
            ds = self._placement(ds)
        dev = self._device
        if dev.type != "cuda":
            return _place_dataset(ds, lambda a: torch.as_tensor(a, device=dev))
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(device=dev)

        def put(a):
            host = torch.as_tensor(a)
            if host.device.type == "cpu":
                host = host.pin_memory()
            return host.to(dev, non_blocking=True)

        with torch.cuda.stream(self._side_stream):
            out = _place_dataset(ds, put)
            ready = torch.cuda.Event()
            ready.record(self._side_stream)
        out._ready_event = ready
        return out

    def _hand_over(self, ds):
        """Make the consumer's stream wait for ``ds``'s copies (CUDA)."""
        ready = getattr(ds, "_ready_event", None)
        if ready is None:
            return ds
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(ready)
        _put_tree_all(ds, lambda t: t.record_stream(stream))
        del ds._ready_event
        return ds


class AsyncDataSetIterator(_PrefetchIterator):
    """Background-thread prefetch wrapper (ref: AsyncDataSetIterator;
    queue-based producer/consumer, bounded buffer of ``queue_size``).
    Batches stay where the backing iterator made them: the fit loops'
    device prefetch moves them to the card."""

    _THREAD_NAME = "dl4j-async-iterator"

    def __init__(self, backing: DataSetIterator, queue_size: int = 4):
        super().__init__(backing, queue_size)
