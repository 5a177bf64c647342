"""TrainingMaster facades — the reference's distributed entry points.

Counterpart of ``deeplearning4j_tpu/parallel/master.py``
(``org.deeplearning4j.spark.api.TrainingMaster``, ``SharedTrainingMaster``,
``ParameterAveragingTrainingMaster``, ``SparkDl4jMultiLayer``,
``SparkComputationGraph``). A master builds the ``data`` mesh over the
process group's ranks, re-batches the input to ``batch_size_per_worker``
× the data axis, and drives a :class:`ShardedTrainer`;
``SharedTrainingMaster``'s threshold algorithm routes it through the
compressed exchange.

:class:`DistributedConfig` starts the process group (the reference's
``jax.distributed.initialize``): ``nccl`` on the card, ``gloo`` only when
the caller asked for the CPU, ``torch.cuda.set_device(LOCAL_RANK)`` on the
card.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, MeshSpec,
                                                    axis_size, backend_for)
from deeplearning4j_tpu_torch.parallel.trainer import ShardedTrainer

# one probe per process: the answer cannot change while torch doesn't
_MULTIPROC_PROBE: Optional[Tuple[bool, str]] = None

_PROBE_SCRIPT = r"""
import sys
import torch
import torch.distributed as dist
store = dist.FileStore(sys.argv[2], 2)
dist.init_process_group("gloo", store=store, rank=int(sys.argv[1]),
                        world_size=2)
t = torch.ones(1)
dist.all_reduce(t)
print("ALLREDUCE_OK", float(t), flush=True)
dist.destroy_process_group()
"""


def multiprocess_cpu_collectives_supported(
        timeout_s: float = 120.0) -> Tuple[bool, str]:
    """Can this torch run a cross-process collective on the CPU? Two
    throwaway processes form a ``gloo`` group over a ``FileStore`` and
    all-reduce one scalar. Cached per process; ``DL4J_TPU_MULTIHOST_PROBE``
    overrides it (``1`` = assume supported, ``0`` = assume not). Returns
    ``(supported, reason)``."""
    global _MULTIPROC_PROBE
    override = os.environ.get("DL4J_TPU_MULTIHOST_PROBE", "")
    if override == "1":
        return True, "forced by DL4J_TPU_MULTIHOST_PROBE=1"
    if override == "0":
        return False, "forced by DL4J_TPU_MULTIHOST_PROBE=0"
    if _MULTIPROC_PROBE is not None:
        return _MULTIPROC_PROBE
    import subprocess
    import sys
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _PROBE_SCRIPT, str(i), store],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(2)]
        outs, ok = [], True
        try:
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    out = (out or "") + "\n<probe timeout>"
                    ok = False
                outs.append(out or "")
                ok = ok and p.returncode == 0 and "ALLREDUCE_OK" in outs[-1]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    if ok:
        _MULTIPROC_PROBE = (True, "2-process gloo all-reduce succeeded")
    else:
        reason = "2-process gloo all-reduce failed"
        for out in outs:
            lines = [ln for ln in out.strip().splitlines()
                     if "Error" in ln or "error" in ln or "<probe" in ln]
            if lines:
                reason = lines[-1].strip()[:200]
                break
        _MULTIPROC_PROBE = (False, reason)
    return _MULTIPROC_PROBE


@dataclasses.dataclass
class DistributedConfig:
    """Process-group bootstrap (ref: VoidConfiguration → the coordinator
    address and process ids). Unset fields come from the environment:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` (or
    ``coordinator_address`` ``"host:port"``); ``store`` (a
    ``torch.distributed`` store, e.g. a ``FileStore``) replaces the
    address. ``device`` is this rank's (default the card)."""
    coordinator_address: Optional[str] = None   # "host:port" of rank 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    device: object = None
    store: object = None

    def initialize(self):
        """``torch.distributed.init_process_group`` with the backend the
        device needs; returns the device."""
        import torch
        import torch.distributed as dist
        from deeplearning4j_tpu_torch._device import resolve_device
        env = os.environ
        rank = (self.process_id if self.process_id is not None
                else int(env.get("RANK", "0")))
        world = (self.num_processes if self.num_processes is not None
                 else int(env.get("WORLD_SIZE", "1")))
        dev = torch.device("cuda" if self.device is None else self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
        dev = resolve_device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if dist.is_initialized():
            return dev
        kw = dict(backend=backend_for(dev), rank=rank, world_size=world)
        if self.store is not None:
            kw["store"] = self.store
        else:
            addr = self.coordinator_address or "{}:{}".format(
                env.get("MASTER_ADDR", "127.0.0.1"),
                env.get("MASTER_PORT", "29500"))
            kw["init_method"] = f"tcp://{addr}"
        dist.init_process_group(**kw)
        return dev


class TrainingMaster:
    """Base facade: a MeshSpec and the batch policy.
    ``tensor_parallel`` (a model axis) is ROADMAP queue 1 item 7B: the
    trainer it makes raises."""

    def __init__(self, batch_size_per_worker: int = 32,
                 workers: Optional[int] = None, tensor_parallel=False):
        self.batch_size_per_worker = batch_size_per_worker
        self.workers = workers
        self.tensor_parallel = tensor_parallel

    def mesh_spec(self) -> MeshSpec:
        if self.tensor_parallel:
            model = (int(self.tensor_parallel)
                     if not isinstance(self.tensor_parallel, bool) else 2)
            return MeshSpec.dp_tp(data=self.workers or -1, model=model)
        return MeshSpec.data_parallel(self.workers or -1)

    def make_trainer(self, net) -> ShardedTrainer:
        return ShardedTrainer(net, self.mesh_spec(),
                              tensor_parallel=bool(self.tensor_parallel))


class SharedTrainingMaster(TrainingMaster):
    """ref: ``SharedTrainingMaster``. ``threshold_algorithm`` (a
    ``compression.ThresholdAlgorithm`` or a spec string) routes the trainer
    through the compressed exchange; an explicit ``threshold`` without an
    algorithm means ``fixed:t``; neither keeps the dense exchange, under
    which ``DL4J_TPU_GRAD_COMPRESS`` still applies (``0`` is the kill
    switch either way)."""

    def __init__(self, batch_size_per_worker: int = 32,
                 workers: Optional[int] = None,
                 threshold: Optional[float] = None, threshold_algorithm=None,
                 workers_per_node: Optional[int] = None, **_ignored):
        super().__init__(batch_size_per_worker, workers or workers_per_node)
        if threshold is not None and threshold_algorithm is None:
            threshold_algorithm = "fixed:%g" % float(threshold)
        self.threshold = 1e-3 if threshold is None else threshold
        self.threshold_algorithm = threshold_algorithm

    def make_trainer(self, net) -> ShardedTrainer:
        return ShardedTrainer(net, self.mesh_spec(),
                              tensor_parallel=bool(self.tensor_parallel),
                              grad_compression=self.threshold_algorithm)

    class Builder:
        def __init__(self, *args):
            self._kw = {}

        def batch_size_per_worker(self, n):
            self._kw["batch_size_per_worker"] = n
            return self

        batchSizePerWorker = batch_size_per_worker

        def workers_per_node(self, n):
            self._kw["workers"] = n
            return self

        workersPerNode = workers_per_node

        def threshold_algorithm(self, a):
            self._kw["threshold_algorithm"] = a
            return self

        thresholdAlgorithm = threshold_algorithm

        def threshold(self, t):
            """ref: Builder#threshold — a fixed algorithm at ``t`` when no
            algorithm is set."""
            self._kw["threshold"] = t
            return self

        def build(self):
            return SharedTrainingMaster(**self._kw)


class ParameterAveragingTrainingMaster(TrainingMaster):
    """ref: ``ParameterAveragingTrainingMaster``: the synchronous all-reduce
    every step subsumes periodic averaging."""

    def __init__(self, batch_size_per_worker: int = 32,
                 workers: Optional[int] = None,
                 averaging_frequency: int = 1, **_ignored):
        super().__init__(batch_size_per_worker, workers)
        self.averaging_frequency = averaging_frequency

    class Builder:
        def __init__(self, *args):
            self._kw = {}

        def batch_size_per_worker(self, n):
            self._kw["batch_size_per_worker"] = n
            return self

        def averaging_frequency(self, n):
            self._kw["averaging_frequency"] = n
            return self

        averagingFrequency = averaging_frequency

        def build(self):
            return ParameterAveragingTrainingMaster(**self._kw)


def _rebatch(data, target: int):
    """Re-chunk a stream of DataSets to ``target`` examples a step;
    DataSets with masks or several inputs pass through unchanged, as the
    reference."""
    import numpy as np
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    buf_x, buf_y, n = [], [], 0
    has_labels = None
    for ds in data:
        x, y = ds.features, ds.labels
        if (isinstance(x, (tuple, list)) or ds.features_mask is not None
                or getattr(ds, "labels_mask", None) is not None):
            yield ds
            continue
        if has_labels is None:
            has_labels = y is not None
        elif has_labels != (y is not None):
            raise ValueError(
                "mixed labeled/unlabeled DataSets in one stream cannot be "
                "re-batched without misaligning features and labels")
        buf_x.append(np.asarray(x))
        if has_labels:
            buf_y.append(np.asarray(y))
        n += buf_x[-1].shape[0]
        while n >= target:
            X = np.concatenate(buf_x) if len(buf_x) > 1 else buf_x[0]
            Y = (np.concatenate(buf_y) if len(buf_y) > 1 else buf_y[0]) \
                if has_labels else None
            yield DataSet(X[:target], Y[:target] if has_labels else None)
            buf_x = [X[target:]] if X.shape[0] > target else []
            buf_y = ([Y[target:]] if Y.shape[0] > target else []) \
                if has_labels else []
            n -= target
    if n:
        yield DataSet(np.concatenate(buf_x) if len(buf_x) > 1 else buf_x[0],
                      (np.concatenate(buf_y) if len(buf_y) > 1 else buf_y[0])
                      if has_labels else None)


class SparkDl4jMultiLayer:
    """ref: ``SparkDl4jMultiLayer``. The SparkContext slot is accepted and
    unused; every rank is handed the same stream and trains on its
    shard of each global batch."""

    def _wrap_conf(self, net_or_conf):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork(net_or_conf)

    def __init__(self, sc, net_or_conf, training_master: TrainingMaster):
        if not hasattr(net_or_conf, "fit"):
            net_or_conf = self._wrap_conf(net_or_conf)
        self.network = net_or_conf
        self.training_master = training_master
        self._trainer = training_master.make_trainer(self.network)

    def fit(self, data, epochs: int = 1):
        tm = self.training_master
        if hasattr(data, "__iter__") and not hasattr(data, "shape"):
            target = tm.batch_size_per_worker * axis_size(self._trainer.mesh,
                                                          DATA_AXIS)
            for _ in range(epochs):
                if hasattr(data, "reset"):
                    data.reset()
                self._trainer.fit(list(_rebatch(data, target)), epochs=1)
        else:
            self._trainer.fit(data, epochs=epochs)
        return self.network

    def get_network(self):
        return self.network

    getNetwork = get_network


class SparkComputationGraph(SparkDl4jMultiLayer):
    """ref: ``SparkComputationGraph``."""

    def _wrap_conf(self, net_or_conf):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        return ComputationGraph(net_or_conf)
