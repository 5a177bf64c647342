"""ShardedTrainer — data-parallel training over ``torch.distributed``.

Counterpart of ``deeplearning4j_tpu/parallel/trainer.py``. The reference
runs one GSPMD program over a device mesh; the port runs one process a GPU,
each holding the whole net, and puts the exchange between the gradients
and the optimizer (the net's ``_grad_exchange`` hook, ``nn/_network.py``).

Every rank is handed the same global batch and trains on its equal shard
(rank r takes rows ``[r·b, (r+1)·b)``); a batch the ranks cannot split
evenly runs whole on every rank, as the reference replicates it, with one
dropout mask and its gradients, loss and float states averaged over the
ranks, so that the ranks stay identical.

- The dense exchange computes the reference's global program: each rank
  backpropagates the mean loss of its shard, BatchNormalization's training
  moments are taken over the global batch (E[x] and E[x²] summed through a
  differentiable all-reduce, ``ops/moments.global_batch``), and the
  gradients and the loss are all-reduced to their mean in one call.
- The compressed exchange (``grad_compression``, ``DL4J_TPU_GRAD_COMPRESS``)
  is per replica, as the reference's ``shard_map`` step: local loss and BN
  moments, the gradient buckets through ``compression.exchange_buckets``
  (K6e, the packed scalars' all-reduce, the int8 signs' all-reduce, K6d),
  each rank's own residual, the threshold updated on the device from the
  replicas' mean encoded fraction, then one all-reduce of the loss, the
  residuals' squared norms and the float layer states (their mean). A
  skipped (non-finite) step keeps the old residual and threshold too.

The collectives always go through the process group, on the card too: at
world size 1 the trainer starts a one-rank group (NCCL on the card, gloo
only for ``device="cpu"``), so the card runs the code several would. The
byte counters book what the reference books: 0 at one rank.

Not ported yet (ROADMAP queue 1 item 7B): tensor parallelism, ZeRO
(``shard_optimizer_state``), multi-node runs, elastic mesh resizing.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.observability import compile_watch as _cw
from deeplearning4j_tpu_torch.observability import cost_model as _cost
from deeplearning4j_tpu_torch.observability import device_memory as _devmem
from deeplearning4j_tpu_torch.observability import global_registry
from deeplearning4j_tpu_torch.observability import span as _span
from deeplearning4j_tpu_torch.observability.flight_recorder import (
    global_flight_recorder as _flight)
from deeplearning4j_tpu_torch.ops import moments as _moments
from deeplearning4j_tpu_torch.optim import transforms as T
from deeplearning4j_tpu_torch.parallel import compression as _comp
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, ITEM_7B,
                                                    MeshSpec)
from deeplearning4j_tpu_torch.resilience import faults as _faults

log = logging.getLogger("deeplearning4j_tpu_torch")

#: rank r > 0 draws dropout from conf.seed + DROPOUT_STRIDE·r; an
#: indivisible batch's draws, on every rank, from conf.seed − DROPOUT_STRIDE
DROPOUT_STRIDE = 1000003


def _float_leaves(states) -> List[torch.Tensor]:
    return [t for layer in states.values() for t in layer.values()
            if t.is_floating_point()]


class _DenseExchange:
    """The dense exchange: BN moments over the global batch in the
    forward, gradients and loss to their mean over the ranks."""

    def __init__(self, mesh):
        self.mesh = mesh

    def forward(self):
        return _moments.global_batch(self.mesh.group, self.mesh.world_size)

    def reduce(self, loss, new_states, grads):
        *grads, loss = _comp.mean_over(list(grads) + [loss.reshape(1)],
                                       self.mesh.group, self.mesh.world_size)
        return loss[0], new_states, grads, ()

    def commit(self, news):
        pass


class _ReplicatedExchange:
    """An indivisible batch, whole on every rank (the reference replicates
    it): dropout draws from a generator seeded alike on every rank (the
    reference's one mask), the moments are each rank's own (the whole
    batch), and the gradients, the loss and the float layer states go to
    their mean over the ranks, so every rank takes the same step whatever
    its kernels round."""

    def __init__(self, trainer):
        self.trainer = trainer

    @contextlib.contextmanager
    def forward(self):
        net, gen = self.trainer.net, self.trainer._replica_gen
        own, net._gen = net._gen, (gen if gen is not None else net._gen)
        try:
            yield
        finally:
            net._gen = own

    def reduce(self, loss, new_states, grads):
        mesh = self.trainer.mesh
        keys = [(k, p) for k, layer in new_states.items()
                for p, t in layer.items() if t.is_floating_point()]
        states = [new_states[k][p] for k, p in keys]
        means = _comp.mean_over(list(grads) + [loss.reshape(1)] + states,
                                mesh.group, mesh.world_size)
        ng = len(grads)
        new_states = {k: dict(layer) for k, layer in new_states.items()}
        for (k, p), t in zip(keys, means[ng + 1:]):
            new_states[k][p] = t
        return means[ng][0], new_states, means[:ng], ()

    def commit(self, news):
        pass


class _CompressedExchange:
    """The compressed exchange of one step (see the module docstring)."""

    def __init__(self, trainer):
        self.trainer = trainer
        self._old = None
        self._new = None

    def forward(self):
        return contextlib.nullcontext()

    def reduce(self, loss, new_states, grads):
        tr = self.trainer
        mesh, layout, algo = tr.mesh, tr._comp_layout, tr._compression
        n = mesh.world_size
        comp = tr.net._grad_compression_state
        old_res, old_thr = comp["residual"], comp["threshold"]
        spare = tr._comp_spare
        buckets = _comp.flatten_buckets(grads, layout)
        out = _comp.exchange_buckets(
            buckets, [r[0] for r in old_res], old_thr, mesh.group, n,
            decoded=buckets, new_residuals=[s[0] for s in spare])
        new_thr = [algo.update(t, e.frac) for t, e in zip(old_thr, out)]
        floats = _float_leaves(new_states)
        nb = layout.n_buckets
        tail = torch.empty(1 + nb + sum(t.numel() for t in floats),
                           dtype=torch.float32, device=loss.device)
        tail[0] = loss
        for i, e in enumerate(out):
            tail[1 + i] = e.res_sq
        if floats:
            tail[1 + nb:] = torch.cat([t.reshape(-1).float() for t in floats])
        _comp.all_reduce(tail, mesh.group)
        off = 1 + nb
        for t in floats:
            t.copy_((tail[off:off + t.numel()] / n).view(t.shape))
            off += t.numel()
        total = layout.total_elements()
        frac = sum(e.frac * (size / total)
                   for e, size in zip(out, layout.bucket_sizes))
        self.stats = {"encoded_fraction": frac,
                      "residual_norm": torch.sqrt(tail[1:1 + nb].sum())}
        self._old = (old_res, old_thr)
        self._new = (spare, new_thr)
        grads = _comp.unflatten_buckets(buckets, layout)
        return ((tail[0] / n), new_states, grads,
                ((spare, old_res), (new_thr, old_thr)))

    def commit(self, news):
        tr = self.trainer
        res, thr = news
        if res is self._new[0]:
            # the step was kept: the old residual buffers become the spare
            tr._comp_spare = self._old[0]
        comp = tr.net._grad_compression_state
        comp["residual"], comp["threshold"] = res, thr
        tr._pending_comp_stats.append(self.stats)


class ShardedTrainer:
    """Train a MultiLayerNetwork/ComputationGraph data-parallel over the
    process group's ranks (one GPU each). The wrapped net keeps its API;
    this class drives its steps with the exchange in between."""

    def __init__(self, net, mesh_spec: Optional[MeshSpec] = None,
                 devices=None, tensor_parallel: bool = False,
                 shard_optimizer_state: bool = False,
                 preemption_handler=None, checkpoint_dir: Optional[str] = None,
                 grad_compression=None):
        if tensor_parallel:
            raise NotImplementedError(
                f"tensor_parallel=True is not ported yet: {ITEM_7B}")
        if shard_optimizer_state:
            raise NotImplementedError(
                f"shard_optimizer_state=True (ZeRO) is not ported yet: "
                f"{ITEM_7B}")
        if _mesh.world_from_env() != int(os.environ.get(
                "LOCAL_WORLD_SIZE", _mesh.world_from_env())):
            # the reference's several hosts: ranks on one node are the
            # port's analogue of its single-process mesh
            raise NotImplementedError(
                f"a process group across several nodes is not ported yet: "
                f"{ITEM_7B}")
        self.net = net
        self._mesh_spec = mesh_spec or MeshSpec.data_parallel()
        self.mesh = self._mesh_spec.build(devices, device=net.device)
        #: a ThresholdAlgorithm / spec string / True enables the compressed
        #: exchange; None defers to DL4J_TPU_GRAD_COMPRESS; its "0" is the
        #: kill switch either way. Resolved at placement (read live)
        self.grad_compression = grad_compression
        self._compression = None
        self._comp_layout = None
        self._comp_spare = None
        self._comp_obs = None
        self._pending_comp_stats = []
        self._comp_fallback_warned = False
        self.preemption_handler = preemption_handler
        self.checkpoint_dir = checkpoint_dir
        self._placed = False
        self._grad_bytes = 0
        self._collective_bytes = {}
        self._fallback_bytes = {}
        self._collective_counters = {}
        self._obs = None
        self._dense = _DenseExchange(self.mesh)
        self._replicated = _ReplicatedExchange(self)
        self._replica_gen = None

    # ------------------------------------------------------------------ setup
    def _broadcast_from_rank0(self):
        """Every rank starts from rank 0's params, states and updater
        state."""
        import torch.distributed as dist
        net = self.net
        tensors = [t for _, layer in sorted(net._params.items())
                   for _, t in sorted(layer.items())]
        tensors += [t for _, layer in sorted(net._states.items())
                    for _, t in sorted(layer.items())]
        tensors += [t for t in T.state_leaves(net._opt_state)
                    if isinstance(t, torch.Tensor)]
        for t in tensors:
            dist.broadcast(t, src=0, group=self.mesh.group)

    def _place(self):
        net = self.net
        if not net._initialized:
            net.init()
        if net._opt_state is None or net._iteration == 0:
            # fresh net: the reference re-initializes the updater state
            net._opt_state = net._opt.init(net._leaves())
        n_data = _mesh.axis_size(self.mesh, DATA_AXIS)
        if n_data > 1:
            self._broadcast_from_rank0()
            if self.mesh.rank > 0:
                # distinct dropout draws on each rank (the reference's
                # global mask, held by distribution)
                net._gen.manual_seed(int(net.conf.seed)
                                     + DROPOUT_STRIDE * self.mesh.rank)
            # an indivisible batch's draws: alike on every rank
            self._replica_gen = torch.Generator(device=net._gen.device)
            self._replica_gen.manual_seed(int(net.conf.seed)
                                          - DROPOUT_STRIDE)
        param_bytes = sum(t.numel() * t.element_size()
                          for t in net._leaves())
        self._grad_bytes = param_bytes if n_data > 1 else 0
        self._resolve_compression(n_data)
        self._fallback_bytes = {}
        if n_data > 1 and self._compression is not None:
            self._collective_bytes = {
                "compressed_allreduce":
                    _comp.payload_bytes(self._comp_layout, n_data)}
            self._fallback_bytes = {"allreduce": param_bytes}
        elif n_data > 1:
            self._collective_bytes = {"allreduce": param_bytes}
        else:
            self._collective_bytes = {}
        reg = global_registry()
        bytes_c = reg.counter(
            "dl4j_collective_bytes_total",
            "bytes moved per collective op (gradient allreduce payload = "
            "param bytes x steps; ZeRO mode splits into reduce-scatter + "
            "all-gather wire bytes)",
            label_names=("collective",))
        expected_g = reg.gauge(
            "dl4j_collective_expected_bytes",
            "analytic per-step traffic expectation of each collective the "
            "sharded train step fuses (compare against the cost model's "
            "bytes accessed on /debug/perf)",
            label_names=("collective",))
        self._collective_counters = {}
        for op in {**self._fallback_bytes, **self._collective_bytes}:
            self._collective_counters[op] = bytes_c.labels(collective=op)
        for op, nbytes in self._collective_bytes.items():
            expected_g.labels(collective=op).set(nbytes)
        self._obs = (
            reg.histogram("dl4j_collective_step_seconds",
                          "wall time of the sharded train step (compute + "
                          "fused gradient allreduce)",
                          label_names=("collective",)).labels(
                              collective="allreduce"),
            reg.gauge("dl4j_mesh_devices", "devices in the active mesh",
                      label_names=("axis",)))
        for axis in self.mesh.axis_names:
            self._obs[1].labels(axis=str(axis)).set(
                _mesh.axis_size(self.mesh, axis))
        cm = _cost.global_cost_model()
        cm.set_scale("ShardedTrainer.step", self.mesh.size)
        cm.note_collectives("ShardedTrainer.step", self._collective_bytes)
        if self._compression is not None:
            payload = _comp.payload_bytes(self._comp_layout, n_data)
            dense = _comp.dense_bytes(self._comp_layout)
            ratio = dense / max(1, payload)
            reg.gauge(
                "dl4j_grad_compression_ratio",
                "dense gradient bytes / encoded wire payload bytes of the "
                "compressed exchange (sign-mask int8 + per-bucket scale)"
            ).set(ratio)
            self._comp_obs = (
                reg.gauge(
                    "dl4j_grad_compression_sparsity_ratio",
                    "fraction of gradient elements whose magnitude cleared "
                    "the threshold in the last synced compressed step "
                    "(the reference's 'sparsity ratio')"),
                reg.histogram(
                    "dl4j_grad_residual_norm",
                    "global L2 norm of the error-feedback residual after "
                    "each compressed step (mass deferred to later steps)"))
            cm.note_compression("ShardedTrainer.step", {
                **self._compression.describe(),
                "buckets": list(zip(self._comp_layout.bucket_dtypes,
                                    self._comp_layout.bucket_sizes)),
                "wire_payload_bytes": payload,
                "dense_bytes": dense,
                "compression_ratio": ratio,
            })
        cm.invalidate("ShardedTrainer.step")
        _cw.note_cause("sharded_placement",
                       mesh_axes=",".join(str(a)
                                          for a in self.mesh.axis_names))
        _devmem.sample()
        self._placed = True

    # ------------------------------------------------- compressed exchange
    def _resolve_compression(self, n_data: int):
        """The builder arg + env knob → the active algorithm, and the
        error-feedback state seeded or restored. Runs at every placement,
        so the kill switch works live."""
        self._compression = None
        algo = _comp.resolve_compression(self.grad_compression)
        reason = (None if algo is None
                  else self._compression_unsupported_reason())
        if algo is None or reason is not None:
            if reason is not None:
                log.warning("gradient compression requested but %s; using "
                            "the dense exchange", reason)
            if getattr(self.net, "_grad_compression_state", None) is not None:
                log.warning("dropping carried gradient-compression state "
                            "(dense exchange in force; re-enabling later "
                            "re-seeds the residual at zero)")
                self.net._grad_compression_state = None
            return
        self._compression = algo
        self._comp_layout = _comp.build_layout(self.net._leaves())
        self._init_comp_state(n_data)

    def _compression_unsupported_reason(self) -> Optional[str]:
        if DATA_AXIS not in self.mesh.axis_names:
            return "the mesh has no data axis to exchange over"
        for axis in self.mesh.axis_names:
            if axis != DATA_AXIS and _mesh.axis_size(self.mesh, axis) > 1:
                return (f"the mesh shards over {axis!r} too (threshold "
                        "collectives are data-parallel only)")
        if getattr(self.net.conf, "backprop_type", None) == "tbptt":
            return ("TBPTT carries cross jitted-step boundaries (the "
                    "compressed step has no carry slot)")
        return None

    def _init_comp_state(self, n_data: int):
        """This rank's residual rows and the thresholds, on the device, on
        the net (the checkpoint unit: ``gradCompression.npz``). A
        global-form state (restored) hands each rank its row, or is
        reshaped to this replica count."""
        layout, dev, rank = self._comp_layout, self.mesh.device, self.mesh.rank
        state = getattr(self.net, "_grad_compression_state", None)
        if (isinstance(state, dict) and state.get("world") == n_data
                and state.get("rank") == rank
                and [r.shape[1] for r in state["residual"]]
                == list(layout.bucket_sizes)):
            rows, thr = state["residual"], state["threshold"]
        else:
            if isinstance(state, dict) and "world" in state:
                # a placed state of another mesh: its global form first
                state = _comp.state_from_arrays(_comp.state_to_arrays(state))
            if not _comp.state_matches(state, layout, n_data):
                if state is not None:
                    reshaped, mode = _comp.reshape_state(state, layout,
                                                         n_data)
                    if reshaped is not None:
                        log.warning(
                            "gradient-compression state was written on a "
                            "%d-replica mesh, restoring onto %d replicas: "
                            "residuals %s (replica-keyed state cannot "
                            "survive a reshape byte-exactly), thresholds "
                            "kept", int(state["residual"][0].shape[0]),
                            n_data, mode)
                        state = reshaped
                    else:
                        log.warning(
                            "restored gradient-compression state does not "
                            "match the current layout; re-seeding the "
                            "residual at zero")
                        state = _comp.init_state(layout, self._compression,
                                                 n_data)
                else:
                    state = _comp.init_state(layout, self._compression,
                                             n_data)
            rows = [torch.as_tensor(r)[rank:rank + 1].to(
                dev, torch.float32).clone() for r in state["residual"]]
            thr = [torch.as_tensor(t).to(dev, torch.float32).reshape(())
                   .clone() for t in state["threshold"]]
        self.net._grad_compression_state = {
            "residual": rows, "threshold": thr, "rank": rank,
            "world": n_data, "group": self.mesh.group}
        self._comp_spare = [torch.empty_like(r) for r in rows]

    def _publish_comp_stats(self, pend=None):
        """Materialize deferred compression scalars (encoded fraction,
        residual norm), only at the sync points the deferred-score cadence
        already pays for."""
        if pend is None:
            pend, self._pending_comp_stats = self._pending_comp_stats, []
        if not pend or self._comp_obs is None:
            return
        spars_g, res_h = self._comp_obs
        last = None
        for s in pend:
            last = float(s["encoded_fraction"])
            res_h.observe(float(s["residual_norm"]))
        spars_g.set(last)
        _cost.global_cost_model().note_compression(
            "ShardedTrainer.step", {"encoded_fraction_last": last})

    # ---------------------------------------------------------------- shards
    def _split(self, a, sharded: bool):
        if a is None or not sharded:
            return a
        if isinstance(a, (tuple, list)):
            return type(a)(self._split(e, sharded) for e in a)
        b = a.shape[0] // self.mesh.world_size
        r = self.mesh.rank
        return a[r * b:(r + 1) * b]

    def _shardable(self, inputs) -> bool:
        first = inputs[0] if inputs else None
        n = self.mesh.world_size
        return (first is not None and hasattr(first, "shape")
                and len(first.shape) > 0 and first.shape[0] % n == 0)

    def _shard_batch(self, args):
        """(inputs, labels, fmasks, lmasks) → this rank's part, and whether
        it is a shard (else the whole batch, replicated)."""
        sharded = self._shardable(args[0])
        if not sharded and self._compression is not None \
                and not self._comp_fallback_warned:
            self._comp_fallback_warned = True
            log.warning(
                "batch of %s examples is not divisible by the %d-way data "
                "axis; falling back to the dense exchange for such batches",
                getattr(args[0][0], "shape", ("?",))[0],
                self.mesh.world_size)
        return tuple(self._split(a, sharded) for a in args), sharded

    def _placement(self, ds):
        """The prefetch thread's host-side placement: this rank's rows of
        a batch, before its copy to the card."""
        import copy
        args = self.net._ds_args(ds)
        sharded = self._shardable(args[0])
        out = copy.copy(ds)
        for field in ("features", "labels", "features_mask", "labels_mask",
                      "features_masks", "labels_masks"):
            if getattr(out, field, None) is not None:
                setattr(out, field, self._split(getattr(out, field),
                                                sharded))
        out._dp_sharded = sharded
        return out

    # ------------------------------------------------------------------ train
    def _active_preemption_handler(self):
        if self.preemption_handler is not None:
            return self.preemption_handler
        from deeplearning4j_tpu_torch.utils.preemption import (
            PreemptionHandler)
        return PreemptionHandler._installed

    def _check_preemption(self):
        """Batch-boundary preemption latch: checkpoint (rank 0 writes; with
        a compression state over several ranks every rank joins its
        gather) and unwind."""
        handler = self._active_preemption_handler()
        if handler is None or not handler.preempted:
            return
        from deeplearning4j_tpu_torch.utils.preemption import (
            PreemptionSafeListener, TrainingPreempted)
        path = None
        if self.checkpoint_dir is not None:
            path = os.path.join(
                self.checkpoint_dir,
                PreemptionSafeListener.FINAL_NAME.format(
                    model=type(self.net).__name__))
            if self.mesh.rank == 0:
                from deeplearning4j_tpu_torch.utils.serialization import (
                    save_model_atomic)
                os.makedirs(self.checkpoint_dir, exist_ok=True)
                save_model_atomic(self.net, path)
            elif getattr(self.net, "_grad_compression_state", None):
                _comp.state_to_arrays(self.net._grad_compression_state)
        raise TrainingPreempted(path or "<no checkpoint_dir configured>",
                                self.net._iteration,
                                checkpoint_ready=(path is not None
                                                  and self.mesh.rank == 0))

    def fit(self, data, labels=None, epochs: int = 1):
        """The wrapped net's fit surface, data-parallel: under a root
        ``fit`` span and armed on the flight recorder (a wedged collective
        dumps a postmortem bundle)."""
        with _flight().arm("fit:ShardedTrainer"), \
                _span("fit", model=type(self.net).__name__, sharded=True,
                      epochs=epochs):
            return self._fit_impl(data, labels, epochs)

    def _fit_impl(self, data, labels=None, epochs: int = 1):
        if not self._placed:
            self._place()
        net = self.net
        if labels is not None:
            self._fit_batch(net._xy_args(data, labels))
            self._check_preemption()
            return self
        if hasattr(data, "features"):
            self._fit_batch(net._ds_args(data))
            self._check_preemption()
            return self
        from deeplearning4j_tpu_torch.data.iterators import (
            DevicePrefetchIterator)
        wrapped = DevicePrefetchIterator.wrap(data, device=self.mesh.device,
                                              placement=self._placement)
        we_wrapped, data = wrapped is not data, wrapped
        try:
            for _ in range(epochs):
                for lst in net._listeners:
                    lst.on_epoch_start(net, net._epoch)
                if hasattr(data, "reset"):
                    data.reset()
                for ds in data:
                    self._fit_batch(net._ds_args(ds),
                                    getattr(ds, "_dp_sharded", None))
                    self._check_preemption()
                # the epoch end is a sync point (the deferred loss and the
                # compression scalars)
                net._sync_score()
                self._publish_comp_stats()
                for lst in net._listeners:
                    lst.on_epoch_end(net, net._epoch)
                net._epoch += 1
        finally:
            if we_wrapped:
                data.close()
        return self

    def _fit_batch(self, args, sharded=None):
        """One step of the wrapped net with the exchange in between:
        ``args`` are its (inputs, labels, fmasks, lmasks); ``sharded``
        says they are already this rank's part (a shard, or the whole
        indivisible batch), None that they are the global batch."""
        if _faults.armed():
            # the collective path's chaos point: before any rank's step
            _faults.check("allreduce")
        if sharded is None:
            args, sharded = self._shard_batch(args)
        net = self.net
        compressed = self._compression is not None and sharded
        if compressed:
            exchange = _CompressedExchange(self)
            books = self._collective_bytes
        else:
            exchange = self._dense if sharded else self._replicated
            books = (self._fallback_bytes if self._compression is not None
                     else self._collective_bytes)
        t0 = time.perf_counter()
        net._cost_fn_name = "ShardedTrainer.step"
        net._grad_exchange = exchange
        try:
            with _span("sharded_step", compressed=compressed,
                       grad_bytes=books.get(
                           "compressed_allreduce" if compressed
                           else "allreduce", 0)):
                net._fit_batch(*args)
        finally:
            net._grad_exchange = None
            net._cost_fn_name = None
        if compressed:
            if net._pending_score is None:
                self._publish_comp_stats()       # the step synced
            elif len(self._pending_comp_stats) >= 64:
                old, self._pending_comp_stats = (
                    self._pending_comp_stats[:32],
                    self._pending_comp_stats[32:])
                self._publish_comp_stats(old)
        if self._obs is not None:
            for op, nbytes in books.items():
                self._collective_counters[op].inc(nbytes)
            self._obs[0].observe(time.perf_counter() - t0)

    # --------------------------------------------------------------- inference
    def output(self, x):
        if not self._placed:
            self._place()
        return self.net.output(x)

    def score(self):
        score = self.net._sync_score()
        self._publish_comp_stats()
        return score


class ParallelWrapper:
    """Single-node data-parallel facade (ref: ``ParallelWrapper``): the
    ranks of the process group form a ``data`` mesh and every step is the
    averaged step, so ``averaging_frequency`` is accepted for API parity
    and ignored, as in the reference."""

    def __init__(self, model, workers: Optional[int] = None,
                 prefetch_buffer: int = 2, averaging_frequency: int = 1,
                 report_score_after_averaging: bool = True):
        self._trainer = ShardedTrainer(model,
                                       MeshSpec.data_parallel(workers or -1))
        self.model = model

    @staticmethod
    def builder(model):
        return _PWBuilder(model)

    def fit(self, data, labels=None, epochs: int = 1):
        return self._trainer.fit(data, labels, epochs)

    def shutdown(self):
        pass


class _PWBuilder:
    """ref: ParallelWrapper.Builder fluent API."""

    def __init__(self, model):
        self._model = model
        self._workers = None
        self._prefetch = 2
        self._avg_freq = 1

    def workers(self, n: int):
        self._workers = n
        return self

    def prefetch_buffer(self, n: int):
        self._prefetch = n
        return self

    prefetchBuffer = prefetch_buffer

    def averaging_frequency(self, n: int):
        self._avg_freq = n
        return self

    averagingFrequency = averaging_frequency

    def build(self) -> ParallelWrapper:
        return ParallelWrapper(self._model, self._workers, self._prefetch,
                               self._avg_freq)
