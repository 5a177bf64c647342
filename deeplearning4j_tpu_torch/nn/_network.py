"""The runtime that ``MultiLayerNetwork`` and ``ComputationGraph`` share.

The JAX package's two network classes carry the same param API, fit
loop, deferred score, numerics and accounting twice
(``nn/multilayer.py``, ``nn/graph.py``); here they live once and each
network supplies its forward and loss.

The reference compiles each train step into one donated XLA program. The
port runs it eagerly: autograd for the gradients, then the optimizer
chain under ``torch.no_grad()`` (``nn/_step_tail.py``). The loss stays on
the device; the fit loop fetches it only where a listener, the score
cadence (``async_runtime.score_sync_every``) or an epoch end needs it, so
the host runs ahead of the card instead of waiting on every step.
Compile accounting notes the first run of each step signature
(``compile_watch``), and ``cost_model`` gets an analytic FLOP count
(:func:`layer_flops`) in place of XLA's ``cost_analysis``. ``output``
notes its first run at each input signature under the reference's
``<Net>._output_jit`` (the serving probe: each ``ParallelInference``
bucket is one such signature, and its FLOPs are :meth:`output_cost`).
The train step and ``output`` run inside ``torch.profiler`` ranges of
those names, which a profile capture reads as its per-module times.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch import async_runtime as _async
from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nn import params as _flat
from deeplearning4j_tpu_torch.nn._precision import _cast_float
from deeplearning4j_tpu_torch.nn._step_tail import finish_train_step
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.variational import (
    VariationalAutoencoder)
from deeplearning4j_tpu_torch.observability import compile_watch as _cw
from deeplearning4j_tpu_torch.observability import cost_model as _cost
from deeplearning4j_tpu_torch.observability import numerics as _num
from deeplearning4j_tpu_torch.observability import span as _span
from deeplearning4j_tpu_torch.observability import train_metrics as _tm
from deeplearning4j_tpu_torch.observability.flight_recorder import (
    global_flight_recorder as _flight)
from deeplearning4j_tpu_torch.optim import transforms as T
from deeplearning4j_tpu_torch.resilience import faults as _faults


def grad_transform(conf) -> T.Transform:
    """Gradient clipping or normalization, then the updater (ref:
    BaseOptimizer clipping + BaseMultiLayerUpdater): the chain the JAX
    package's ``_grad_transform`` builds from optax."""
    chain = []
    gn = (conf.grad_normalization or "").lower().replace("_", "")
    t = conf.grad_norm_threshold
    if gn in ("clipelementwiseabsolutevalue",):
        chain.append(T.Clip(t))
    elif gn in ("clipl2perlayer", "clipl2perparamtype"):
        chain.append(T.ClipL2PerLeaf(t))
    elif gn in ("renormalizel2perlayer",):
        chain.append(T.RenormL2PerLeaf())
    elif gn in ("clipl2global", "clipbyglobalnorm"):
        chain.append(T.ClipByGlobalNorm(t))
    chain.append(conf.updater.transform())
    return T.Chain(*chain)


#: gates of each recurrent layer: the column blocks of its W and RW
_GATES = ((L.LSTM, 4), (L.GRU, 3), (L.SimpleRnn, 1))


def _length(in_type: Optional[InputType], t: Optional[int]) -> int:
    """T: ``t``, else the input type's length, else 1 (a step)."""
    if t is not None:
        return t
    known = (in_type is not None and in_type.kind == "rnn"
             and in_type.timeseries_length > 0)
    return in_type.timeseries_length if known else 1


def attention_flops(layer, batch: int, t_q: int, t_k: int) -> int:
    """An attention layer's forward FLOPs: its projections (2 per
    multiply-add) plus 4·N·H·Tq·Tk·hs for the scores and their product
    with V (``RecurrentAttentionLayer``: T steps of one query each)."""
    n = batch
    if isinstance(layer, L.RecurrentAttentionLayer):
        hs = layer.n_heads * layer.head_size
        return (2 * n * t_q * (layer.n_in * layer.n_out + 2 * layer.n_in * hs
                               + 2 * layer.n_out * hs)
                + 4 * n * t_q * t_k * hs)
    if isinstance(layer, L.LearnedSelfAttentionLayer):
        hs = layer.n_heads * layer.head_size
        q = layer.n_queries
        return (2 * n * t_k * 2 * layer.n_in * hs + 2 * n * q * hs * layer.n_out
                + 4 * n * q * t_k * hs)
    if isinstance(layer, L.CrossAttentionLayer):
        hs = layer.n_heads * layer.head_size
        kv, kk = layer._dims()
        return (2 * n * t_q * (layer.n_in + layer.n_out) * hs
                + 2 * n * t_k * (kv + kk) * hs + 4 * n * t_q * t_k * hs)
    if not layer.project_input:        # one head of width n_in
        return 4 * n * t_q * t_k * layer.n_in
    hs = layer.n_heads * layer.head_size
    return (2 * n * t_q * (3 * layer.n_in + layer.n_out) * hs
            + 4 * n * t_q * t_k * hs)


def layer_flops(layer, in_type: Optional[InputType], batch: int,
                t: Optional[int] = None,
                kv_type: Optional[InputType] = None) -> int:
    """Forward FLOPs of one layer's products at ``batch`` (2 per
    multiply-add): a convolution's 2·N·Ho·Wo·kh·kw·Cin·Cout, a dense
    layer's 2·N·n_in·n_out, once per timestep on a time series (the
    ``RnnOutputLayer`` too); a recurrent layer's 2·N·T·(n_in + H)·G·H
    with G its gates (4, 3, 1), twice under ``Bidirectional``; an
    attention layer's :func:`attention_flops` (a cross-attention layer's
    keys as long as ``kv_type``, its second input); the convolution-like
    layers' :func:`conv_flops`; a capsule layer's predictions and routing
    products; a VAE's encoder (its forward emits the posterior mean); a
    wrapper its inner layer's. T is ``t``, else the input type's length,
    else 1 (FLOPs a step). Elementwise work, pooling, normalization and
    embedding gathers count 0."""
    steps = _length(in_type, t)
    if isinstance(layer, (L.SelfAttentionLayer, L.LearnedSelfAttentionLayer,
                          L.RecurrentAttentionLayer)):
        t_k = (_length(kv_type, t) if isinstance(layer, L.CrossAttentionLayer)
               else steps)
        return attention_flops(layer, batch, steps, t_k)
    if isinstance(layer, L.Bidirectional):
        layer._materialize()
        return 2 * layer_flops(layer._fwd_layer, in_type, batch, t)
    if isinstance(layer, L.LastTimeStep):
        layer._materialize()
        return layer_flops(layer._inner_layer, in_type, batch, t)
    for cls, gates in _GATES:
        if isinstance(layer, cls):
            return (2 * batch * steps * (layer.n_in + layer.n_out) * gates
                    * layer.n_out)
    if isinstance(layer, (L.FrozenLayer, L.FrozenLayerWithBackprop,
                          L.MaskZeroLayer)):
        layer._materialize()
        return layer_flops(layer._inner_layer, in_type, batch, t)
    if in_type is not None:
        conv = conv_flops(layer, in_type, batch)
        if conv is not None:
            return conv
    if isinstance(layer, L.CapsuleLayer):
        i, j = layer.input_capsules, layer.capsules
        d, e = layer.capsule_dimensions, layer.input_capsule_dimensions
        return 2 * batch * i * j * d * (e + 2 * layer.routings - 1)
    if isinstance(layer, VariationalAutoencoder):
        sizes = (layer.n_in,) + layer.encoder_layer_sizes
        return (sum(2 * batch * a * b for a, b in zip(sizes, sizes[1:]))
                + 2 * 2 * batch * sizes[-1] * layer.n_out)
    if isinstance(layer, L.DenseLayer):
        per_step = 2 * batch * layer.n_in * layer.n_out
        rnn = isinstance(layer, L.RnnOutputLayer) or (
            in_type is not None and in_type.kind == "rnn")
        return per_step * (steps if rnn else 1)
    return 0


def conv_flops(layer, in_type: InputType, batch: int) -> Optional[int]:
    """A convolution-like layer's forward FLOPs, 2 a multiply-add, from its
    input and output types; None for any other layer. Each output point of
    a convolution (2-D, 1-D, 3-D, locally connected, the primary capsules)
    takes its window · Cin · Cout; a depthwise one its window · m a
    channel, a separable one that plus its 1×1 product; a transposed one
    (2-D, 3-D) each INPUT point's window · Cin · Cout; ConvLSTM2D a step
    its input and recurrent convolutions into the four gates."""
    out = layer.output_type(in_type)
    if isinstance(layer, (L.ConvolutionLayer, L.LocallyConnected2D)):
        kh, kw = layer.kernel_size
        return (2 * batch * out.height * out.width * kh * kw * layer.n_in
                * layer.n_out)
    if isinstance(layer, L.PrimaryCapsules):
        kh, kw = layer.kernel_size
        oh, ow = layer._out_hw()
        return (2 * batch * oh * ow * kh * kw * layer.n_in * layer.channels
                * layer.capsule_dimensions)
    if isinstance(layer, (L.SeparableConvolution2D,
                          L.DepthwiseConvolution2D)):
        kh, kw = layer.kernel_size
        cm = layer.n_in * layer.depth_multiplier
        pw = (cm * layer.n_out
              if isinstance(layer, L.SeparableConvolution2D) else 0)
        return 2 * batch * out.height * out.width * (kh * kw * cm + pw)
    if isinstance(layer, (L.Convolution1DLayer, L.LocallyConnected1D)):
        return (2 * batch * out.timeseries_length * layer.kernel_size
                * layer.n_in * layer.n_out)
    if isinstance(layer, L.SeparableConvolution1D):
        cm = layer.n_in * layer.depth_multiplier
        return (2 * batch * out.timeseries_length
                * (layer.kernel_size * cm + cm * layer.n_out))
    if isinstance(layer, L.Convolution3D):
        return (2 * batch * out.depth * out.height * out.width
                * math.prod(layer.kernel_size) * layer.n_in * layer.n_out)
    if isinstance(layer, L.Deconvolution2D):
        kh, kw = layer.kernel_size
        return (2 * batch * in_type.height * in_type.width * kh * kw
                * layer.n_in * layer.n_out)
    if isinstance(layer, L.Deconvolution3D):
        return (2 * batch * in_type.depth * in_type.height * in_type.width
                * math.prod(layer.kernel_size) * layer.n_in * layer.n_out)
    if isinstance(layer, L.ConvLSTM2D):
        kh, kw = layer.kernel_size
        f = layer.n_out
        return (2 * batch * max(in_type.depth, 1) * out.height * out.width
                * kh * kw * (layer.n_in + f) * 4 * f)
    return None


def train_flops(forward_flops: int) -> int:
    """A train step's FLOPs: the forward and, in the backward, the input
    and weight gradients of every product (3 × forward)."""
    return 3 * forward_flops


class NetworkBase:
    """Params, updater state, the fit loop and evaluation; a subclass
    supplies ``_param_layers`` (the (key, layer) pairs in init order),
    ``_loss_fn``, ``_ds_args``, ``_xy_args``, ``_gradient_args``,
    ``output`` and ``_forward_flops``."""

    def __init__(self, conf, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self._params: _flat.ParamTree = {}
        self._states: Dict[str, Dict[str, torch.Tensor]] = {}
        self._param_shapes: Dict[str, Dict[str, tuple]] = {}
        self._opt = grad_transform(conf)
        self._opt_state = None
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")
        self._pending_score = None   # device-side loss not yet fetched
        self._pending_health = []    # device-side numerics not yet fetched
        #: last published numerics health (floats), listener-visible
        self.last_numerics = None
        #: steps between blocking loss fetches in a deferred fit loop;
        #: None follows DL4J_TPU_SCORE_EVERY live
        self.score_every: Optional[int] = None
        self._listeners = []
        self._frozen: set = set()    # frozen layer keys
        self._last_batch_size = 0
        #: dropout draws: a generator on the network's device
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(conf.seed))
        self._signatures = set()     # step signatures run (compile_watch)
        self._output_signatures = set()   # output() signatures run
        self._signature_lock = threading.Lock()
        #: rnnTimeStep's carries between calls, by layer key
        self._rnn_state: Dict[str, tuple] = {}
        #: the data-parallel exchange of the step being driven (set by
        #: ``parallel.ShardedTrainer``), else None
        self._grad_exchange = None
        #: the compressed exchange's error-feedback state (residuals and
        #: thresholds), checkpointed as ``gradCompression.npz``
        self._grad_compression_state = None
        self._initialized = False

    # ------------------------------------------------------------------ init
    def _param_layers(self):
        raise NotImplementedError

    def init(self):
        """Allocate parameters: weights drawn on the CPU from a generator
        seeded with ``conf.seed``, in init order, then moved to the
        device."""
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        params, states, shapes = {}, {}, {}
        for key, layer in self._param_layers():
            shapes[key] = dict(layer.param_shapes())
            params[key] = layer.init_params(gen) if layer.has_params() else {}
            st = layer.init_state()
            if st:
                states[key] = st
        self._param_shapes = shapes
        self._params = _flat.tree_to_device(params, self.device)
        self._states = _flat.tree_to_device(states, self.device)
        self._opt_state = self._opt.init(self._leaves())
        self._initialized = True
        return self

    def _leaves(self) -> List[torch.Tensor]:
        return [self._params[k][p] for k, p in _flat.leaf_keys(self._params)]

    def _set_leaves(self, keys, leaves):
        out = {k: {} for k in self._params}
        for (k, p), t in zip(keys, leaves):
            out[k][p] = t
        self._params = out

    # ------------------------------------------------------------- param API
    def numParams(self) -> int:
        return _flat.num_params(self._param_shapes)

    def params(self) -> torch.Tensor:
        """The flat parameter vector (a copy; see ``nn/params.py``)."""
        return _flat.flatten_params(self._params, self.device)

    def setParams(self, flat) -> None:
        self._params = _flat.unflatten_params(flat, self._param_shapes,
                                              self.device)

    def paramTable(self) -> Dict[str, torch.Tensor]:
        """{"<layer>_<param>": tensor} in flat order."""
        return {f"{k}_{p}": self._params[k][p]
                for k, p in _flat.leaf_keys(self._params)}

    def param_tree(self):
        return self._params

    def set_param_tree(self, tree):
        """Load a ``{layer: {param: array}}`` tree (numpy or tensors, e.g.
        the JAX package's ``param_tree()`` as numpy): copied, f32, onto
        this network's device."""
        self._params = _flat.tree_to_device(tree, self.device)

    def state_tree(self):
        return self._states

    def set_state_tree(self, tree):
        """Load layer states (BatchNormalization running mean and var)."""
        self._states = _flat.tree_to_device(tree, self.device)

    def updater_state(self):
        """The optimizer state, in ``optim/transforms.py``'s layout."""
        return self._opt_state

    def set_updater_state(self, state):
        self._opt_state = T.map_state(
            lambda t: t.to(self.device, torch.float32).clone(), state)

    def set_updater_state_from_jax(self, opt_state):
        """Load the JAX package's optax state (its arrays as numpy, e.g.
        ``jax.tree.map(np.asarray, ref_net._opt_state)``): the updater
        chains match transform for transform, so the state carries
        across leaf for leaf."""
        self.set_updater_state(T.state_from_optax(opt_state))

    # ---------------------------------------------------------- listener API
    def setListeners(self, *listeners):
        self._listeners = (list(listeners[0]) if len(listeners) == 1
                           and isinstance(listeners[0], (list, tuple))
                           else list(listeners))

    def addListeners(self, *listeners):
        self._listeners.extend(listeners)

    def getListeners(self):
        return self._listeners

    # ------------------------------------------------------------ the step
    def _to_device(self, a):
        return None if a is None else _flat.to_tensor(a, self.device)

    def _regularization_penalty(self, params, named_layers):
        """L1/L2 on weight params only (ref: BaseLayer regularization)."""
        from deeplearning4j_tpu_torch.nn.weightnoise import is_weight_param
        penalty = 0.0
        for key, layer in named_layers:
            l1 = getattr(layer, "l1", None)
            l2 = getattr(layer, "l2", None)
            if not l1 and not l2:
                continue
            for pname, arr in params.get(key, {}).items():
                if not is_weight_param(pname, arr, layer):
                    continue
                if l1:
                    penalty = penalty + l1 * torch.sum(torch.abs(arr))
                if l2:
                    penalty = penalty + 0.5 * l2 * torch.sum(torch.square(arr))
        return penalty

    def _loss_fn(self, params, states, inputs, labels, fmasks, lmasks, gen,
                 carries=None):
        """(loss, new_states, new_carries) of a training forward; with
        ``carries`` (a dict, TBPTT) the recurrent layers start from them
        and ``new_carries`` holds their final carries, else it is None."""
        raise NotImplementedError

    def _value_and_grad(self, inputs, labels, fmasks, lmasks, gen,
                        carries=None):
        """(loss, new_states, new_carries, keys, leaves, grads) at the
        current params; ``grads`` a list in flat order."""
        keys = _flat.leaf_keys(self._params)
        leaves = [self._params[k][p] for k, p in keys]
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, new_states, new_carries = self._loss_fn(
                self._params, self._states, inputs, labels, fmasks, lmasks,
                gen, carries)
            grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
                     if leaves else ())
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return loss.detach(), new_states, new_carries, keys, leaves, grads

    def _train_step(self, inputs, labels, fmasks, lmasks, carries=None):
        """One step; returns (loss, health, new_carries). The carries
        leave detached: gradients stop at a TBPTT chunk's boundary.

        ``_grad_exchange`` (set by ``parallel.ShardedTrainer`` for the
        steps it drives) goes between the gradients and the optimizer:
        ``forward()`` is the context of the forward and backward,
        ``reduce(loss, states, grads)`` gives the exchanged loss, states
        and gradients and the extra ``(new, old)`` trees a skipped step
        keeps the old of, and ``commit`` takes those trees as kept."""
        ex = self._grad_exchange
        with (ex.forward() if ex is not None else contextlib.nullcontext()):
            loss, new_states, new_carries, keys, leaves, grads = \
                self._value_and_grad(inputs, labels, fmasks, lmasks,
                                     self._gen, carries)
        frozen = [k in self._frozen for k, _ in keys]
        with torch.no_grad():
            extra = ()
            if ex is not None:
                loss, new_states, grads, extra = ex.reduce(loss, new_states,
                                                           grads)
            new_leaves, self._opt_state, news, health = \
                finish_train_step(self._opt, leaves, self._opt_state, grads,
                                  loss, frozen,
                                  guarded=((new_states, self._states),)
                                  + tuple(extra))
            new_states = news[0]
            if ex is not None:
                ex.commit(news[1:])
        self._set_leaves(keys, new_leaves)
        self._states = new_states
        if new_carries is not None:
            new_carries = {k: tuple(c.detach() for c in v)
                           for k, v in new_carries.items()}
        return loss, health, new_carries

    def computeGradientAndScore(self, *args, **kwargs):
        """(score, grads): the gradient tree ``{layer: {param: tensor}}``
        at the current params (ref: Model#computeGradientAndScore)."""
        inputs, labels, fmasks, lmasks = self._gradient_args(*args, **kwargs)
        loss, _, _, keys, _, grads = self._value_and_grad(
            inputs, labels, fmasks, lmasks, self._gen)
        tree = {k: {} for k in self._params}
        for (k, p), g in zip(keys, grads):
            tree[k][p] = g
        self._pending_score = None
        self._score = float(loss)
        return self._score, tree

    # ------------------------------------------------------------------- fit
    def _ds_args(self, ds):
        """(inputs, labels, feature masks, label masks) of a (Multi)DataSet."""
        raise NotImplementedError

    def fit(self, data, labels=None, epochs: int = 1):
        """fit(x, y) | fit(DataSet) | fit(iterator[, epochs]).

        The whole call runs under a root ``fit`` span and is armed on the
        flight recorder (no step progress for ``DL4J_TPU_HANG_SECONDS``
        dumps a postmortem bundle)."""
        kind = type(self).__name__
        with _flight().arm(f"fit:{kind}"), _span("fit", model=kind,
                                                   epochs=epochs):
            return self._fit_impl(data, labels, epochs)

    def _fit_impl(self, data, labels=None, epochs: int = 1):
        kind = type(self).__name__
        if labels is not None:
            for _ in range(epochs):
                self._fit_batch(*self._xy_args(data, labels))
            return self
        if hasattr(data, "features"):  # DataSet
            for _ in range(epochs):
                self._fit_batch(*self._ds_args(data))
            return self
        # iterator: pulling the next batch is the step's data_wait; under
        # the async runtime batch k+1's copy to the card overlaps step k
        from deeplearning4j_tpu_torch.data.iterators import (
            DevicePrefetchIterator)
        wrapped = DevicePrefetchIterator.wrap(data, device=self.device)
        we_wrapped, data = wrapped is not data, wrapped
        try:
            for _ in range(epochs):
                for lst in self._listeners:
                    lst.on_epoch_start(self, self._epoch)
                if hasattr(data, "reset"):
                    data.reset()
                it = iter(data)
                while True:
                    t0 = time.perf_counter()
                    with _span("data_wait", model=kind):
                        ds = next(it, None)
                    if ds is None:
                        break
                    self._fit_batch(*self._ds_args(ds),
                                    data_wait=time.perf_counter() - t0)
                # epoch end is a sync point: listeners and score() see
                # this epoch's final loss
                self._sync_score()
                for lst in self._listeners:
                    lst.on_epoch_end(self, self._epoch)
                self._epoch += 1
                _tm.for_model(self).epochs.inc()
        finally:
            if we_wrapped:
                # an exceptional exit must not strand the prefetch thread
                data.close()
        return self

    def _sync_score(self) -> float:
        """Fetch a deferred device-side loss, if any."""
        pend = self._pending_score
        if pend is not None:
            self._pending_score = None
            self._score = float(pend)
        self._drain_numerics()
        return self._score

    def _drain_numerics(self):
        pend, self._pending_health = self._pending_health, []
        if pend:
            _num.publish(self, pend)

    def _note_signature(self, fn, inputs, labels, fmasks, lmasks,
                        carried=False):
        """compile_watch's stand-in for a trace: the first step at each
        (shapes, dtypes, masks, carries, frozen set)."""
        key = (tuple((tuple(x.shape), x.dtype) for x in inputs + labels),
               fmasks is None, lmasks is None, carried,
               frozenset(self._frozen))
        if key in self._signatures:
            return
        self._signatures.add(key)
        _cw.note_trace(fn, inputs, labels, fmasks, lmasks)

    def _note_output_signature(self, inputs, masks):
        """The serving probe, compile_watch's stand-in for a trace of the
        reference's ``_output_jit``: the first ``output`` at each (shapes,
        dtypes, masks). Serving threads call ``output`` concurrently, so
        the check and the add are one step."""
        key = (tuple((tuple(x.shape), x.dtype) for x in inputs),
               None if masks is None else tuple(
                   None if m is None else tuple(m.shape) for m in masks))
        with self._signature_lock:
            if key in self._output_signatures:
                return
            self._output_signatures.add(key)
        _cw.note_trace(f"{type(self).__name__}._output_jit", inputs, masks)

    def _fit_batch(self, inputs, labels, fmasks=None, lmasks=None,
                   data_wait=None):
        if not self._initialized:
            self.init()
        kind = type(self).__name__
        fn = f"{kind}._train_step"
        inputs = tuple(self._to_device(x) for x in inputs)
        labels = tuple(self._to_device(y) for y in labels)
        fmasks = (tuple(self._to_device(m) for m in fmasks if m is not None)
                  or None) if fmasks else None
        lmasks = (tuple(self._to_device(m) for m in lmasks if m is not None)
                  or None) if lmasks else None
        if _faults.armed():
            # chaos injection point, before the step; a nan corruption
            # composes with the numerics skip
            _faults.check("train.step")
            inputs = tuple(self._to_device(v) for v in
                           _faults.corrupt("train.step", inputs))
        batch_n = int(inputs[0].shape[0]) if inputs else 0
        self._last_batch_size = batch_n
        series = [int(x.shape[1]) for x in inputs if x.dim() == 3]
        if getattr(self.conf, "backprop_type", "standard") == "tbptt" \
                and series:
            self._fit_tbptt(inputs, labels, fmasks, lmasks, max(series),
                            data_wait)
            return
        # deferred loss fetch: listeners need a float score every step,
        # otherwise the fetch happens every score_every steps, at epoch
        # end, and on score()
        defer_mode = _async.async_enabled() and not self._listeners
        score_every = (self.score_every if self.score_every is not None
                       else _async.score_sync_every())
        sync_now = (not defer_mode
                    or (self._iteration + 1) % max(1, score_every) == 0)
        self._note_signature(fn, inputs, labels, fmasks, lmasks)
        t0 = time.perf_counter()
        with _span("train_step", model=kind, iteration=self._iteration,
                   batch=batch_n), torch.profiler.record_function(fn):
            loss, health, _ = self._train_step(inputs, labels, fmasks,
                                               lmasks)
            if health is not None:
                self._pending_health.append(_num.stamp_step(health))
            if sync_now:
                # float() waits for the card, so t1 - t0 bounds the
                # dispatch and device time of every step since the last
                # sync
                self._pending_score = None
                self._score = float(loss)
                self._drain_numerics()
            else:
                self._pending_score = loss
                if len(self._pending_health) >= 64:
                    # fit(x, y) loops never reach an epoch end: drain the
                    # OLDER half (long done; fetching the newest would cap
                    # the run-ahead at the backlog)
                    old = self._pending_health[:32]
                    self._pending_health = self._pending_health[32:]
                    _num.publish(self, old)
        t1 = time.perf_counter()
        _cost.on_step(fn, getattr(self, "_cost_fn_name", None) or fn,
                      t1 - t0, lambda: self.step_cost(
                          batch_n, max(series) if series else None))
        self._iteration += 1
        with _span("listeners", model=kind):
            for lst in self._listeners:
                lst.iteration_done(self, self._iteration, self._epoch,
                                   self._score)
        _tm.for_model(self).record_step(
            batch_n, self._score if sync_now else float("nan"), t1 - t0,
            time.perf_counter() - t1, data_wait, pipelined=defer_mode)
        _flight().progress("train_step")

    def _fit_tbptt(self, inputs, labels, fmasks, lmasks, t_total,
                   data_wait=None):
        """Truncated BPTT: the time axis in chunks of
        ``tbptt_fwd_length`` (3-D inputs and labels; masks from 2-D), one
        train step each, the recurrent carries taken into the next chunk
        detached, so gradients stop at chunk boundaries
        (``tbptt_bwd_length`` is not read, as in the reference). The score
        is fetched at every chunk; each chunk is an iteration with its own
        ``train_step_tbptt`` span and listener call; examples and
        ``data_wait`` count at chunk 0 only."""
        kind = type(self).__name__
        fn = f"{kind}._train_step"
        fwd = self.conf.tbptt_fwd_length
        batch_n = self._last_batch_size
        carries = {}
        self._pending_score = None   # TBPTT stays per-chunk synchronous

        def chunk(seq, start, end, min_ndim):
            if seq is None:
                return None
            return tuple(a[:, start:end] if a is not None
                         and a.dim() >= min_ndim else a for a in seq)

        for start in range(0, t_total, fwd):
            end = min(start + fwd, t_total)
            ci, cl = chunk(inputs, start, end, 3), chunk(labels, start, end, 3)
            fm = chunk(fmasks, start, end, 2)
            lm = chunk(lmasks, start, end, 2)
            self._note_signature(fn, ci, cl, fm, lm, carried=bool(carries))
            t0 = time.perf_counter()
            with _span("train_step_tbptt", model=kind,
                       iteration=self._iteration, t_start=start):
                loss, health, carries = self._train_step(ci, cl, fm, lm,
                                                         carries)
                self._score = float(loss)
                if health is not None:          # per-chunk synchronous
                    self._pending_health.append(_num.stamp_step(health))
                    self._drain_numerics()
            t1 = time.perf_counter()
            _cost.on_step(fn, getattr(self, "_cost_fn_name", None) or fn,
                          t1 - t0, lambda n=end - start: self.step_cost(
                              batch_n, n))
            self._iteration += 1
            for lst in self._listeners:
                lst.iteration_done(self, self._iteration, self._epoch,
                                   self._score)
            # examples (and data_wait) count once a batch: every chunk
            # sees the same examples
            _tm.for_model(self).record_step(
                batch_n if start == 0 else 0, self._score, t1 - t0,
                time.perf_counter() - t1, data_wait if start == 0 else None)
            _flight().progress("train_step")

    # ------------------------------------------------------- rnn streaming
    def rnnClearPreviousState(self):
        """Forget the carries ``rnnTimeStep`` kept: the next call starts
        from zero carries."""
        self._rnn_state = {}

    def rnnGetPreviousState(self, key):
        """The carries ``rnnTimeStep`` kept for a layer (its index in a
        ``MultiLayerNetwork``, its name in a ``ComputationGraph``), or
        None."""
        return self._rnn_state.get(str(key))

    # ------------------------------------------------------- accounting
    def _forward_flops(self, batch: int, t: Optional[int] = None) -> int:
        raise NotImplementedError

    def step_cost(self, batch: int, t: Optional[int] = None):
        """Analytic (FLOPs, bytes) of one train step at ``batch`` (and
        ``t`` timesteps, where the net takes a time series): FLOPs by
        :func:`train_flops`; bytes as every param, its gradient and the
        updater state read and written once in f32 (a floor: activations'
        traffic is not counted)."""
        n = self.numParams()
        n_state = sum(a.numel() for a in T.state_leaves(self._opt_state)
                      if isinstance(a, torch.Tensor))
        return (float(train_flops(self._forward_flops(batch, t))),
                float(4 * (3 * n + 2 * n_state)))

    def output_cost(self, batch: int, x=None):
        """Analytic (FLOPs, bytes) of one ``output`` at ``batch`` rows, the
        serving bucket's count: the forward's products (:func:`layer_flops`)
        and every param read once in f32 plus the input ``x`` (a floor:
        activations' traffic is not counted)."""
        nbytes = 0 if x is None else int(getattr(x, "nbytes", 0))
        return (float(self._forward_flops(batch)),
                float(4 * self.numParams() + nbytes))

    # ----------------------------------------------------------- inference
    def score(self, dataset=None) -> float:
        """Last minibatch score, or the score of a DataSet (no dropout)."""
        if dataset is None:
            return self._sync_score()
        inputs, labels, _, _ = self._ds_args(dataset)
        with torch.no_grad():
            loss, _, _ = self._loss_fn(
                self._params, self._states,
                tuple(self._to_device(x) for x in inputs),
                tuple(self._to_device(y) for y in labels), None, None, None)
        return float(loss)

    def _eval_with(self, ev, iterator, masked=False):
        """Feed ``ev`` the first output and first labels of every batch of
        ``iterator`` (the label mask too where ``masked``)."""
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            inputs, labels, _, _ = self._ds_args(ds)
            out = self.output(*inputs)
            if isinstance(out, tuple):
                out = out[0]
            if masked:
                ev.eval(labels[0], out, mask=getattr(ds, "labels_mask", None))
            else:
                ev.eval(labels[0], out)
        return ev

    def evaluate(self, iterator):
        """Classification evaluation over an iterator (ref: #evaluate)."""
        from deeplearning4j_tpu_torch.eval.classification import Evaluation
        return self._eval_with(Evaluation(), iterator, masked=True)

    def evaluateROC(self, iterator, threshold_steps: int = 0):
        """ref: #evaluateROC (binary outputs); ``threshold_steps`` is taken
        for the reference's signature: the ROC is exact-threshold."""
        from deeplearning4j_tpu_torch.eval.classification import ROC
        return self._eval_with(ROC(), iterator)

    def evaluateROCMultiClass(self, iterator, threshold_steps: int = 0):
        """ref: #evaluateROCMultiClass (one-vs-all, exact thresholds)."""
        from deeplearning4j_tpu_torch.eval.classification import (
            ROCMultiClass)
        return self._eval_with(ROCMultiClass(), iterator)

    def evaluateRegression(self, iterator):
        """ref: #evaluateRegression."""
        from deeplearning4j_tpu_torch.eval.regression import (
            RegressionEvaluation)
        return self._eval_with(RegressionEvaluation(), iterator)

    # ---------------------------------------------------------- persistence
    def save(self, path, save_updater: bool = True):
        """Write the net as a zip in the JAX package's layout
        (``utils/serialization.py``): each tensor copied to the host once."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer)
        ModelSerializer.write_model(self, path, save_updater)

    def predict(self, *inputs) -> torch.Tensor:
        """Argmax class predictions (ref: #predict)."""
        out = self.output(*inputs)
        if isinstance(out, tuple):
            out = out[0]
        return torch.argmax(out, dim=-1)

    def getIterationCount(self) -> int:
        return self._iteration

    def getEpochCount(self) -> int:
        return self._epoch


def as_tuple(x) -> tuple:
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def with_weight_noise(layer, lp, training, gen):
    """``lp`` as the layer's training forward sees it: under its
    ``weight_noise`` (DropConnect, WeightNoise) when training with a
    generator, else as it is (the reference's forward walks)."""
    wn = getattr(layer, "weight_noise", None)
    if wn is None or not training or gen is None:
        return lp
    return wn.apply(lp, gen, layer=layer)


def run_recurrent(layer, lp, h, carries, key, training, gen, mask):
    """(output, final carry) of the recurrent ``layer`` started from
    ``carries[key]`` (zero carries where missing: TBPTT's first chunk,
    streaming's first call); the final carry is cast back to the dtype of
    the one it started from, so the carries keep their dtype across
    chunks (the reference's ``recast_like``)."""
    carry0 = carries.get(key)
    if carry0 is None:
        carry0 = layer.carry_for(h)
    out, carry = layer.run(lp, layer._maybe_dropout(h, training, gen),
                           carry0, mask=mask)
    return out, tuple(_cast_float(c, c0.dtype)
                      for c, c0 in zip(carry, carry0))


def remat_apply(layer, lp, x, state, gen, kwargs, policy_name=None):
    """``layer.apply`` in training, its activations recomputed in the
    backward (``nn/_remat.py``). Dropout draws repeat in the recompute:
    each run starts from the generator state of the first, and the
    recompute leaves the generator where it found it."""
    from deeplearning4j_tpu_torch.nn._remat import remat
    start = gen.get_state() if gen is not None else None
    runs = []

    def run(h):
        if gen is not None:
            now = gen.get_state()
            gen.set_state(start)
        out, st = layer.apply(lp, h, training=True, gen=gen, state=state,
                              **kwargs)
        if gen is not None and runs:
            gen.set_state(now)
        runs.append(1)
        return out, st

    return remat(run, policy_name)(x)
