"""MultiLayerNetwork: the sequential-network runtime.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` (the reference's
``org.deeplearning4j.nn.multilayer.MultiLayerNetwork``). The param API,
the fit loop, the deferred score and the numerics live in
``nn/_network.py``; this class walks the layer stack.

Mixed precision (``data_type="bfloat16"``): hidden layers compute in
bf16; the final layer, the loss, the master weights, the updater state
and the running statistics stay f32, and states are cast back to their
stored dtype after each step.

Recurrent layers run from carries where the caller keeps them: truncated
BPTT (``backprop_type("tbptt")``, ``nn/_network.py``'s ``_fit_tbptt``) and
``rnnTimeStep`` streaming; the carries stay f32 under the bf16 policy.

``pretrain`` / ``pretrainLayer`` train a pretrainable layer (the
``VariationalAutoencoder``) on its own loss, upstream layers in
inference. ``save`` / ``load`` go through ``utils/serialization.py``;
``evaluateROC*`` and ``evaluateRegression`` live in ``nn/_network.py``.
"""
from __future__ import annotations

from typing import List

import torch

from deeplearning4j_tpu_torch.nn._network import (NetworkBase, layer_flops,
                                                  remat_apply, run_recurrent,
                                                  with_weight_noise)
from deeplearning4j_tpu_torch.nn._precision import (_COMPUTE_DTYPES,
                                                    _cast_float, cast_params,
                                                    recast_like)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)

#: layers handed the input's sequence mask, as the reference's list: the
#: mask is handed on unchanged even after a ``LearnedSelfAttentionLayer``
#: has made the time axis ``n_queries`` long (ROADMAP queue 3)
_MASK_AWARE = (L._RnnBase, L.Bidirectional, L.LastTimeStep,
               L.SelfAttentionLayer, L.GlobalPoolingLayer,
               L.LearnedSelfAttentionLayer, L.RecurrentAttentionLayer)


def _maybe_unflatten_input(x, input_type):
    """A ``convolutional_flat`` input type means callers feed (N, H*W*C)
    rows that conv stacks consume as NHWC."""
    if input_type is not None and input_type.kind == "cnn_flat" and x.dim() == 2:
        return x.reshape(x.shape[0], input_type.height, input_type.width,
                         input_type.channels)
    return x


class MultiLayerNetwork(NetworkBase):
    """Sequential net: init → fit/output/evaluate. It lives on the card
    unless ``device="cpu"``."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__(conf, device)
        self.layers: List[L.Layer] = conf.layers

    def _param_layers(self):
        return [(str(i), layer) for i, layer in enumerate(self.layers)]

    def getParam(self, key: str) -> torch.Tensor:
        lidx, pname = key.split("_", 1)
        return self._params[lidx][pname]

    # --------------------------------------------------------------- forward
    def _forward(self, params, states, x, training, gen, mask=None,
                 collect=False, up_to=None, carries=None):
        """Run the layer stack; returns (final activation | activation
        list, new_states, new_carries). With ``carries`` (a dict by layer
        key: TBPTT, streaming) the recurrent layers start from theirs (zero
        where missing) and ``new_carries`` holds their final ones."""
        acts = []
        new_states = dict(states)
        new_carries = {}
        h = _maybe_unflatten_input(x, self.conf.input_type)
        batch_n = x.shape[0]
        preprocs = self.conf.input_pre_processors or {}
        n_layers = len(self.layers) if up_to is None else up_to
        cdtype = _COMPUTE_DTYPES.get(getattr(self.conf, "dtype", "float32"))
        last_idx = len(self.layers) - 1
        if cdtype is not None:
            h = _cast_float(h, cdtype)
        for i, layer in enumerate(self.layers[:n_layers]):
            if i in preprocs:
                h = preprocs[i].pre_process(h, batch_size=batch_n)
            lkey = str(i)
            lp = params.get(lkey, {})
            if cdtype is not None and i < last_idx:
                lp = cast_params(lp, cdtype)
            elif cdtype is not None:
                h = _cast_float(h, torch.float32)   # final layer in f32
            lp = with_weight_noise(layer, lp, training, gen)
            lst = states.get(lkey)
            kwargs = {}
            if mask is not None and isinstance(layer, _MASK_AWARE):
                kwargs["mask"] = mask
            st = None
            if isinstance(layer, L._RnnBase) and carries is not None:
                h, new_carries[lkey] = run_recurrent(
                    layer, lp, h, carries, lkey, training, gen, mask)
            elif training and getattr(self.conf, "remat", False) \
                    and i < last_idx:
                h, st = remat_apply(layer, lp, h, lst, gen, kwargs,
                                    getattr(self.conf, "remat_policy", None))
            else:
                h, st = layer.apply(lp, h, training=training, gen=gen,
                                    state=lst, **kwargs)
            if lst is not None and st is not None:
                if cdtype is not None:
                    st = recast_like(lst, st)
                new_states[lkey] = st
            if collect:
                acts.append(_cast_float(h, torch.float32)
                            if cdtype is not None else h)
        if cdtype is not None and not collect:
            h = _cast_float(h, torch.float32)
        return (acts if collect else h), new_states, new_carries

    def _loss_fn(self, params, states, inputs, labels, fmasks, lmasks, gen,
                 carries=None):
        x, y = inputs[0], labels[0]
        mask = fmasks[0] if fmasks else None
        label_mask = lmasks[0] if lmasks else None
        last = len(self.layers) - 1
        h, new_states, new_carries = self._forward(
            params, states, x, True, gen, mask=mask, up_to=last,
            carries=carries)
        preprocs = self.conf.input_pre_processors or {}
        if last in preprocs:
            h = preprocs[last].pre_process(h, batch_size=x.shape[0])
        loss = self.layers[-1].loss(params.get(str(last), {}), h, y,
                                    mask=label_mask, training=True, gen=gen)
        loss = loss + self._regularization_penalty(params,
                                                   self._param_layers())
        return loss, new_states, (new_carries if carries is not None
                                  else None)

    # ------------------------------------------------------- argument forms
    @staticmethod
    def _xy_args(x, y):
        return (x,), (y,), None, None

    @staticmethod
    def _ds_args(ds):
        fm = getattr(ds, "features_mask", None)
        lm = getattr(ds, "labels_mask", None)
        return ((ds.features,), (ds.labels,),
                None if fm is None else (fm,), None if lm is None else (lm,))

    def _gradient_args(self, x, labels, mask=None, label_mask=None):
        return ((self._to_device(x),), (self._to_device(labels),),
                None if mask is None else (self._to_device(mask),),
                None if label_mask is None else (self._to_device(label_mask),))

    # ------------------------------------------------------------- pretrain
    def pretrain(self, data, epochs: int = 1):
        """Layerwise unsupervised pretraining of every pretrainable layer
        (ref: MultiLayerNetwork#pretrain)."""
        for i, layer in enumerate(self.layers):
            if getattr(layer, "is_pretrain_layer", lambda: False)():
                self.pretrainLayer(i, data, epochs)
        return self

    def pretrainLayer(self, layer_idx: int, data, epochs: int = 1,
                      eps=None):
        """Unsupervised pretraining of one layer (ref:
        MultiLayerNetwork#pretrainLayer): the activations of the layers
        before it (in inference) feed its ``pretrain_loss``, and only its
        params move, under a fresh updater state of the network's chain.
        ``data``: a DataSet, an array, or an iterable of either. ``eps``:
        the layer's draws, one a step in step order (else drawn from the
        network's generator)."""
        if not self._initialized:
            self.init()
        layer = self.layers[layer_idx]
        if not hasattr(layer, "pretrain_loss"):
            raise ValueError(f"layer {layer_idx} ({type(layer).__name__}) is "
                             "not pretrainable")
        from deeplearning4j_tpu_torch.optim.transforms import apply_updates
        key = str(layer_idx)
        names = list(self._params[key])
        leaves = [self._params[key][n] for n in names]
        opt_state = self._opt.init(leaves)
        draws = iter(eps) if eps is not None else None
        self._pending_score = None   # pretraining scores are synchronous
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            single = hasattr(data, "features") or hasattr(data, "shape")
            for ds in ([data] if single else data):
                x = self._to_device(ds.features if hasattr(ds, "features")
                                    else ds)
                with torch.no_grad():
                    h, _, _ = self._forward(self._params, self._states, x,
                                            False, None, up_to=layer_idx)
                for t in leaves:
                    t.requires_grad_(True)
                try:
                    loss = layer.pretrain_loss(
                        dict(zip(names, leaves)), h, gen=self._gen,
                        eps=(None if draws is None
                             else self._to_device(next(draws))))
                    grads = torch.autograd.grad(loss, leaves,
                                                allow_unused=True)
                finally:
                    for t in leaves:
                        t.requires_grad_(False)
                grads = [torch.zeros_like(t) if g is None else g
                         for t, g in zip(leaves, grads)]
                with torch.no_grad():
                    updates, opt_state = self._opt.update(grads, opt_state,
                                                          leaves)
                    leaves = apply_updates(leaves, updates)
                self._score = float(loss.detach())
                self._iteration += 1
                for lst in self._listeners:
                    lst.iteration_done(self, self._iteration, self._epoch,
                                       self._score)
        self._params = {**self._params, key: dict(zip(names, leaves))}
        return self

    # ------------------------------------------------------------- inference
    def output(self, x, train: bool = False, mask=None) -> torch.Tensor:
        """Output-layer activations in inference mode: BatchNormalization
        uses its running statistics, dropout is off (ref: #output)."""
        if not self._initialized:
            self.init()
        x, mask = self._to_device(x), self._to_device(mask)
        self._note_output_signature((x,), None if mask is None else (mask,))
        with torch.no_grad(), torch.profiler.record_function(
                "MultiLayerNetwork._output_jit"):
            h, _, _ = self._forward(self._params, self._states, x, False,
                                    None, mask=mask)
        return h

    def rnnTimeStep(self, x) -> torch.Tensor:
        """Stateful streaming inference (ref: #rnnTimeStep): the recurrent
        layers carry their state across calls. ``x`` is (N, T, C), or
        (N, C) for one step (then the output is (N, C) too)."""
        if not self._initialized:
            self.init()
        x = self._to_device(x)
        single = x.dim() == 2
        if single:
            x = x[:, None, :]
        carries = self._rnn_state
        with torch.no_grad():
            h, _, new = self._forward(self._params, self._states, x, False,
                                      None, carries=carries)
        self._rnn_state = {**carries, **new}
        return h[:, -1] if single and h.dim() == 3 else h

    def feedForward(self, x, train: bool = False) -> List[torch.Tensor]:
        """All layer activations, input first (ref: #feedForward)."""
        x = self._to_device(x)
        with torch.no_grad():
            acts, _, _ = self._forward(self._params, self._states, x, train,
                                       self._gen if train else None,
                                       collect=True)
        return [x] + acts

    # ------------------------------------------------------------ accounting
    def _forward_flops(self, batch: int, t=None) -> int:
        it = self.conf.input_type
        total = 0
        for layer in self.layers:
            total += layer_flops(layer, it, batch, t)
            it = layer.output_type(it) if it is not None else None
        return total

    # ----------------------------------------------------------- persistence
    @staticmethod
    def load(path, load_updater: bool = True,
             device=None) -> "MultiLayerNetwork":
        """Restore a zip (either package's, or a DL4J artifact) onto
        ``device`` (default: the card)."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer)
        return ModelSerializer.restore_multi_layer_network(
            path, load_updater, device=device)

    # ---------------------------------------------------------------- misc
    def summary(self) -> str:
        lines = [f"{'idx':<4}{'layer':<28}{'nParams':>10}  out"]
        it = self.conf.input_type
        for i, layer in enumerate(self.layers):
            out_t = layer.output_type(it) if it is not None else None
            it = out_t if out_t is not None else it
            lines.append(f"{i:<4}{type(layer).__name__:<28}"
                         f"{layer.n_params():>10}  "
                         f"{out_t.batch_shape() if out_t else '?'}")
        lines.append(f"Total params: {self.numParams()}")
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(self.conf.to_json()),
            device=self.device)
        net.init()
        net.set_param_tree(self._params)
        net.set_state_tree(self._states)
        return net
