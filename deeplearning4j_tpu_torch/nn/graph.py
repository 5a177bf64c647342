"""ComputationGraph: the DAG-network runtime.

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` (the reference's
``org.deeplearning4j.nn.graph.ComputationGraph``). Several inputs and
outputs; the score is the sum of every output layer's loss. The param
API, the fit loop, the deferred score and the numerics live in
``nn/_network.py``; this class walks the DAG in topological order.

Mixed precision as ``MultiLayerNetwork``: hidden nodes compute in bf16;
output (loss-bearing) nodes, their inputs, the loss, master weights,
updater state and stored states stay f32. Activations handed to a caller
are f32. Only those are cast: the JAX package casts every activation and
lets XLA drop the unused casts, which eager PyTorch would all run.

Recurrent nodes run from carries in truncated BPTT (``nn/_network.py``'s
``_fit_tbptt``: 3-D inputs and labels chunked, masks from 2-D) and in
``rnnTimeStep`` streaming; a vertex whose class sets ``takes_mask`` gets
the first feature mask (``LastTimeStepVertex``). ``save`` / ``load`` go
through ``utils/serialization.py``.
"""
from __future__ import annotations

from typing import Dict

import torch

from deeplearning4j_tpu_torch.nn._network import (NetworkBase, as_tuple,
                                                  layer_flops, remat_apply,
                                                  run_recurrent,
                                                  with_weight_noise)
from deeplearning4j_tpu_torch.nn._precision import (_COMPUTE_DTYPES,
                                                    _cast_float, cast_params,
                                                    recast_like)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import _maybe_unflatten_input

#: layers handed the first feature mask, as the reference's list:
#: ``SelfAttentionLayer`` (so ``CrossAttentionLayer``, which refuses it) but
#: not the learned or recurrent attention layers, which the graph runs
#: unmasked (ROADMAP queue 3)
_MASK_AWARE = (L._RnnBase, L.Bidirectional, L.LastTimeStep,
               L.SelfAttentionLayer, L.GlobalPoolingLayer)


def _ds_masks(ds, which: str):
    """Masks from a DataSet (singular attrs) or MultiDataSet (plural)."""
    return as_tuple(getattr(ds, f"{which}_masks", None)
                    or getattr(ds, f"{which}_mask", None)) or None


def _f32(a):
    return _cast_float(a, torch.float32)


class ComputationGraph(NetworkBase):
    """DAG net: init → fit/output/evaluate. It lives on the card unless
    ``device="cpu"``."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        super().__init__(conf, device)

    def _param_layers(self):
        return [(name, self.conf.nodes[name].layer)
                for name in self.conf.topo_order
                if self.conf.nodes[name].layer is not None]

    def getParam(self, key: str) -> torch.Tensor:
        lname, pname = key.rsplit("_", 1)
        return self._params[lname][pname]

    # --------------------------------------------------------------- forward
    def _forward(self, params, states, inputs, training, gen, masks=None,
                 carries=None):
        """Topological walk of the DAG; returns ({name: activation},
        new_states, new_carries). Hidden activations stay in the compute
        dtype. With ``carries`` (a dict by node name: TBPTT, streaming) the
        recurrent layers start from theirs (zero where missing) and
        ``new_carries`` holds their final ones."""
        acts: Dict[str, torch.Tensor] = {}
        new_states = dict(states)
        new_carries = {}
        cdtype = _COMPUTE_DTYPES.get(getattr(self.conf, "dtype", "float32"))
        out_names = set(self.conf.network_outputs)
        in_types = (list(self.conf.input_types)
                    or [None] * len(self.conf.network_inputs))
        for name, x, it in zip(self.conf.network_inputs, inputs, in_types):
            h0 = _maybe_unflatten_input(x, it)
            acts[name] = _cast_float(h0, cdtype) if cdtype is not None else h0
        mask = masks[0] if masks else None
        remat = training and getattr(self.conf, "remat", False)
        for name in self.conf.topo_order:
            node = self.conf.nodes[name]
            srcs = [acts[s] for s in node.inputs]
            if cdtype is not None and name in out_names:
                srcs = [_f32(s) for s in srcs]
            if node.layer is None:
                if mask is not None and node.vertex.takes_mask:
                    acts[name] = node.vertex.apply(srcs, mask=mask)
                else:
                    acts[name] = node.vertex.apply(srcs)
                continue
            layer = node.layer
            lp = params.get(name, {})
            if cdtype is not None and name not in out_names:
                lp = cast_params(lp, cdtype)
            lp = with_weight_noise(layer, lp, training, gen)
            lst = states.get(name)
            kwargs = {}
            if mask is not None and isinstance(layer, _MASK_AWARE):
                kwargs["mask"] = mask
            lx = srcs if getattr(layer, "multi_input", False) else srcs[0]
            if carries is not None and isinstance(layer, L._RnnBase):
                h, new_carries[name] = run_recurrent(
                    layer, lp, lx, carries, name, training, gen, mask)
                st = lst
            elif remat and name not in out_names:
                h, st = remat_apply(layer, lp, lx, lst, gen, kwargs,
                                    getattr(self.conf, "remat_policy", None))
            else:
                h, st = layer.apply(lp, lx, training=training, gen=gen,
                                    state=lst, **kwargs)
            if lst is not None and st is not None:
                if cdtype is not None:
                    st = recast_like(lst, st)
                new_states[name] = st
            acts[name] = h
        return acts, new_states, new_carries

    def _loss_fn(self, params, states, inputs, labels, fmasks, lmasks, gen,
                 carries=None):
        acts, new_states, new_carries = self._forward(
            params, states, inputs, True, gen, masks=fmasks, carries=carries)
        total = 0.0
        for i, out_name in enumerate(self.conf.network_outputs):
            node = self.conf.nodes[out_name]
            if node.layer is None or not hasattr(node.layer, "loss"):
                raise ValueError(
                    f"Network output {out_name!r} is not a loss-bearing "
                    f"layer (OutputLayer/LossLayer); cannot train")
            # the loss takes the output layer's INPUT activation, in f32
            src = _f32(acts[node.inputs[0]])
            lm = lmasks[i] if lmasks and i < len(lmasks) else None
            total = total + node.layer.loss(params.get(out_name, {}), src,
                                            labels[i], mask=lm,
                                            training=True, gen=gen)
        total = total + self._regularization_penalty(params,
                                                     self._param_layers())
        return total, new_states, (new_carries if carries is not None
                                   else None)

    # ------------------------------------------------------- argument forms
    @staticmethod
    def _xy_args(x, y):
        return as_tuple(x), as_tuple(y), None, None

    @staticmethod
    def _ds_args(ds):
        return (as_tuple(ds.features), as_tuple(ds.labels),
                _ds_masks(ds, "features"), _ds_masks(ds, "labels"))

    def _gradient_args(self, inputs, labels, masks=None, label_masks=None):
        dev = self._to_device
        return (tuple(dev(x) for x in as_tuple(inputs)),
                tuple(dev(y) for y in as_tuple(labels)),
                None if masks is None else tuple(dev(m) for m in masks),
                None if label_masks is None
                else tuple(dev(m) for m in label_masks))

    # ------------------------------------------------------------- inference
    def output(self, *inputs, masks=None):
        """Output activations in inference mode; a single output unwrapped
        (ref: ComputationGraph#output / #outputSingle)."""
        if not self._initialized:
            self.init()
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            inputs = tuple(inputs[0])
        arrs = tuple(self._to_device(x) for x in inputs)
        masks = (None if masks is None
                 else tuple(self._to_device(m) for m in masks))
        self._note_output_signature(arrs, masks)
        with torch.no_grad(), torch.profiler.record_function(
                "ComputationGraph._output_jit"):
            acts, _, _ = self._forward(self._params, self._states, arrs,
                                       False, None, masks=masks)
        outs = tuple(_f32(acts[n]) for n in self.conf.network_outputs)
        return outs[0] if len(outs) == 1 else outs

    outputSingle = output

    def rnnTimeStep(self, *inputs):
        """Stateful streaming inference (ref: ComputationGraph#rnnTimeStep):
        the recurrent nodes carry their state across calls; inputs
        (N, T, C), or (N, C) for one step. A single output unwrapped."""
        if not self._initialized:
            self.init()
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            inputs = tuple(inputs[0])
        arrs, single = [], False
        for x in inputs:
            x = self._to_device(x)
            if x.dim() == 2:
                single = True
                x = x[:, None, :]
            arrs.append(x)
        carries = self._rnn_state
        with torch.no_grad():
            acts, _, new = self._forward(self._params, self._states,
                                         tuple(arrs), False, None,
                                         carries=carries)
        self._rnn_state = {**carries, **new}
        outs = []
        for n in self.conf.network_outputs:
            h = _f32(acts[n])
            outs.append(h[:, -1] if single and h.dim() == 3 else h)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def feedForward(self, *inputs, train: bool = False
                    ) -> Dict[str, torch.Tensor]:
        """Every vertex's activation by name, f32."""
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            inputs = tuple(inputs[0])
        arrs = tuple(self._to_device(x) for x in inputs)
        with torch.no_grad():
            acts, _, _ = self._forward(self._params, self._states, arrs,
                                       train, self._gen if train else None)
        return {k: _f32(v) for k, v in acts.items()}

    # ------------------------------------------------------------ accounting
    def _forward_flops(self, batch: int, t=None) -> int:
        types = self.conf.activation_types
        total = 0
        for name, layer in self._param_layers():
            ins = self.conf.nodes[name].inputs
            total += layer_flops(layer, types.get(ins[0]), batch, t,
                                 types.get(ins[1]) if len(ins) > 1 else None)
        return total

    # ----------------------------------------------------------- persistence
    @staticmethod
    def load(path, load_updater: bool = True,
             device=None) -> "ComputationGraph":
        """Restore a zip (either package's, or a DL4J artifact) onto
        ``device`` (default: the card)."""
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer)
        return ModelSerializer.restore_computation_graph(
            path, load_updater, device=device)

    # ---------------------------------------------------------------- misc
    def summary(self) -> str:
        lines = [f"{'name':<28}{'type':<26}{'nParams':>10}  inputs"]
        total = 0
        for name in self.conf.topo_order:
            node = self.conf.nodes[name]
            obj = node.layer if node.layer is not None else node.vertex
            n = node.layer.n_params() if node.layer is not None else 0
            total += n
            lines.append(f"{name:<28}{type(obj).__name__:<26}{n:>10}  "
                         f"{node.inputs}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)

    def clone(self) -> "ComputationGraph":
        net = ComputationGraph(
            ComputationGraphConfiguration.from_json(self.conf.to_json()),
            device=self.device)
        net.init()
        net.set_param_tree(self._params)
        net.set_state_tree(self._states)
        return net
