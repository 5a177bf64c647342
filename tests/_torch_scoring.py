"""Shared pieces of the port's scoring-lane tests
(``test_torch_parallel_inference``, ``test_torch_scoring_lane``,
``test_torch_recovery``, ``test_torch_profile_capture``).

:data:`JAX` and :data:`TORCH` name each package's modules, so a test runs
one scenario through both and compares. The nets are small: a narrow
LeNet (two 5×5 convolutions of 4 and 8 channels on 28×28×1, a dense layer
of 16, 10 classes), a narrow residual graph (two 3×3 convolutions of 6
channels with a BatchNormalization and a skip on 12×12×3, global average
pooling, 5 classes) and the reference demo's dense net (4 → 8 → 3). Each
is built in both packages from one configuration and the port takes the
JAX net's params and states (:func:`pair`), so both compute the same
function.
"""
from __future__ import annotations

import types

import numpy as np

import deeplearning4j_tpu.async_runtime as j_async
import deeplearning4j_tpu.observability as j_obs
import deeplearning4j_tpu.observability.cost_model as j_cost
import deeplearning4j_tpu.parallel.generation as j_pgen
import deeplearning4j_tpu.parallel.inference as j_pi
import deeplearning4j_tpu.resilience.faults as j_faults
import deeplearning4j_tpu.resilience.policy as j_policy
import deeplearning4j_tpu.resilience.qos as j_qos
import deeplearning4j_tpu.serving as j_serving
import deeplearning4j_tpu.serving.frontdoor as j_frontdoor
import deeplearning4j_tpu.serving.idempotency as j_idem
import deeplearning4j_tpu.serving.registry as j_registry
import deeplearning4j_tpu.serving.rollout as j_rollout
import deeplearning4j_tpu.serving.router as j_router
from deeplearning4j_tpu.nn import graph as j_graph
from deeplearning4j_tpu.nn import graph_conf as j_gc
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.optim import updaters as j_upd

import deeplearning4j_tpu_torch.async_runtime as t_async
import deeplearning4j_tpu_torch.observability as t_obs
import deeplearning4j_tpu_torch.observability.cost_model as t_cost
import deeplearning4j_tpu_torch.parallel.generation as t_pgen
import deeplearning4j_tpu_torch.parallel.inference as t_pi
import deeplearning4j_tpu_torch.resilience.faults as t_faults
import deeplearning4j_tpu_torch.resilience.policy as t_policy
import deeplearning4j_tpu_torch.resilience.qos as t_qos
import deeplearning4j_tpu_torch.serving as t_serving
import deeplearning4j_tpu_torch.serving.frontdoor as t_frontdoor
import deeplearning4j_tpu_torch.serving.idempotency as t_idem
import deeplearning4j_tpu_torch.serving.registry as t_registry
import deeplearning4j_tpu_torch.serving.rollout as t_rollout
import deeplearning4j_tpu_torch.serving.router as t_router
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import graph_conf as t_gc
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.optim import updaters as t_upd

#: bound on every join and HTTP call in these tests
TIMEOUT_S = 60.0
#: each request's output, port against reference (f32, sums in another
#: order; PERF.md's CPU parity row)
OUT_ATOL = 1e-5

JAX = types.SimpleNamespace(
    name="jax", asyncr=j_async, obs=j_obs, cost=j_cost, pgen=j_pgen,
    pi=j_pi, faults=j_faults, policy=j_policy, qos=j_qos,
    serving=j_serving, frontdoor=j_frontdoor, idem=j_idem,
    registry=j_registry, router=j_router, rollout=j_rollout, cfg=j_cfg, L=j_layers,
    IT=j_inputs.InputType, gc=j_gc, U=j_upd, MLN=j_mln.MultiLayerNetwork,
    CG=j_graph.ComputationGraph)
TORCH = types.SimpleNamespace(
    name="torch", asyncr=t_async, obs=t_obs, cost=t_cost, pgen=t_pgen,
    pi=t_pi, faults=t_faults, policy=t_policy, qos=t_qos,
    serving=t_serving, frontdoor=t_frontdoor, idem=t_idem,
    registry=t_registry, router=t_router, rollout=t_rollout, cfg=t_cfg, L=t_layers,
    IT=t_inputs.InputType, gc=t_gc, U=t_upd, MLN=t_mln.MultiLayerNetwork,
    CG=t_graph.ComputationGraph)
BOTH = (JAX, TORCH)

#: input shape (one example) of each small net
SHAPES = {"lenet": (784,), "residual": (12, 12, 3), "demo": (4,)}


def lenet_conf(ns, seed=3):
    L = ns.L
    return (ns.cfg.NeuralNetConfiguration.builder().seed(seed)
            .updater(ns.U.Adam(1e-2)).list()
            .layer(L.ConvolutionLayer(kernel_size=(5, 5), n_out=4,
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(kernel_size=(5, 5), n_out=8,
                                      activation="relu"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.DenseLayer(n_out=16, activation="relu"))
            .layer(L.OutputLayer(n_out=10, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns.IT.convolutional_flat(28, 28, 1)).build())


def residual_conf(ns, seed=5):
    L = ns.L
    g = (ns.cfg.NeuralNetConfiguration.builder().seed(seed)
         .updater(ns.U.Adam(1e-2)).graph_builder().add_inputs("in")
         .set_input_types(ns.IT.convolutional(12, 12, 3)))
    g.add_layer("c1", L.ConvolutionLayer(kernel_size=(3, 3), n_out=6,
                                         padding=(1, 1),
                                         activation="identity"), "in")
    g.add_layer("bn", L.BatchNormalization(), "c1")
    g.add_layer("r", L.ActivationLayer(activation="relu"), "bn")
    g.add_layer("c2", L.ConvolutionLayer(kernel_size=(3, 3), n_out=6,
                                         padding=(1, 1),
                                         activation="identity"), "r")
    g.add_vertex("add", ns.gc.ElementWiseVertex("add"), "c2", "c1")
    g.add_layer("p", L.GlobalPoolingLayer(pooling_type="avg"), "add")
    g.add_layer("out", L.OutputLayer(n_out=5, activation="softmax",
                                     loss_function="mcxent"), "p")
    return g.set_outputs("out").build()


def demo_conf(ns, seed=1):
    """The reference demo's scoring net (``tools/serve.py``)."""
    L = ns.L
    return (ns.cfg.NeuralNetConfiguration.builder()
            .seed(seed).updater(ns.U.Adam(1e-2)).list()
            .layer(L.DenseLayer(n_in=4, n_out=8, activation="relu"))
            .layer(L.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .build())


_CONFS = {"lenet": lenet_conf, "residual": residual_conf, "demo": demo_conf}


def to_numpy_tree(tree):
    return {k: {p: np.asarray(v) for p, v in d.items()}
            for k, d in tree.items()}


def pair(kind, seed=None):
    """(JAX net, port net on the CPU) of ``kind``: one configuration, the
    port carrying the JAX net's params and BN states."""
    kw = {} if seed is None else {"seed": seed}
    ns_j, ns_t = JAX, TORCH
    make = _CONFS[kind]
    cls = "CG" if kind == "residual" else "MLN"
    j = getattr(ns_j, cls)(make(ns_j, **kw)).init()
    t = getattr(ns_t, cls)(make(ns_t, **kw), device="cpu").init()
    t.set_param_tree(to_numpy_tree(j._params))
    t.set_state_tree(to_numpy_tree(j._states))
    return j, t


def net_of(pkg, nets):
    return nets[0] if pkg is JAX else nets[1]


def inputs(kind, n, seed=0):
    return np.random.default_rng(seed).random(
        (n,) + SHAPES[kind]).astype(np.float32)


def direct(pkg, net, x):
    """``net.output(x)`` as f32 numpy in either package."""
    out = net.output(x)
    if pkg is TORCH:
        return out.float().numpy()
    return np.asarray(out.buf() if hasattr(out, "buf") else out)


def reset_all():
    for pkg in BOTH:
        pkg.faults.reset()
        pkg.obs.reset_global_registry()
        pkg.idem.reset_global_journal()
        pkg.qos.reset_global_tenants()


def teardown_all():
    """Stop every door, registry and serve pipeline a test left behind."""
    for pkg in BOTH:
        pkg.faults.clear()
        for fd in list(pkg.frontdoor.FrontDoor._live):
            fd.stop()
        for reg in list(pkg.registry.ModelRegistry._live):
            reg.shutdown(drain_timeout_s=TIMEOUT_S)
        pkg.pi.ParallelInference.shutdown_all()
        pkg.pgen.GenerationPipeline.shutdown_all()


def series(pkg, name):
    """{label values: value} of one counter or gauge in the package's
    process registry ({} when absent)."""
    inst = pkg.obs.global_registry().get(name)
    if inst is None:
        return {}
    return {tuple(lv): float(child.value) for lv, child in inst.series()}
